"""Device operations that start inside the window's decode steps (each
from its ``serve.decode`` to the end of its ``serve.next_tokens``), a
step (program spans against the device trace)."""


def read(facts):
    if not facts.get("decode_steps"):
        return None
    return facts["decode_ops"] / facts["decode_steps"]
