"""The share of the window's decode steps, each from its ``serve.decode``
to the end of its ``serve.next_tokens``, in which no operation ran on the
device (program spans against the device trace)."""


def read(facts):
    if not facts.get("decode_span_s"):
        return None
    return 100.0 * facts["decode_idle_s"] / facts["decode_span_s"]
