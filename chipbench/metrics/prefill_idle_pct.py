"""The share of the window's admissions (the program's ``serve.admit``: a
prefill and its first token read back) in which no operation ran on the
device (program spans against the device trace)."""


def read(facts):
    if not facts.get("prefill_span_s"):
        return None
    return 100.0 * facts["prefill_idle_s"] / facts["prefill_span_s"]
