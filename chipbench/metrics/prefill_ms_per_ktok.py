"""Host time of the benchmark's spans around the window's admissions (each
a prefill that ends synchronised) over their thousands of prompt tokens
(host clock)."""


def read(facts):
    tokens = sum(facts.get("prefill_tokens", []))
    if not tokens:
        return None
    return sum(facts["prefill_ms"]) / (tokens / 1e3)
