"""Prompt tokens prefilled plus tokens generated in the window, over the
window's seconds (host clock)."""


def read(facts):
    if "generated_tokens" not in facts:
        return None
    return (facts["prompt_tokens"] + facts["generated_tokens"]) \
        / facts["window_s"]
