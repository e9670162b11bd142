"""Every lockVM event of every sweep completed in the window, over the
window's seconds (host clock)."""


def read(facts):
    if "events" not in facts:
        return None
    return facts["events"] / facts["window_s"]
