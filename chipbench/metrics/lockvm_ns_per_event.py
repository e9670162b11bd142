"""The lockVM kernel's device time over the events of the chain that sets
each launch's time: the sum over launches of the longest cell's events
(device trace)."""


def read(facts):
    if not facts.get("kernel_s") or not facts.get("longest_events"):
        return None
    return facts["kernel_s"] / facts["longest_events"] * 1e9
