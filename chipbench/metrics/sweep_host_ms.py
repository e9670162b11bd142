"""The sweep front end's host time a pass: the wall time of the window's
``run_sweeps`` calls less the lockVM kernel's device time, over the
passes (device trace)."""


def read(facts):
    if "kernel_s" not in facts or not facts["passes"]:
        return None
    return (facts["sweep_wall_s"] - facts["kernel_s"]) / facts["passes"] * 1e3
