"""The selective-scan kernel's share of its roofline: its least time for
the window's prefills (``work.scan_bound_s``, one launch a layer) over the
device time of the scan launches inside them (device trace)."""


def read(facts):
    if not facts.get("scan_kernel_s"):
        return None
    return facts["scan_bound_s"] / facts["scan_kernel_s"] * 100.0
