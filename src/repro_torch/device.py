"""The device rule every entry point of the port follows, and the CUDA
caching allocator's default for the launchers."""

from __future__ import annotations

import os

import torch

# The variables the caching allocator reads its settings from (torch reads
# the generic name first); a caller who set either has configured it.
ALLOC_CONF_VARS = ("PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF")
# Segments that can be unmapped and extended: with fixed segments a training
# step of gemma2-27b (2 of 46 layers, 1 × 4,160; 8.6 GB score blocks) ran
# out with 50.47 GiB allocated and 24.15 GiB reserved but free in pieces too
# small for its next 8 GiB request (PERF.md §6).
ALLOC_DEFAULT = "expandable_segments:True"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one.  With no GPU and no device given this raises — the entry points
    never carry on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def default_allocator(device: torch.device) -> str | None:
    """Give the CUDA caching allocator the launchers' default,
    ``expandable_segments:True``, unless the caller configured it through
    ``$PYTORCH_CUDA_ALLOC_CONF`` (or ``$PYTORCH_ALLOC_CONF``), whose value
    is then left as it is.  Nothing happens on a device other than CUDA.
    Returns the setting given, or None.

    The allocator parses the variable once, by CUDA's initialization
    (``resolve_device`` initializes it): a value written after that is
    ignored, so the setting goes to the allocator through its runtime
    setter, and into the variable for any process the caller starts.  Call
    it before the first CUDA allocation: it applies to the segments
    reserved from then on."""
    if device.type != "cuda" or any(v in os.environ for v in ALLOC_CONF_VARS):
        return None
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC_DEFAULT
    torch._C._accelerator_setAllocatorSettings(ALLOC_DEFAULT)
    return ALLOC_DEFAULT
