"""Hand-written Hopper kernels of the model stack, each beside its plain
PyTorch version.

* ticket_dispatch — FIFO ticketing for MoE slot assignment (the paper's
  fetch-and-add doorway as a per-expert prefix count), CUDA C++
  (``csrc/ticket_dispatch.cu``).
* mamba_scan — the Mamba-1 selective scan of every prefill, CUDA C++
  (``csrc/mamba_scan.cu``).
* rglru — the RG-LRU diagonal gated linear recurrence of every Griffin
  prefill, CUDA C++ (``csrc/rglru_scan.cu``).

A wrapper runs its plain version for tensors on the CPU and launches its
kernel, or raises, for tensors on a CUDA device.  No kernel has a backward
pass (nor has any of the reference's), so a wrapper about to launch one
on a floating input that requires grad raises (:func:`refuse_autograd`)
rather than return outputs with no ``grad_fn``: training goes through the
plain versions (``dispatch="torch"`` or ``"ticket"``, ``scan="torch"``).
"""

from __future__ import annotations

import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise if grad mode is on and a floating tensor of ``tensors``
    requires grad: ``kernel`` has no backward pass, and its outputs would
    leave those inputs with a zero gradient and no error."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.is_floating_point() and t.requires_grad
           for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward pass, and an input "
            "requires grad: run it under torch.no_grad(), or train through "
            "the plain version (dispatch='torch' or 'ticket', "
            "scan='torch')")
