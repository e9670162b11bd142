"""Hand-written Hopper kernels of the model stack, each beside its plain
PyTorch version.

* ticket_dispatch — FIFO ticketing for MoE slot assignment (the paper's
  fetch-and-add doorway as a per-expert prefix count), CUDA C++
  (``csrc/ticket_dispatch.cu``).

A wrapper runs its plain version for tensors on the CPU and launches its
kernel, or raises, for tensors on a CUDA device.
"""
