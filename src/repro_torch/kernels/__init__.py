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
kernel, or raises, for tensors on a CUDA device.
"""
