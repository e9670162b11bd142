"""PyTorch and CUDA port of the TWA lockVM reproduction.

``repro_torch.sim`` runs the lockVM sweep on an NVIDIA GPU through a
hand-written CUDA kernel (``csrc/lockvm.cu``), with a plain PyTorch engine
beside it that the tests hold against the JAX reference package ``repro``.
This package imports neither JAX nor anything of ``repro``.
"""
