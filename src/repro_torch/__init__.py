"""PyTorch and CUDA port of the TWA lockVM reproduction.

``repro_torch.sim`` runs the lockVM sweep on an NVIDIA GPU through a
hand-written CUDA kernel (``csrc/lockvm.cu``), with a plain PyTorch engine
beside it that the tests hold against the JAX reference package ``repro``.
``repro_torch.core`` holds the paper's host-side locks; ``serve``,
``train`` and ``launch`` run models on them (the MoE, Mamba and RG-LRU
kernels in ``csrc/`` beside their plain versions).  This package imports
neither JAX nor anything of ``repro``.
"""
