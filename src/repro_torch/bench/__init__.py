"""Benchmarks of the port: one module per paper figure (fig1-fig3,
fig5-fig12deg on the lockVM), the serve↔lockVM loop (fig13), the fuzz
smoke and the suite runner (``python -m repro_torch.bench.run``), each the
counterpart of the reference's script in ``benchmarks/``; and the kernel
timing scripts (``kernel_pair``, ``kernel_bounds``, ``serve_profile``)."""
