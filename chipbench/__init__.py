"""The benchmark of the PyTorch and CUDA port (``repro_torch``): cells of
a configuration under a traffic mix, run on the card and held to a plain
reference.  See ``chipbench/README.md``."""
