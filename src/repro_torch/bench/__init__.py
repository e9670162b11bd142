"""Benchmarks of the port, one module per paper figure (fig3 so far)."""
