"""Data pipeline: deterministic synthetic LM streams + prefetching loader."""

from .synthetic import SyntheticLM, mrope_positions, synthetic_batch
from .pipeline import Prefetcher

__all__ = ["SyntheticLM", "mrope_positions", "synthetic_batch", "Prefetcher"]
