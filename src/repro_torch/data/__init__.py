"""Data pipeline: deterministic synthetic LM streams + prefetching loader."""

from .synthetic import SyntheticLM, synthetic_batch
from .pipeline import Prefetcher

__all__ = ["SyntheticLM", "synthetic_batch", "Prefetcher"]
