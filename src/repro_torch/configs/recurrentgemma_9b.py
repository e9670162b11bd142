"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 2:1.
[arXiv:2402.19427; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
    subquadratic=True,  # recurrences + sliding-window only
    act="gelu",
    source="arXiv:2402.19427",
)
