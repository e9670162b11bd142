"""mistral-large-123b — dense full-attention GQA decoder.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=32768,
    layer_pattern=("global",),
    rope_theta=1_000_000.0,
    subquadratic=False,  # pure full attention -> long_500k skipped
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
