"""gemma3-1b — dense, 5:1 local:global interleaved attention, 262k vocab.
[hf:google/gemma-3-1b-pt; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=512,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=True,  # 5:1 local-dominant -> long_500k eligible
    act="gelu",
    source="hf:google/gemma-3-1b-pt",
)
