"""gemma2-27b — dense, alternating local/global attention, logit softcaps.
[arXiv:2408.00118; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    subquadratic=True,  # half the layers are sliding-window
    act="gelu",
    source="arXiv:2408.00118",
)
