"""deepseek-7b — llama-architecture dense decoder (MHA: kv == heads).
[arXiv:2401.02954; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=102400,
    layer_pattern=("global",),
    subquadratic=False,
    source="arXiv:2401.02954",
)
