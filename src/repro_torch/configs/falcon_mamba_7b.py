"""falcon-mamba-7b — attention-free Mamba-1 SSM (d_ff=0, pure mixer stack).
[arXiv:2410.05355; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    layer_pattern=("mamba",),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    subquadratic=True,
    source="arXiv:2410.05355",
)
