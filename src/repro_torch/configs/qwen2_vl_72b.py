"""qwen2-vl-72b — VLM backbone with M-RoPE; the vision tower is a stub
(precomputed patch embeddings + 3D positions arrive as inputs).
[arXiv:2409.12191; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    layer_pattern=("global",),
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # t/h/w per head_dim half
    frontend="vision_patches",
    subquadratic=False,
    source="arXiv:2409.12191",
)
