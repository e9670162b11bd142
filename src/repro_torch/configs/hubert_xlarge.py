"""hubert-xlarge — encoder-only audio transformer backbone; the conv
feature extractor is a stub (precomputed frame embeddings arrive as input).
Targets are masked-frame cluster ids (vocab=504).  [arXiv:2106.07447]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    layer_pattern=("global",),
    causal=False,
    has_decode=False,  # encoder-only: decode shapes skipped
    subquadratic=False,
    frontend="audio_frames",
    act="gelu",
    source="arXiv:2106.07447",
)
