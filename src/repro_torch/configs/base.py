"""Architecture config schema + reduced-config derivation for smoke tests."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads

    # attention pattern: one period of layer kinds, tiled over n_layers
    # kinds: "global" | "local" | "mamba" | "rglru"
    layer_pattern: tuple = ("global",)
    window: int = 4096          # sliding window for "local" layers
    attn_softcap: float = 0.0   # gemma2 attention-logit softcap (0 = off)
    logit_softcap: float = 0.0  # gemma2 final-logit softcap (0 = off)
    rope_theta: float = 10000.0
    mrope_sections: tuple = ()  # qwen2-vl M-RoPE head_dim sections (t, h, w)
    causal: bool = True         # False => bidirectional encoder (hubert)
    has_decode: bool = True     # False for encoder-only archs
    subquadratic: bool = False  # eligible for long_500k
    act: str = "silu"           # mlp activation (gated)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0            # 0 => ceil(d_model / 16)

    # hybrid (RG-LRU)
    lru_width: int = 0          # 0 => d_model
    conv_width: int = 4

    # modality stubs
    frontend: str = "none"      # none | audio_frames | vision_patches

    # numerics / runtime
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"         # none | dots | full
    scan_layers: bool = True

    # citation string for provenance
    source: str = ""

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "ssm" and not self.dt_rank:
            object.__setattr__(self, "dt_rank", max(1, math.ceil(self.d_model / 16)))
        if self.family == "hybrid" and not self.lru_width:
            object.__setattr__(self, "lru_width", self.d_model)

    # ---- derived ---------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows, padded to a multiple of 256 so the vocab dim
        shards over any mesh axis (49155 → 49408 etc.).  Pad logits are
        masked to -1e30; pad rows cost <0.6% extra memory worst-case."""
        return (self.vocab + 255) // 256 * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def tail_kinds(self) -> tuple:
        """Remainder layers after the scanned full periods."""
        return self.layer_pattern[: self.n_layers % self.period]

    def layer_kinds(self) -> list[str]:
        return [self.layer_pattern[i % self.period] for i in range(self.n_layers)]

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for kind in self.layer_kinds():
            if kind in ("global", "local"):
                attn = d * H * hd + 2 * d * KV * hd + H * hd * d
                if self.n_experts:
                    mlp = d * self.n_experts + self.n_experts * 3 * d * ff
                else:
                    mlp = 3 * d * ff
                total += attn + mlp + 2 * d
            elif kind == "mamba":
                di, N, dtr = self.d_inner, self.ssm_state, self.dt_rank
                total += (d * 2 * di + di * self.ssm_conv + di * N
                          + di * (dtr + 2 * N) + dtr * di + di + di * d + d)
            elif kind == "rglru":
                w = self.lru_width
                total += (2 * d * w + w * self.conv_width + 2 * w * w + w
                          + w * d + 3 * d * ff + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_experts = self.n_experts * 3 * d * ff
        active_experts = self.top_k * 3 * d * ff
        n_moe_layers = sum(1 for k in self.layer_kinds() if k in ("global", "local"))
        return self.param_count() - n_moe_layers * (dense_experts - active_experts)

    # ---- smoke-test reduction ---------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config: full period pattern, small dims."""
        n_layers = min(self.n_layers, max(self.period + 1, 2))
        changes = dict(
            n_layers=n_layers,
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            window=32,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            dt_rank=4 if self.family == "ssm" else 0,
            lru_width=64 if self.family == "hybrid" else 0,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
            dtype="float32",
            remat="none",
        )
        return dataclasses.replace(self, **changes)
