"""Model FLOPs of every prefill and generated token in the window (from
the configuration's shapes, ``work``) over the window's seconds times the
card's bf16 peak (host clock)."""

from chipbench.work import mfu_pct as read  # noqa: F401
