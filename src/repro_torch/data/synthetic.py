"""Deterministic synthetic LM data.

Tokens are a stateless hash of (seed, shard, step, position) — any host can
regenerate any batch, which is what makes checkpoint-restart and elastic
re-sharding trivially consistent: a resumed run at step N sees exactly the
batch it would have seen, for any world size, because sharding is by
global position, not by host-local iterator state.
"""

from __future__ import annotations

import numpy as np

from ..configs.base import ArchConfig


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


def synthetic_batch(cfg: ArchConfig, *, step: int, batch: int, seq: int,
                    seed: int = 0, shard: int = 0, num_shards: int = 1) -> dict:
    """One global-batch shard: tokens/labels (B_shard, S), int32.

    The global batch is row-partitioned across shards; rows are addressed by
    global row id so the data is identical for any (shard, num_shards)
    factorization — the elastic-rescale property.
    """
    assert batch % num_shards == 0
    rows = batch // num_shards
    gid = (np.arange(rows, dtype=np.uint64) + np.uint64(shard * rows)
           + np.uint64(step) * np.uint64(batch))
    pos = np.arange(seq + 1, dtype=np.uint64)
    base = _splitmix64(gid[:, None] * np.uint64(0x100000001B3)
                       + pos[None, :] + np.uint64(seed) * np.uint64(0xD6E8FEB8))
    toks = (base % np.uint64(cfg.vocab)).astype(np.int32)
    out = {"tokens": toks[:, :seq], "labels": toks[:, 1:]}
    if cfg.frontend == "audio_frames":
        f = _splitmix64(base[:, :seq] + np.uint64(7))
        out["frames"] = ((f % np.uint64(2048)).astype(np.float32) / 1024.0
                         - 1.0)[..., None] * np.ones((cfg.d_model,), np.float32)
        out["frames"] = out["frames"].astype(np.float32)
    if cfg.frontend == "vision_patches":
        # stub frontend: first quarter of the sequence is "image patches"
        n_vis = seq // 4
        mask = np.zeros((rows, seq), bool)
        mask[:, :n_vis] = True
        emb = _splitmix64(base[:, :seq] + np.uint64(13))
        out["vision_mask"] = mask
        out["vision_embeds"] = ((emb % np.uint64(2048)).astype(np.float32)
                                / 1024.0 - 1.0)[..., None] * np.ones(
                                    (cfg.d_model,), np.float32)
        t = np.broadcast_to(np.arange(seq, dtype=np.int32), (rows, seq))
        out["positions"] = np.stack([t, t, t])  # (3, B, S) M-RoPE streams
    return out


def mrope_positions(seed: int, batch: int, seq: int, n_vis: int) -> np.ndarray:
    """Three distinct M-RoPE position streams (3, B, S), int32, as Qwen2-VL
    lays out one image ahead of the text: over the first ``n_vis``
    positions the temporal stream is constant and height and width walk an
    h × w grid of patches (h·w = n_vis, h the largest divisor up to
    sqrt(n_vis)); the text after continues all three streams together from
    one past the largest.  Each row starts at an offset drawn from
    ``seed``.  (:func:`synthetic_batch` gives three equal streams, as the
    reference's does, with which M-RoPE is plain RoPE.)"""
    h = max(d for d in range(1, int(np.sqrt(n_vis)) + 1) if n_vis % d == 0)
    w = n_vis // h
    rng = np.random.default_rng(seed)
    out = np.empty((3, batch, seq), np.int32)
    for b in range(batch):
        s0 = int(rng.integers(0, 8))
        out[0, b, :n_vis] = s0
        out[1, b, :n_vis] = s0 + np.repeat(np.arange(h), w)
        out[2, b, :n_vis] = s0 + np.tile(np.arange(w), h)
        nxt = int(out[:, b, :n_vis].max()) + 1 if n_vis else s0
        out[:, b, n_vis:] = nxt + np.arange(seq - n_vis)
    return out


class SyntheticLM:
    """Stateless batch source bound to (cfg, batch, seq, seed, shard)."""

    def __init__(self, cfg: ArchConfig, *, batch: int, seq: int, seed: int = 0,
                 shard: int = 0, num_shards: int = 1) -> None:
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.shard, self.num_shards = seed, shard, num_shards

    def batch_at(self, step: int) -> dict:
        return synthetic_batch(self.cfg, step=step, batch=self.batch,
                               seq=self.seq, seed=self.seed, shard=self.shard,
                               num_shards=self.num_shards)
