"""Shape-and-dtype stand-ins (``meta`` tensors) for every (arch × shape)
cell's inputs: the dry run's allocation-free inputs (the reference's
``repro/launch/specs.py``)."""

from __future__ import annotations

import torch

from ..configs import ArchConfig, ShapeCell


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    B, S = cell.global_batch, cell.seq_len
    batch = {
        "tokens": sds((B, S), torch.int32),
        "labels": sds((B, S), torch.int32),
    }
    if cfg.frontend == "audio_frames":
        batch["frames"] = sds((B, S, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "vision_patches":
        batch["vision_mask"] = sds((B, S), torch.bool)
        batch["vision_embeds"] = sds((B, S, cfg.d_model), torch.bfloat16)
        batch["positions"] = sds((3, B, S), torch.int32)
    return batch


def prefill_input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    batch = train_input_specs(cfg, cell)
    batch.pop("labels")
    if cfg.frontend == "audio_frames":
        batch.pop("tokens")
    return batch


def decode_input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """tokens + cache + position for one-token decode at context seq_len."""
    from ..models.model import init_cache, torch_dtype
    B, S = cell.global_batch, cell.seq_len
    return {
        "tokens": sds((B, 1), torch.int32),
        "pos": sds((), torch.int32),
        "cache": init_cache(cfg, B, S, torch_dtype(cfg), device="meta"),
    }


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    if cell.kind == "train":
        return train_input_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_input_specs(cfg, cell)
    if cell.kind == "decode":
        return decode_input_specs(cfg, cell)
    raise ValueError(cell.kind)
