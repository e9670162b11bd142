"""Input-shape cells of the dry run and their applicability rules: a copy
of the reference's ``repro/configs/shapes.py``.  The launch tools
(:mod:`repro_torch.launch.dryrun`, :mod:`repro_torch.launch.roofline`)
take their batch and sequence lengths from here."""

from __future__ import annotations

from dataclasses import dataclass

from .base import ArchConfig


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """(runnable, reason-if-skipped)."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch; long_500k needs sub-quadratic attention"
    # encoders still run prefill (= encode): it is their inference step
    return True, ""


def cells_for(cfg: ArchConfig) -> list[tuple[ShapeCell, bool, str]]:
    return [(s, *applicable(cfg, s)) for s in SHAPES.values()]
