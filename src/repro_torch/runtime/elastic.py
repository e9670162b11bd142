"""Elastic re-mesh planning: shrink/grow the device mesh at checkpoint
boundaries when hosts die or join.

Policy: keep the model (TP) axis intact — its size is dictated by per-chip
memory — and resize the data (and pod) axes to the largest multiple that the
surviving chip count supports.  The global batch stays constant (per-shard
batch grows), so training curves are unaffected; the synthetic data pipeline
re-shards deterministically (see data/synthetic.py) and the checkpoint
restore path re-shards parameters onto the new mesh.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RemeshPlan:
    data: int                 # new data-axis size
    model: int                # unchanged TP size
    pods: int                 # pod axis (1 = single pod)
    chips_used: int
    chips_idle: int
    reshard: bool             # params must be re-laid-out on restore

    @property
    def mesh_shape(self) -> tuple:
        return ((self.pods, self.data, self.model) if self.pods > 1
                else (self.data, self.model))

    @property
    def axis_names(self) -> tuple:
        return (("pod", "data", "model") if self.pods > 1
                else ("data", "model"))


def remesh_plan(chips_alive: int, *, model: int = 16, chips_per_pod: int = 256,
                old_data: int = 16, global_batch: int = 256) -> RemeshPlan:
    """Largest usable mesh from the surviving chips.

    Constraints: data axis must divide the global batch (so every shard gets
    whole rows) and each pod contributes whole data rows.
    """
    if chips_alive < model:
        raise ValueError(f"cannot keep model={model} with {chips_alive} chips")
    pods = max(1, chips_alive // chips_per_pod)
    per_pod = chips_alive // pods
    data = per_pod // model
    # shrink until the batch divides evenly across (pods * data)
    while data > 0 and global_batch % (pods * data) != 0:
        data -= 1
    if data == 0:
        raise ValueError("no data-axis size divides the global batch")
    used = pods * data * model
    return RemeshPlan(data=data, model=model, pods=pods,
                      chips_used=used, chips_idle=chips_alive - used,
                      reshard=(data != old_data or pods > 1))
