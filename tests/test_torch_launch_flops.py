"""The port's per-device FLOP count against the reference analyzer's.

On a 1×1 mesh, the matrix-product FLOPs of one train step of the reduced
deepseek-7b and granite-moe-1b-a400m (``reduced()``: ``remat="none"``;
batch 4 × 64, ``AdamW()``, ``TrainOptions()``), from the port's dry-run op
record (:mod:`repro_torch.launch.roofline`), must equal the reference's
``analyze_hlo_text`` of the compiled ``build_train_step`` within 1%, once
one term is taken out: the reference's one-hot label contraction
(``repro/models/model.py:368-369``, ``bsv,bsv->bs``, 2·B·S·padded_vocab),
which the port does with a gather.  No other term differs.

On a 16-way mesh, a product sharded 16 ways counts a sixteenth of its
1×1 count: the record is taken below the ``DTensor`` layer.
"""

import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.roofline import analyze_hlo_text
from repro.optim import AdamW as RefAdamW
from repro.train.train_step import TrainOptions as RefTrainOptions
from repro.train.train_step import build_train_step as ref_build_train_step
from repro.train.train_step import make_state as ref_make_state
from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import AdamW

B, S = 4, 64


def _reference_flops(arch: str) -> tuple[float, float]:
    cfg = ref_get_config(arch).reduced()
    opt = RefAdamW()
    step = ref_build_train_step(cfg, opt, RefTrainOptions())
    state = jax.eval_shape(lambda: ref_make_state(cfg, opt,
                                                  jax.random.PRNGKey(0)))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    tot = analyze_hlo_text(jax.jit(step).lower(state, batch).compile()
                           .as_text(), 1)
    onehot = sum(v for k, v in tot["flop_breakdown"].items()
                 if "bsv,bsv->bs" in k)
    assert onehot == 2 * B * S * cfg.padded_vocab
    return tot["flops"], onehot


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_train_step_flops_equal_the_reference_analyzer(arch):
    ref, onehot = _reference_flops(arch)
    with make_local_mesh(1, 1) as mesh:
        _, rows = dryrun.execute_cell(get_config(arch).reduced(),
                                      ShapeCell("t", "train", S, B), mesh,
                                      optimizer=AdamW())
    got = roofline.analyze_ops(rows, {"data": 1, "model": 1})["flops"]
    assert abs(got - (ref - onehot)) <= 0.01 * (ref - onehot), (got, ref,
                                                                 onehot)


def _mm_flops(mesh, x_entries: tuple) -> float:
    """Matrix-product FLOPs one device counts for x (4096, 1024) laid out
    by ``x_entries`` times a replicated w (1024, 512)."""
    recorder = dryrun.OpRecorder({})
    x = dryrun._dtensor(mesh, (4096, 1024), torch.float32, x_entries)
    w = dryrun._dtensor(mesh, (1024, 512), torch.float32, ())
    with dryrun.sharded_execution(mesh, recorder):
        x @ w
    return roofline.analyze_ops(recorder.record(), {})["flops"]


def test_a_product_sharded_16_ways_counts_a_sixteenth():
    with make_local_mesh(16, 1) as mesh:
        sharded = _mm_flops(mesh, ("data",))
        whole = _mm_flops(mesh, ())
    assert whole == 2 * 4096 * 1024 * 512
    assert sharded * 16 == whole
