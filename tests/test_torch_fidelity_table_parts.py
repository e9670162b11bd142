"""``tests/launch_fidelity_table.py``'s named parts of a cell, with no dry
run: a train or prefill cell has no KV cache, so its cache dims are an
empty set (the decode fidelity test's ``cache_parts`` reads the
``"cache"`` input only a decode shape has); a decode cell's are each KV
cache leaf's part and one layer of it.  Weight dims are every cell's."""

import dataclasses
import os
import sys

import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from launch_fidelity_table import part_dims  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402

CELLS = (("falcon-mamba-7b", "train_4k", 2, False),
         ("recurrentgemma-9b", "prefill_32k", 3, False),
         ("recurrentgemma-9b", "train_4k", 3, True),
         ("gemma3-1b", "decode_32k", 2, False))


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(map(str, c[:2]))
                                             for c in CELLS])
def test_part_dims_takes_a_cache_only_for_decode(cell):
    arch, shape, layers, multi_pod = cell
    cfg = dataclasses.replace(ARCHS[arch], n_layers=layers)
    cache, weights = part_dims(cfg, shape, multi_pod)
    assert weights
    if shape == "decode_32k":
        assert cache and all(isinstance(d, tuple) for d in cache)
    else:
        assert cache == set()
