"""The narrow granite train cell of ``test_torch_launch_fidelity.py`` on
the two-pod 2×16×16 mesh (``pod``, ``data``, ``model``: the batch over
``pod`` and ``data``), held to the reference's dry run with the same
bands, cut to one layer on both sides and in a file of its own so that
each file stays well inside its time.  With one layer the reference scans
no stack of layers, and its temp holds no more of the chunked attention
than the port keeps: no term is named."""

import dataclasses

import pytest

pytest.importorskip("torch")

from test_torch_launch_fidelity import check, narrow, port, reference

from repro_torch.configs import get_config


def test_granite_train_on_two_pods(tmp_path):
    arch, shape = "granite-moe-1b-a400m", "train_4k"
    ov = {**narrow(arch), "n_layers": 1}
    cfg = dataclasses.replace(get_config(arch), **ov)
    ref = reference({"c": (arch, shape, ov, True)}, tmp_path / "ref")["c"]
    got = port(arch, shape, ov, True, tmp_path / "port")
    assert got["memory"]["argument_size_in_bytes"] == ref["memory"][
        "argument_size_in_bytes"]
    check(got, ref, cfg)
