"""Production meshes over a fake process group.

The dry run lays the state out as it would lie on a production mesh, in
one process with no accelerator: a ``DeviceMesh`` over torch's ``"fake"``
backend (``torch.testing._internal.distributed.fake_pg``), whose
collectives complete at once and move no data, with this process as rank
0 of all of them.  It is the counterpart of the reference's 512
placeholder CPU devices.

The layout it stands for: ``("data", "model")`` = (16, 16), 256 H100s in
hosts of 8 joined by NVLink, ``model`` innermost (its 16 ranks are
consecutive), so one tensor-parallel group spans two hosts and crosses
their network links; ``data`` strides over hosts.  ``multi_pod`` stacks
two such meshes on a leading ``"pod"`` axis (512 GPUs).

Each of the functions below is a context manager: it makes the process group on entry and
destroys it on exit (one group a process at a time), never at import.
"""

from __future__ import annotations

import contextlib

GPUS_PER_HOST = 8   # an H100 host (HGX/DGX H100): 8 GPUs on NVLink


@contextlib.contextmanager
def fake_mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` and axis ``names`` over a fresh fake
    process group of prod(shape) ranks, destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists in this "
                           "process; the dry run makes its own")
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 GPUs; multi_pod stacks 2 pods (512 GPUs)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1):
    """A small ("data", "model") mesh: tests, and the one-device roofline."""
    return fake_mesh((data, model), ("data", "model"))


def links_crossed(mesh_shape: dict, axes: tuple) -> str:
    """``"nvlink"`` when a group over ``axes`` stays inside one host of
    :data:`GPUS_PER_HOST` (ranks laid out row-major, the last axis
    innermost), else ``"network"``."""
    stride, span = 1, 1
    for name in reversed(list(mesh_shape)):
        if name in axes:
            span += (mesh_shape[name] - 1) * stride
        stride *= mesh_shape[name]
    return "nvlink" if span <= GPUS_PER_HOST else "network"
