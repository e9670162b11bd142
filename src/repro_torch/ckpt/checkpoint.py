"""Sharded checkpointing with TWA-arbitrated writer slots.

Layout per step (the reference's ``repro/ckpt/checkpoint.py``, kept
exactly, so that a checkpoint saved by either package restores in the
other)::

    <root>/step_<N>/
        manifest.json          # keys, shapes, dtypes, step, world
        shard_<host>.npz       # this host's leaves
        COMMIT                 # written last: restore ignores uncommitted dirs

Leaves are keyed by their path in the tree, as the reference names them
(:func:`repro_torch.tree.flatten_with_path`: ``.params\\x1dembed``,
``.opt\\x1d.step``, ...).  Writes are atomic (tmp dir + rename + COMMIT
marker), so a crash mid-save never corrupts the latest checkpoint.  On a
cluster, hosts serialize their writes through a :class:`WriterGate` — a
distributed TWA ticket gate over the coordination store that bounds
concurrent writers while keeping strict FIFO fairness.

A bfloat16 leaf has no numpy dtype here (the reference writes it with
ml_dtypes): it is written as the reference's file holds it, its 2-byte
words under the ``.npy`` descr ``<V2`` and ``"bfloat16"`` in the
manifest's ``dtypes``, and read back from those raw words (``np.load``
gives them as ``|V2``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch

from ..core import DistributedTWALock, FileKVStore
from ..tree import flatten_with_path, tree_map, tree_map_with_path

BF16_DESCR = "<V2"     # the .npy descr of an ml_dtypes bfloat16 array
_WRITE_CHUNK = 1 << 26  # bytes a write call


class _Leaf:
    """A leaf on the host: its bytes as a numpy array and its dtype's name
    as the manifest records it."""

    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: str) -> None:
        self.array, self.dtype = array, dtype

    @property
    def shape(self) -> tuple:
        return self.array.shape


def _host_leaf(x) -> _Leaf:
    """A tensor, array or scalar as a :class:`_Leaf` (a bfloat16 tensor as
    its int16 words)."""
    if isinstance(x, _Leaf):
        return x
    if isinstance(x, torch.Tensor):
        # a copy even of a CPU tensor: the snapshot must not follow later
        # in-place writes
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _Leaf(t.view(torch.int16).numpy(), "bfloat16")
        return _Leaf(t.numpy(), str(t.dtype).removeprefix("torch."))
    a = np.asarray(x)
    return _Leaf(a, str(a.dtype))


def _contiguous(a: np.ndarray) -> np.ndarray:
    """``a`` in C order, keeping its shape (``np.ascontiguousarray`` makes a
    0-d array 1-d)."""
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


def _write_npz(path: str, leaves: dict) -> int:
    """``np.savez``'s layout (one stored ``<key>.npy`` member a leaf, zip64)
    with bfloat16 leaves under the descr ``<V2``; returns the file's
    bytes."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in leaves.items():
            a = _contiguous(leaf.array)
            header = np.lib.format.header_data_from_array_1_0(a)
            if leaf.dtype == "bfloat16":
                header["descr"] = BF16_DESCR
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, header)
                raw = a.reshape(-1).view(np.uint8)
                for i in range(0, raw.size, _WRITE_CHUNK):
                    f.write(raw[i:i + _WRITE_CHUNK].data)
    return os.path.getsize(path)


def save(tree, root: str, step: int, *, host: int = 0, world: int = 1,
         keep: int = 3) -> str:
    """Write one host's shard + (host 0) the manifest; returns the ckpt dir."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + f".tmp{host}"
    os.makedirs(tmp if host == 0 else final, exist_ok=True)
    wdir = tmp if host == 0 else final
    leaves = {k: _host_leaf(v) for k, v in flatten_with_path(tree).items()}
    _write_npz(os.path.join(wdir, f"shard_{host}.npz"), leaves)
    if host == 0:
        manifest = {
            "step": step,
            "world": world,
            "keys": sorted(leaves),
            "shapes": {k: list(a.shape) for k, a in leaves.items()},
            "dtypes": {k: a.dtype for k, a in leaves.items()},
        }
        with open(os.path.join(wdir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            for name in os.listdir(final):
                os.replace(os.path.join(final, name), os.path.join(tmp, name))
            os.rmdir(final)
        os.replace(tmp, final)
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write("ok")
        _gc(root, keep)
    return final


def _gc(root: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(root)
                   if d.startswith("step_") and ".tmp" not in d)
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def latest_step(root: str) -> int | None:
    """Newest committed checkpoint step, or None."""
    if not os.path.isdir(root):
        return None
    best = None
    for d in os.listdir(root):
        if d.startswith("step_") and ".tmp" not in d:
            if os.path.exists(os.path.join(root, d, "COMMIT")):
                s = int(d.split("_")[1])
                best = s if best is None or s > best else best
    return best


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a tensor of its manifest dtype (bfloat16 from its
    raw 2-byte words)."""
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf holds {arr.dtype} words")
        words = _contiguous(arr).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(_contiguous(arr))


def restore(root: str, step: int | None = None, *, like=None):
    """Load a checkpoint into the structure of `like` (a tree of tensors):
    each leaf comes back as a new tensor of its `like` leaf's dtype, on
    its device.  Returns (tree, step)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    cdir = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(cdir, "manifest.json")) as f:
        manifest = json.load(f)
    data = {}
    for fname in sorted(os.listdir(cdir)):
        if fname.startswith("shard_") and fname.endswith(".npz"):
            with np.load(os.path.join(cdir, fname)) as z:
                for k in z.files:
                    data[k] = z[k]
    missing = set(manifest["keys"]) - set(data)
    if missing:
        raise IOError(f"checkpoint step {step} missing leaves: {missing}")
    assert like is not None, "restore() needs `like` for the tree structure"

    def load(key, want):
        arr = data[key]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: ckpt shape {arr.shape} != "
                             f"{tuple(want.shape)}")
        t = _as_tensor(arr, manifest["dtypes"].get(key, str(arr.dtype)))
        return t.to(device=want.device, dtype=want.dtype)

    return tree_map_with_path(load, like), step


class WriterGate:
    """Bounds concurrent checkpoint writers across hosts (FIFO, TWA waiting).

    ``slots`` writers proceed at once; the rest park on hashed notification
    keys instead of hammering the grant key — the coordination-service
    analogue of bounding the invalidation diameter during handover.
    """

    def __init__(self, store_root: str, *, slots: int = 4,
                 name: str = "ckpt-writers") -> None:
        self.store = FileKVStore(store_root)
        self.slots = slots
        self._locks = [DistributedTWALock(self.store, f"{name}/slot{i}")
                       for i in range(slots)]
        self._held: dict[int, int] = {}
        self._mutex = threading.Lock()

    def acquire(self, host: int) -> int:
        slot = host % self.slots          # static stripe; FIFO within stripe
        self._locks[slot].acquire()
        with self._mutex:
            self._held[host] = slot
        return slot

    def release(self, host: int) -> None:
        with self._mutex:
            slot = self._held.pop(host)
        self._locks[slot].release()


class AsyncCheckpointer:
    """Fire-and-forget save on a background thread (one in flight; the next
    save waits — checkpoint cadence should outpace write time or you have a
    storage problem, not a framework problem).

    ``history`` records each finished save: its step, the seconds of the
    device-to-host snapshot (on the caller's thread) and of the write (on
    the writer's), and the bytes of the step's directory."""

    def __init__(self, root: str, *, keep: int = 3) -> None:
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None
        self.history: list[dict] = []

    def save(self, tree, step: int, *, host: int = 0, world: int = 1) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_tree = tree_map(_host_leaf, tree)      # snapshot before async
        snap_s = time.perf_counter() - t0

        def _do():
            try:
                t1 = time.perf_counter()
                path = save(host_tree, self.root, step, host=host,
                            world=world, keep=self.keep)
                self.history.append({
                    "step": step, "snapshot_seconds": snap_s,
                    "write_seconds": time.perf_counter() - t1,
                    "bytes": sum(os.path.getsize(os.path.join(path, n))
                                 for n in os.listdir(path))})
            except Exception as e:                  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_do, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

