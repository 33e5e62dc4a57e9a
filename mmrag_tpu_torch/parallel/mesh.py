"""Device mesh + placement helpers.

Port of ``mmrag_tpu/parallel/mesh.py`` (its serving half). A :class:`Mesh`
is an ordered list of ``torch.device`` s along one ``data`` axis (batch
data parallelism for the encoders, corpus-row sharding for the vector
index); the JAX mesh's ``model`` axis serves only training and waits for it.
One device may appear more than once: that is the port's
counterpart of XLA's virtual host devices, so an 8-shard mesh runs on the
CPU and a 4-shard mesh on one card. On one device the shards' launches run
one after another on its stream; on distinct CUDA devices they are queued
on each device's stream with no host synchronisation between them.

The placement helpers return per-shard tensors: :func:`replicated` one copy
per distinct device, :func:`row_sharded` (and :func:`batch_sharded`) the
contiguous row blocks of dim 0, block ``s`` on ``mesh.devices[s]``.
:class:`ShardedRows` is a growable row-sharded column (the vector index's
slab and predicate columns in sharded mode).

Not ported yet: ``initialize_multihost``, ``param_sharding_rules`` and
``shard_params`` (the training path's tensor parallelism).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"


class Mesh:
    """An ordered list of devices along the ``data`` axis, one per shard
    (a device may repeat)."""

    def __init__(self, devices: Sequence[torch.device]) -> None:
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape: Dict[str, int] = {DATA_AXIS: len(self.devices)}

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The data axis's devices without repeats, in first-seen order."""

        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """Data-axis mesh over the first ``n_devices`` of ``devices`` (default:
    every CUDA device). A device listed twice gives two shards on it."""

    devices = [torch.device(d) for d in (devices if devices is not None else _cuda_devices())]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("no devices for the mesh (CUDA is not available?)")
    return Mesh(devices)


_engine_meshes: Dict[int, Mesh] = {}
_engine_mesh_lock = threading.Lock()


def engine_data_mesh(cfg=None) -> Optional[Mesh]:
    """The mesh the engine runs on, or ``None`` for one device.

    Reads ``cfg.tpu.data_parallel`` (``TPU_DATA_PARALLEL``): ``auto`` uses
    every distinct CUDA device when there are several, ``off`` forces the
    single-device paths, an integer the first N devices. Below 2 devices it
    is ``None``, so one card runs single-device, as the JAX engine does on
    one chip. The mesh is data-axis-only and cached per device count, so
    every runtime and index of the process shares one mesh object."""

    setting = "auto" if cfg is None else cfg.tpu.data_parallel
    if setting == "off":
        return None
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = avail if setting == "auto" else min(int(setting), avail)
    if n < 2:
        return None
    with _engine_mesh_lock:
        mesh = _engine_meshes.get(n)
        if mesh is None:
            mesh = build_mesh(n_devices=n)
            _engine_meshes[n] = mesh
        return mesh


def on_device(device: torch.device):
    """Make ``device`` the current CUDA device for the launches inside (the
    kernels launch on the current device's context); a no-op on the CPU."""

    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _tree_to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class Replicated(dict):
    """``{device: tree}``: one copy of a tensor tree per distinct device of a
    mesh (a tree already on a device is that device's copy, not a copy)."""


def replicated(mesh: Mesh, tree: Any) -> Replicated:
    return Replicated({dev: _tree_to(tree, dev) for dev in mesh.distinct})


def row_sharded(mesh: Mesh, arr) -> List[torch.Tensor]:
    """Dim 0 of ``arr`` (a tensor or numpy array) in ``n_data`` equal
    contiguous blocks, block ``s`` on ``mesh.devices[s]``. Rows that do not
    divide evenly raise."""

    n = mesh.n_data
    if arr.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(arr.shape)} not divisible by data axis {n}")
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    rows = t.shape[0] // n
    return [t[s * rows:(s + 1) * rows].to(dev) for s, dev in enumerate(mesh.devices)]


batch_sharded = row_sharded


class ShardedRows:
    """A ``(capacity, *trailing)`` column held as ``n_data`` row blocks, block
    ``s`` (rows ``[s * R, (s + 1) * R)``) on ``mesh.devices[s]``.

    Reads of a row range gather it onto the mesh's first device; writes of
    a row range (or of a scalar at row ids) go to the blocks that hold the
    rows. The search paths read :attr:`shards` directly."""

    def __init__(self, mesh: Mesh, shards: List[torch.Tensor]) -> None:
        self.mesh = mesh
        self.shards = shards
        self.shard_rows = int(shards[0].shape[0])

    @classmethod
    def full(cls, mesh: Mesh, shape: Tuple[int, ...], fill, dtype) -> "ShardedRows":
        if shape[0] % mesh.n_data:
            raise ValueError(f"capacity {shape[0]} not divisible by data axis {mesh.n_data}")
        rows = shape[0] // mesh.n_data
        return cls(mesh, [torch.full((rows, *shape[1:]), fill, dtype=dtype, device=dev)
                          for dev in mesh.devices])

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.shard_rows * len(self.shards), *self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def _pieces(self, key: slice):
        start, stop, step = key.indices(self.shape[0])
        if step != 1:
            raise ValueError("ShardedRows takes contiguous row ranges")
        r = self.shard_rows
        for s in range(start // r, -(-stop // r) if stop > start else 0):
            lo, hi = max(start, s * r), min(stop, (s + 1) * r)
            if hi > lo:
                yield s, lo - s * r, hi - s * r, lo - start

    def __getitem__(self, key: slice) -> torch.Tensor:
        if not isinstance(key, slice):
            raise TypeError("ShardedRows reads contiguous row ranges")
        parts = [self.shards[s][a:b].to(self.device) for s, a, b, _ in self._pieces(key)]
        if not parts:
            return torch.empty((0, *self.shape[1:]), dtype=self.dtype, device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def __setitem__(self, key, value) -> None:
        if isinstance(key, slice):
            for s, a, b, off in self._pieces(key):
                shard = self.shards[s]
                if isinstance(value, torch.Tensor):
                    shard[a:b] = value[off:off + (b - a)].to(shard.device)
                else:
                    shard[a:b] = value
            return
        # row ids (a tensor or array) and a scalar: each block its own rows
        rows = torch.as_tensor(key).long().cpu()
        if isinstance(value, torch.Tensor) and value.ndim:
            raise TypeError("ShardedRows writes a scalar at row ids")
        which = rows // self.shard_rows
        for s in torch.unique(which).tolist():
            shard = self.shards[s]
            shard[(rows[which == s] - s * self.shard_rows).to(shard.device)] = value
