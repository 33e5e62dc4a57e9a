"""Device mesh, placement helpers and the tensor-parallel parameter rules.

Port of ``mmrag_tpu/parallel/mesh.py``. A :class:`Mesh` is a (data, model)
grid of ``torch.device`` s: ``data`` splits the batch (and, for serving, the
vector index's corpus rows), ``model`` splits the encoder weights
Megatron-style for fine-tuning (:mod:`mmrag_tpu_torch.parallel.training`).
One device may appear more than once: that is the port's counterpart of
XLA's virtual host devices, so an 8-shard mesh runs on the CPU and a (2, 2)
mesh on one card. On one device the shards' launches run one after another
on its stream; on distinct CUDA devices they are queued on each device's
stream with no host synchronisation between them.

The serving paths take a data-only mesh (``model_parallel=1``, what
:func:`engine_data_mesh` builds): they read :attr:`Mesh.devices`, which
raises on a mesh with a model axis above 1.

The placement helpers return per-shard tensors: :func:`replicated` one copy
per distinct device, :func:`row_sharded` (and :func:`batch_sharded`) the
contiguous row blocks of dim 0, block ``s`` on ``mesh.devices[s]``.
:class:`ShardedRows` is a growable row-sharded column (the vector index's
slab and predicate columns in sharded mode). :func:`param_sharding_rules`
and :func:`shard_params` lay a parameter tree out over the model axis as
:class:`Sharded` leaves; :func:`initialize_multihost` joins a
``torch.distributed`` process group.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """Join a multi-process group (``mmrag_tpu/parallel/mesh.py:30-69``).

    Reads ``MMRAG_COORDINATOR`` (``host:port``), ``MMRAG_NUM_PROCESSES`` and
    ``MMRAG_PROCESS_ID`` when the arguments are omitted; without a
    coordinator it does nothing and returns False. Otherwise it calls
    ``torch.distributed.init_process_group`` over ``tcp://<coordinator>``,
    with ``nccl`` on the card (``device``, default ``cuda``) or ``gloo``
    when ``device="cpu"``, and returns True. Both counts are required: JAX
    may leave them to the TPU runtime's detection, torch has none, so one
    or both missing raises ``ValueError``."""

    coordinator_address = coordinator_address or os.environ.get("MMRAG_COORDINATOR")
    if not coordinator_address:
        return False
    env_np = os.environ.get("MMRAG_NUM_PROCESSES")
    env_pid = os.environ.get("MMRAG_PROCESS_ID")
    if num_processes is None and env_np:
        num_processes = int(env_np)
    if process_id is None and env_pid:
        process_id = int(env_pid)
    if num_processes is None or process_id is None:
        raise ValueError("MMRAG_NUM_PROCESSES and MMRAG_PROCESS_ID must both be set "
                         "(torch.distributed has no auto-detection)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


class Mesh:
    """A (data, model) grid of devices: ``grid[i][j]`` is data shard ``i``'s
    model shard ``j`` (a device may repeat)."""

    def __init__(self, devices: Sequence[torch.device], model_parallel: int = 1) -> None:
        flat = tuple(torch.device(d) for d in devices)
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if model_parallel < 1 or len(flat) % model_parallel:
            raise ValueError(
                f"{len(flat)} devices not divisible by model_parallel={model_parallel}")
        m = model_parallel
        self.grid: Tuple[Tuple[torch.device, ...], ...] = tuple(
            flat[i:i + m] for i in range(0, len(flat), m))
        self.shape: Dict[str, int] = {DATA_AXIS: len(self.grid), MODEL_AXIS: m}

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The data axis's devices, one per shard: what the serving paths
        read. A mesh with a model axis above 1 is the training path's and
        raises here."""

        if self.n_model != 1:
            raise ValueError(f"the serving paths take a data-only mesh, not {self.shape}")
        return tuple(row[0] for row in self.grid)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in first-seen order."""

        return tuple(dict.fromkeys(d for row in self.grid for d in row))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[[str(d) for d in row] for row in self.grid]})"


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
               devices=None) -> Mesh:
    """(data, model) mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device), ``model_parallel`` devices a data row; a
    count that does not divide raises. A device listed twice gives two
    shards on it."""

    devices = [torch.device(d) for d in (devices if devices is not None else _cuda_devices())]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("no devices for the mesh (CUDA is not available?)")
    return Mesh(devices, model_parallel)


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


# ---------------------------------------------------------------------------
# Tensor-parallel parameter layout
# ---------------------------------------------------------------------------

_UP = {"ffn_in", "fc1", "qkv", "q", "k", "v"}  # the port's fused qkv, JAX's q/k/v
_DOWN = {"ffn_out", "fc2", "attn_out"}
_VOCAB = {"word", "token_embedding"}


def param_sharding_rules(path: Tuple[str, ...], mesh: Mesh) -> Tuple:
    """The model-axis layout of the leaf at ``path``, as JAX decides it
    (``mmrag_tpu/parallel/mesh.py:137-156``), as a partition spec:
    up-projections split their output columns ``(None, "model")`` and their
    biases ``("model",)``; down-projection kernels split their input rows
    ``("model", None)``; the vocabulary tables split their rows; everything
    else is replicated, ``()``. ``mesh`` is taken for the JAX signature: the
    spec does not depend on it."""

    del mesh
    names = set(path)
    if _UP & names and path[-1] == "kernel":
        return (None, MODEL_AXIS)
    if _UP & names and path[-1] == "bias":
        return (MODEL_AXIS,)
    if _DOWN & names and path[-1] == "kernel":
        return (MODEL_AXIS, None)
    if _VOCAB & names:
        return (MODEL_AXIS, None)
    return ()


class Sharded:
    """A leaf split over the model axis: ``shards[j]`` is model shard ``j``'s
    piece along ``dim``. ``blocks`` > 1 (the fused ``qkv``, 3) splits each
    of the leaf's equal blocks along ``dim`` and shard ``j`` holds the
    ``j``-th piece of every block, so a shard of q|k|v holds the same whole
    heads of q, k and v."""

    def __init__(self, shards: List[torch.Tensor], dim: int, blocks: int = 1) -> None:
        self.shards = shards
        self.dim = dim
        self.blocks = blocks

    def to_devices(self, devices: Sequence[torch.device]) -> "Sharded":
        return Sharded([t.to(d) for t, d in zip(self.shards, devices)], self.dim, self.blocks)

    def full(self) -> torch.Tensor:
        """The whole leaf on shard 0's device."""

        dev = self.shards[0].device
        pieces = [t.to(dev).chunk(self.blocks, self.dim) for t in self.shards]
        return torch.cat([p[b] for b in range(self.blocks) for p in pieces], self.dim)


def map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                  path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists (list indices as
    strings, as JAX's key paths print them)."""

    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def shard_params(params, mesh: Mesh):
    """Place each leaf of a port parameter tree by
    :func:`param_sharding_rules`: a split leaf becomes a :class:`Sharded`
    whose shard ``j`` lies on ``mesh.grid[0][j]``, a replicated leaf stays
    whole on ``mesh.grid[0][0]``. With one model shard every leaf is whole.
    A dimension the model axis does not divide raises ``ValueError`` naming
    the leaf."""

    m = mesh.n_model
    row = mesh.grid[0]

    def place(path, leaf):
        spec = param_sharding_rules(path, mesh)
        if m == 1 or not spec:
            return leaf.to(row[0])
        dim = spec.index(MODEL_AXIS)
        blocks = 3 if "qkv" in path else 1
        if leaf.shape[dim] % (m * blocks):
            raise ValueError(
                f"{'/'.join(path)}: dim {dim} of {tuple(leaf.shape)} is not divisible by "
                f"the model axis {m}" + (f" in each of its {blocks} blocks" if blocks > 1 else ""))
        pieces = [blk.chunk(m, dim) for blk in leaf.chunk(blocks, dim)]
        return Sharded([torch.cat([p[j] for p in pieces], dim).to(row[j]) for j in range(m)],
                       dim, blocks)

    return map_with_path(place, params)


def gather_params(params):
    """The whole tree of a :func:`shard_params` layout: every
    :class:`Sharded` leaf joined on its first shard's device."""

    return map_with_path(lambda _, leaf: leaf.full() if isinstance(leaf, Sharded) else leaf,
                         params)
