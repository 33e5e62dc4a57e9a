"""Checkpoint / resume: train-state checkpoints and versioned index snapshots.

Port of ``mmrag_tpu/utils/checkpoint.py``:

  * :func:`save_train_state` / :func:`restore_train_state` — the fine-tuning
    state of :mod:`mmrag_tpu_torch.parallel.training` (a nested dict or list
    of tensors, numbers and an optimizer's ``state_dict()``) under
    ``checkpoint_dir/step_<n>``, with retained-checkpoint GC. JAX writes
    orbax's tensorstore format, which cannot be read without orbax; the port
    writes the flat ``/``-joined npz of the converted weights
    (``models/convert.py``) with each tensor's dtype, plus a JSON file for
    what is not an array.
  * :func:`snapshot_indexes` / :func:`restore_indexes` — point-in-time
    copies of the vector-index persistence files (the JAX package's own
    format), so an index can be rolled back independently of SQLite
    catalogs.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_ARRAYS = "state.npz"
_META = "state.json"


def _flatten(node: Any, prefix: str, tensors: Dict[str, torch.Tensor],
             values: Dict[str, Any]) -> None:
    """The tree's tensors and its other leaves by ``/``-joined path."""

    if isinstance(node, dict):
        for key, val in node.items():
            _flatten(val, f"{prefix}{key}/", tensors, values)
    elif isinstance(node, (list, tuple)):
        for i, val in enumerate(node):
            _flatten(val, f"{prefix}{i}/", tensors, values)
    elif isinstance(node, torch.Tensor):
        tensors[prefix[:-1]] = node
    elif node is None or isinstance(node, (bool, int, float, str)):
        values[prefix[:-1]] = node
    else:
        raise TypeError(f"{prefix[:-1]}: cannot checkpoint a {type(node).__name__}")


def _step_path(checkpoint_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), f"step_{step:08d}")


def save_train_state(
    checkpoint_dir: str, step: int, state: Dict[str, Any], keep: int = 3
) -> str:
    """Write ``state`` under ``checkpoint_dir/step_<n>``, replacing a
    checkpoint of the same step (orbax's ``force=True``): the files are
    written into a temporary directory that then takes the step's name. Keeps
    the newest ``keep`` checkpoints."""

    tensors: Dict[str, torch.Tensor] = {}
    values: Dict[str, Any] = {}
    _flatten(state, "", tensors, values)
    # numpy has no bf16: its values are exact in f32
    arrays = {k: (t.detach().cpu().float() if t.dtype == torch.bfloat16 else t.detach().cpu())
              .numpy() for k, t in tensors.items()}
    dtypes = {k: str(t.dtype) for k, t in tensors.items()}
    path = _step_path(checkpoint_dir, step)
    root, name = os.path.split(path)
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".{name}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _ARRAYS), **arrays)
    with open(os.path.join(tmp, _META), "w") as fh:
        json.dump({"step": step, "dtypes": dtypes, "values": values}, fh)
    old = None
    if os.path.exists(path):  # a directory cannot be replaced while it holds files
        old = os.path.join(root, f".{name}.old-{os.getpid()}")
        os.replace(path, old)
    os.replace(tmp, path)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    _gc_checkpoints(root, keep)
    return path


def latest_step(checkpoint_dir: str) -> Optional[int]:
    if not os.path.isdir(checkpoint_dir):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(checkpoint_dir)
        if name.startswith("step_") and name.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def restore_train_state(
    checkpoint_dir: str, target: Dict[str, Any], step: Optional[int] = None
) -> Dict[str, Any]:
    """The checkpoint of ``step`` (default: the latest) in ``target``'s
    structure, each tensor with its target's dtype and device. No checkpoint
    raises ``FileNotFoundError``; a path, shape or dtype that differs from
    ``target``'s raises ``ValueError``."""

    step = step if step is not None else latest_step(checkpoint_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {checkpoint_dir}")
    path = _step_path(checkpoint_dir, step)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint {path}")
    with open(os.path.join(path, _META)) as fh:
        meta = json.load(fh)
    tensors: Dict[str, torch.Tensor] = {}
    values: Dict[str, Any] = {}
    _flatten(target, "", tensors, values)
    if set(tensors) != set(meta["dtypes"]) or set(values) != set(meta["values"]):
        want, have = set(tensors) | set(values), set(meta["dtypes"]) | set(meta["values"])
        raise ValueError(f"checkpoint {path} does not match the target: "
                         f"missing {sorted(want - have)[:5]}, extra {sorted(have - want)[:5]}")
    with np.load(os.path.join(path, _ARRAYS)) as data:
        saved = {k: data[k] for k in data.files}
    for key, t in tensors.items():
        if meta["dtypes"][key] != str(t.dtype) or saved[key].shape != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint holds {meta['dtypes'][key]} "
                             f"{saved[key].shape}, target {t.dtype} {tuple(t.shape)}")

    def build(node: Any, prefix: str) -> Any:
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}{i}/") for i, v in enumerate(node))
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(saved[prefix[:-1]]).to(node.device, node.dtype)
        return meta["values"][prefix[:-1]]

    return build(target, "")


def _gc_checkpoints(checkpoint_dir: str, keep: int) -> None:
    steps = sorted(
        name for name in os.listdir(checkpoint_dir) if name.startswith("step_")
    )
    for name in steps[:-keep]:
        shutil.rmtree(os.path.join(checkpoint_dir, name), ignore_errors=True)


# ---------------------------------------------------------------------------
# Index snapshots
# ---------------------------------------------------------------------------

_INDEX_FILES = (
    "text_collection.npz",
    "text_collection.manifest.json",
    "image_collection.npz",
    "image_collection.manifest.json",
)


def snapshot_indexes(index_dir: str, checkpoint_dir: str, label: str = "") -> str:
    """Copy the current persisted index files into a timestamped snapshot."""

    stamp = time.strftime("%Y%m%d-%H%M%S")
    name = f"index-{stamp}" + (f"-{label}" if label else "")
    dest = os.path.join(checkpoint_dir, name)
    os.makedirs(dest, exist_ok=True)
    copied: List[str] = []
    for fname in _INDEX_FILES:
        src = os.path.join(index_dir, fname)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(dest, fname))
            copied.append(fname)
    with open(os.path.join(dest, "snapshot.json"), "w") as fh:
        json.dump({"label": label, "created": time.time(), "files": copied}, fh)
    return dest


def list_index_snapshots(checkpoint_dir: str) -> List[str]:
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(
        name for name in os.listdir(checkpoint_dir) if name.startswith("index-")
    )


def restore_indexes(snapshot_path: str, index_dir: str) -> List[str]:
    """Copy snapshot files back over the live index dir (engine must reload)."""

    os.makedirs(index_dir, exist_ok=True)
    restored = []
    for fname in _INDEX_FILES:
        src = os.path.join(snapshot_path, fname)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(index_dir, fname))
            restored.append(fname)
    if not restored:
        raise FileNotFoundError(f"no index files in snapshot {snapshot_path}")
    return restored
