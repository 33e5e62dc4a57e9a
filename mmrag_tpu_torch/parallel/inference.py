"""Data-parallel encoder inference over a device mesh.

Port of ``mmrag_tpu/parallel/inference.py``: the reference's torch minibatch
loops (``app/ml/embeddings.py:53,74,82``) as data parallelism over the
mesh's ``data`` axis. Params are replicated (one copy per distinct device),
the batch rows split into ``n_data`` equal blocks, and each shard runs the
full forward on its block on its device, through the same kernels as the
single-device forward; the outputs concatenate, in shard order, on the
mesh's first device. The batch must divide evenly over the data axis (the
runtime pads its buckets to a multiple of it); a ragged batch raises.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .mesh import Mesh, Replicated, on_device, replicated


def shard_batch_fn(mesh: Mesh, fn: Callable[..., torch.Tensor],
                   n_batch_args: int = 1) -> Callable[..., torch.Tensor]:
    """Wrap ``fn(params, *batches) -> (b, ...)`` for data-parallel runs.

    The wrapper takes ``params`` as a :class:`~mmrag_tpu_torch.parallel.mesh.
    Replicated` (the runtime's copies, made once) or as a tree it replicates
    for the call, then ``n_batch_args`` arrays or tensors split on dim 0."""

    def wrapper(params, *batches):
        n = mesh.n_data
        if len(batches) != n_batch_args:
            raise TypeError(f"expected {n_batch_args} batch arguments, got {len(batches)}")
        for b in batches:
            if b.shape[0] % n != 0:
                raise ValueError(f"batch dim {b.shape[0]} not divisible by data axis {n}")
        copies = params if isinstance(params, Replicated) else replicated(mesh, params)
        rows = batches[0].shape[0] // n
        head = mesh.devices[0]
        outs = []
        for s, dev in enumerate(mesh.devices):
            parts = []
            for b in batches:
                piece = b[s * rows:(s + 1) * rows]
                if not isinstance(piece, torch.Tensor):
                    piece = torch.from_numpy(np.ascontiguousarray(piece))
                parts.append(piece.to(dev, non_blocking=True))
            with on_device(dev):
                outs.append(fn(copies[dev], *parts))
        return torch.cat([o.to(head) for o in outs])

    return wrapper


def dp_minilm_embed(mesh: Mesh, cfg=None):
    """Replicated-params, batch-sharded MiniLM sentence embedding:
    ``fn(params, ids, mask) -> (b, 384)`` (the params' dtype is the working
    dtype)."""

    from ..models import bert

    bcfg = cfg or bert.MINILM_L6

    @torch.inference_mode()
    def fn(params, ids, mask):
        return bert.minilm_embed(params, ids, mask, bcfg)

    return shard_batch_fn(mesh, fn, n_batch_args=2)


def dp_clip_image_embed(mesh: Mesh, cfg=None):
    """Replicated-params, batch-sharded CLIP image embedding with the device
    preprocess (X2): ``fn(params, images_u8) -> (b, 512)``, uint8 HWC square
    crops of any canvas in, L2-normalized rows out."""

    from ..models import bert, clip
    from ..ops.images import preprocess_batch

    ccfg = cfg or clip.CLIP_VIT_B32

    @torch.inference_mode()
    def fn(params, images_u8):
        pixels = preprocess_batch(images_u8)
        return bert.l2_normalize(clip.clip_image_features(params, pixels, ccfg))

    return shard_batch_fn(mesh, fn, n_batch_args=1)
