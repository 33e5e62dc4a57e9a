"""Fine-tuning steps for the three served towers on a (data, model) mesh.

Port of ``mmrag_tpu/parallel/training.py``: CLIP with symmetric InfoNCE,
the MiniLM bi-encoder with the multiple-negatives ranking loss and the
cross-encoder with a pointwise sigmoid loss, each with AdamW at
``optax.adamw``'s defaults (b1 0.9, b2 0.999, eps 1e-8 added to the root of
the second moment, weight decay 1e-4 on every leaf) and JAX's learning
rates.

The forward is the towers' ``attention_impl="xla"`` composition in plain
differentiable torch: JAX's training pins it because the Pallas kernels have
no VJP, so, as there, no B1-B12 kernel launches while training.

On a mesh (:func:`mmrag_tpu_torch.parallel.mesh.build_mesh`) the batch rows
split over ``data``; within a data row the model shards compute the
vocabulary-parallel lookups, the column-parallel up-projections on their own
heads and columns, and the row-parallel down-projections, summed over the
shards with the bias added once after the sum (the psum XLA inserts from the
shardings). The features of every row meet on the mesh's first device, where
the global similarity matrix and the loss are computed. Parameters live once
(:func:`~mmrag_tpu_torch.parallel.mesh.shard_params`); each row works on
device copies of them, so autograd sums every replica's gradient into its
leaf. The loss and the gathered parameters of any (d, m) mesh equal the
one-device step's, up to the order of the sums.

Across processes (a group from
:func:`~mmrag_tpu_torch.parallel.mesh.initialize_multihost`) each process
passes its own rows of the global batch; the features are all-gathered in
rank order with autograd, every process computes the global loss, and the
gradients are all-reduced, so each process's parameters after a step equal
one process's on the whole batch.

Entry points run on ``cuda`` unless given ``device="cpu"`` (or a mesh of
CPU devices) and raise without it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, ClassVar, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..models import bert, clip
from ..models.convert import params_from_jax
from ..ops.topk import l2_normalize
from .mesh import Mesh, Sharded, build_mesh, map_with_path, shard_params

Params = Dict[str, Any]


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw(learning_rate)``: its defaults, and ``mask=None``, so LN
    scales, biases and ``logit_scale`` decay too (``torch.optim.AdamW``'s
    own weight decay is 0.01)."""

    learning_rate: float
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.999
    eps: ClassVar[float] = 1e-8  # added to the root of the second moment
    weight_decay: ClassVar[float] = 1e-4

    def init(self, params) -> torch.optim.AdamW:
        """The optimizer over the tree's leaves (each shard of a split leaf
        one), its moments allocated beside them, as optax's ``tx.init``."""

        leaves = param_leaves(params)
        opt = torch.optim.AdamW(leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
                                eps=self.eps, weight_decay=self.weight_decay)
        for p in leaves:
            opt.state[p] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
        return opt


def param_leaves(params) -> List[torch.Tensor]:
    """The tree's tensors in tree order, each shard of a split leaf one."""

    leaves: List[torch.Tensor] = []
    map_with_path(lambda _, t: leaves.extend(t.shards if isinstance(t, Sharded) else [t]),
                  params)
    return leaves


def load_train_state(params, opt: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """Copy a restored ``{"params": ..., "opt": ...}`` (the result of
    :func:`mmrag_tpu_torch.utils.checkpoint.restore_train_state`, with
    ``params`` as the tree or its :func:`param_leaves`) into a live train
    state, in place."""

    with torch.no_grad():
        for leaf, value in zip(param_leaves(params), param_leaves(state["params"]), strict=True):
            leaf.copy_(value)
    opt.load_state_dict(state["opt"])


# ---------------------------------------------------------------------------
# The mesh: data rows, model shards, processes
# ---------------------------------------------------------------------------


class _RowShards:
    """The model axis of one data row (``bert.PlainShards``'s sharded form):
    shard ``j`` of every split leaf computes on ``devices[j]``, and the
    shards' partial results are summed on ``devices[0]`` in shard order."""

    def __init__(self, devices) -> None:
        self.devices = devices

    def lookup(self, table, ids: torch.Tensor) -> torch.Tensor:
        if not isinstance(table, Sharded):
            return table[ids]
        rows = table.shards[0].shape[0]
        out = None
        for j, (shard, dev) in enumerate(zip(table.shards, self.devices)):
            local = ids.to(dev) - j * rows
            hit = (local >= 0) & (local < rows)
            part = torch.where(hit[..., None], shard[local.clamp(0, rows - 1)], 0.0)
            part = part.to(self.devices[0])
            out = part if out is None else out + part
        return out

    def parallel(self, fn, layer: Params, *args) -> torch.Tensor:
        out = None
        for j, dev in enumerate(self.devices):
            local = map_with_path(lambda _, t: t.shards[j] if isinstance(t, Sharded) else t,
                                  layer)
            part = fn(local, *(a if a is None else a.to(dev) for a in args))
            part = part.to(self.devices[0])
            out = part if out is None else out + part
        return out


def _first_device(params) -> torch.device:
    return param_leaves(params)[0].device


def _world() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _gather_processes(t: torch.Tensor) -> torch.Tensor:
    """Every process's rows in rank order, with autograd."""

    if _world() == 1:
        return t
    from torch.distributed.nn.functional import all_gather

    return torch.cat(all_gather(t))


def _over_mesh(mesh: Mesh | None, params, fn: Callable, *batch) -> Tuple[torch.Tensor, ...]:
    """``fn(row_params, tp, *row_batch)`` (a tuple of per-row tensors) on each
    data row of ``mesh`` (``None``: one device, the params'), the rows'
    results concatenated in row order on the mesh's first device, then over
    the processes of a group in rank order. A batch the data axis does not
    divide raises."""

    if mesh is None:
        mesh = build_mesh(devices=[_first_device(params)])
    n = mesh.n_data
    size = batch[0].shape[0]
    if any(a.shape[0] != size for a in batch) or size % n:
        raise ValueError(f"batch dims {[a.shape[0] for a in batch]} not divisible by data axis {n}")
    rows = size // n
    head = mesh.grid[0][0]
    outs = []
    for i, row in enumerate(mesh.grid):
        view = map_with_path(
            lambda _, t: t.to_devices(row) if isinstance(t, Sharded) else t.to(row[0]), params)
        part = [torch.as_tensor(a[i * rows:(i + 1) * rows]).to(row[0]) for a in batch]
        outs.append(fn(view, _RowShards(row), *part))
    return tuple(_gather_processes(torch.cat([o[k].to(head) for o in outs]))
                 for k in range(len(outs[0])))


def _reduce_gradients(opt: torch.optim.Optimizer) -> None:
    """All-reduce the gradients over the processes of a group. The
    all-gather's backward already sums each process's feature gradients over
    the W processes, each of which backpropagated the same global loss, and a
    parameter outside the gather (``logit_scale``) gets the whole gradient in
    every process: either way the sum over processes is W times the gradient,
    so it is divided by W once."""

    world = _world()
    if world == 1:
        return
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is not None:
                torch.distributed.all_reduce(p.grad)
                p.grad.div_(world)


def _train_state(kind: str, init, mesh: Mesh | None, cfg, learning_rate: float,
                 device: DeviceLike, seeded: Callable) -> Tuple[Params, torch.optim.AdamW, AdamW]:
    if mesh is None:
        mesh = build_mesh(devices=[resolve_device(device)])
    for dev in mesh.distinct:
        resolve_device(dev)
    if isinstance(init, int):
        init = params_from_jax(seeded(init, cfg), kind, cfg)
    for leaf in param_leaves(init):
        if leaf.dtype != torch.float32:
            raise ValueError(f"training takes f32 master weights, not {leaf.dtype}")
    params = shard_params(map_with_path(lambda _, t: t.detach().clone(), init), mesh)
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    tx = AdamW(learning_rate)
    return params, tx.init(params), tx


def _make_step(loss_fn: Callable, mesh: Mesh | None, cfg, compute_dtype) -> Callable:
    def step(params, opt, *batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, *batch, cfg=cfg, compute_dtype=compute_dtype, mesh=mesh)
        loss.backward()
        _reduce_gradients(opt)
        opt.step()
        return params, opt, loss.detach()

    return step


# ---------------------------------------------------------------------------
# CLIP: symmetric InfoNCE
# ---------------------------------------------------------------------------


def clip_contrastive_loss(
    params: Params,
    images,  # (b, s, s, 3) f32 normalized pixels
    input_ids,  # (b, 77) int
    attention_mask,
    cfg: clip.CLIPConfig = clip.CLIP_VIT_B32,
    compute_dtype: torch.dtype = torch.float32,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    def features(p, tp, im, ids, mask):
        return (clip.clip_image_features(p, im, cfg, attention_impl="xla",
                                         compute_dtype=compute_dtype, tp=tp),
                clip.clip_text_features(p, ids, mask, cfg, attention_impl="xla",
                                        compute_dtype=compute_dtype, tp=tp))

    img, txt = _over_mesh(mesh, params, features, images, input_ids, attention_mask)
    img, txt = l2_normalize(img), l2_normalize(txt)
    logits = torch.exp(params["logit_scale"]) * img @ txt.T  # (b, b) global similarity
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0


def train_state_init(
    init,
    mesh: Mesh | None = None,
    cfg: clip.CLIPConfig = clip.CLIP_VIT_B32,
    learning_rate: float = 1e-5,
    device: DeviceLike = None,
) -> Tuple[Params, torch.optim.AdamW, AdamW]:
    """``(params, opt, tx)`` for CLIP. ``init`` is a port tree of f32 tensors
    (``params_from_jax``) or a seed of the port's init; the params are
    copied onto ``mesh`` (default: a mesh of ``device``, ``cuda`` unless
    given) by :func:`~mmrag_tpu_torch.parallel.mesh.shard_params`."""

    return _train_state("clip", init, mesh, cfg, learning_rate, device, clip.init_clip_params)


def make_train_step(
    mesh: Mesh | None = None,
    cfg: clip.CLIPConfig = clip.CLIP_VIT_B32,
    compute_dtype: torch.dtype = torch.float32,
) -> Callable:
    """``step(params, opt, images, input_ids, attention_mask) -> (params,
    opt, loss)``, updating ``params`` and ``opt`` in place (JAX donates its
    buffers). The optimizer carries its hyperparameters, so unlike JAX's this
    takes no ``tx``."""

    return _make_step(clip_contrastive_loss, mesh, cfg, compute_dtype)


# ---------------------------------------------------------------------------
# MiniLM bi-encoder: multiple-negatives ranking
# ---------------------------------------------------------------------------


def minilm_mnr_loss(
    params: Params,
    query_ids,  # (b, s) int
    query_mask,
    pos_ids,  # (b, s) positives; the other rows are in-batch negatives
    pos_mask,
    cfg: bert.BertConfig = bert.MINILM_L6,
    compute_dtype: torch.dtype = torch.float32,
    temperature: float = 0.05,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    def embeds(p, tp, q_ids, q_mask, p_ids, p_mask):
        return tuple(bert.minilm_embed(p, ids, mask, cfg, attention_impl="xla",
                                       compute_dtype=compute_dtype, tp=tp)
                     for ids, mask in ((q_ids, q_mask), (p_ids, p_mask)))

    q, p = _over_mesh(mesh, params, embeds, query_ids, query_mask, pos_ids, pos_mask)
    logits = (q @ p.T) / temperature  # (b, b) global similarity
    return F.cross_entropy(logits, torch.arange(logits.shape[0], device=logits.device))


def minilm_train_state_init(
    init,
    mesh: Mesh | None = None,
    cfg: bert.BertConfig = bert.MINILM_L6,
    learning_rate: float = 2e-5,
    device: DeviceLike = None,
) -> Tuple[Params, torch.optim.AdamW, AdamW]:
    """``(params, opt, tx)`` for MiniLM (see :func:`train_state_init`)."""

    return _train_state("minilm", init, mesh, cfg, learning_rate, device, bert.init_bert_params)


def make_minilm_train_step(
    mesh: Mesh | None = None,
    cfg: bert.BertConfig = bert.MINILM_L6,
    compute_dtype: torch.dtype = torch.float32,
) -> Callable:
    """``step(params, opt, q_ids, q_mask, p_ids, p_mask) -> (params, opt,
    loss)`` (see :func:`make_train_step`)."""

    return _make_step(minilm_mnr_loss, mesh, cfg, compute_dtype)


# ---------------------------------------------------------------------------
# Cross-encoder reranker: pointwise sigmoid relevance
# ---------------------------------------------------------------------------


def cross_encoder_loss(
    params: Params,
    input_ids,  # (b, s) packed (query, passage) pairs
    attention_mask,
    token_type_ids,
    labels,  # (b,) float {0, 1} relevance
    cfg: bert.BertConfig = bert.MINILM_L6,
    compute_dtype: torch.dtype = torch.float32,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    def scores(p, tp, ids, mask, tt, y):
        return (bert.cross_encoder_score(p, ids, mask, tt, cfg, attention_impl="xla",
                                         compute_dtype=compute_dtype, tp=tp), y)

    logits, labels = _over_mesh(mesh, params, scores, input_ids, attention_mask,
                                token_type_ids, labels)
    return F.binary_cross_entropy_with_logits(logits, labels.float())


def cross_encoder_train_state_init(
    init,
    mesh: Mesh | None = None,
    cfg: bert.BertConfig = bert.MINILM_L6,
    learning_rate: float = 2e-5,
    device: DeviceLike = None,
) -> Tuple[Params, torch.optim.AdamW, AdamW]:
    """``(params, opt, tx)`` for the cross-encoder (see
    :func:`train_state_init`)."""

    return _train_state("cross", init, mesh, cfg, learning_rate, device,
                        bert.init_cross_encoder_params)


def make_cross_encoder_train_step(
    mesh: Mesh | None = None,
    cfg: bert.BertConfig = bert.MINILM_L6,
    compute_dtype: torch.dtype = torch.float32,
) -> Callable:
    """``step(params, opt, ids, mask, tt, labels) -> (params, opt, loss)``
    (see :func:`make_train_step`)."""

    return _make_step(cross_encoder_loss, mesh, cfg, compute_dtype)
