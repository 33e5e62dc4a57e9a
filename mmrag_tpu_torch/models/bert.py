"""BERT encoder family in PyTorch: MiniLM-L6 sentence embedder + cross-encoder.

Port of ``mmrag_tpu/models/bert.py``:
  * ``sentence-transformers/all-MiniLM-L6-v2`` text embedding
    (reference ``app/ml/embeddings.py:52-70``): BERT-6L/384 -> masked mean
    pooling -> L2 normalize, 384-d output.
  * ``cross-encoder/ms-marco-MiniLM-L-6-v2`` rerank scorer
    (reference ``app/ml/retrieve.py:29-38,148``): same trunk + tanh pooler
    + 1-logit classifier head.

Parameters are plain nested dicts of tensors in the port's layout (built by
:func:`mmrag_tpu_torch.models.convert.params_from_jax` from the JAX package's
tree, or from :func:`init_bert_params`'s seeded tree): the q/k/v kernels are
one (h, 3h) matrix, matrices are in the stream dtype (bf16 on CUDA), biases,
LayerNorms and embeddings f32.

Every layer is the B1 attention block (post-LN, ``ln_key="attn_ln"``), then
the FFN (plain torch products and tanh-gelu, as the JAX package leaves them
to XLA), then B2 for ``ffn_ln``. With ``q8_layers`` (from
:func:`quantize_bert`, ``TPU_ENCODER_QUANT=int8``) every layer is instead the
W8A8 pair B6 (post-LN ``attn_ln``) + B7 (post-LN ``ffn_ln``, gelu_tanh or
gelu_erf), with no batch gate: every batch of a quantized tower scores
through the same numerics (``mmrag_tpu/models/bert.py::_use_q8``).
Embeddings, pooler and classifier stay full precision. HF BERT numerics:
post-LN residual blocks, additive -1e9 key mask, LayerNorm eps 1e-12 with
f32 statistics.

``attention_impl="xla"`` is the training forward
(:mod:`mmrag_tpu_torch.parallel.training`): JAX's einsum composition
(``mmrag_tpu/models/bert.py:229-240`` with ``_residual_ln(...,
allow_fused=False)``) in plain differentiable torch, on f32 master weights
at an explicit ``compute_dtype``, reaching no kernel, as JAX's training
reaches no ``pallas_call``. Its ``tp`` argument runs the encoder blocks over
the model axis of a data row (:class:`PlainShards` on one device).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict

import numpy as np
import torch

from ..ops import kernels
from ..ops.attention import fused_attention_block, fused_attention_block_q8
from ..ops.layernorm import fused_add_layer_norm
from ..ops.mlp import fused_mlp_block_q8
from ..ops.quant import quantize_encoder_layers
from ..ops.topk import l2_normalize as _l2_normalize

Params = Dict[str, Any]


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # tanh-approximate gelu, the JAX package's default; False = erf form
    gelu_approximate: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


MINILM_L6 = BertConfig()


# ---------------------------------------------------------------------------
# Seeded init (JAX-layout tree of numpy arrays; see convert.params_from_jax)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float = 0.02) -> np.ndarray:
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * std).numpy()


def _dense_init(gen, fan_in: int, fan_out: int) -> Params:
    return {"kernel": _normal(gen, (fan_in, fan_out)), "bias": np.zeros(fan_out, np.float32)}


def _ln_init(dim: int) -> Params:
    return {"scale": np.ones(dim, np.float32), "bias": np.zeros(dim, np.float32)}


def init_bert_params(seed: int = 0, cfg: BertConfig = MINILM_L6) -> Params:
    """Deterministic seeded init with HF-BERT's parameter tree shape and the
    JAX package's stds (normal 0.02, zero biases, unit LN). The numbers come
    from a ``torch.Generator`` and differ from ``jax.random``'s."""

    gen = torch.Generator().manual_seed(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    params: Params = {
        "embeddings": {
            "word": _normal(gen, (cfg.vocab_size, h)),
            "position": _normal(gen, (cfg.max_position, h)),
            "token_type": _normal(gen, (cfg.type_vocab_size, h)),
            "ln": _ln_init(h),
        },
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(
            {
                "q": _dense_init(gen, h, h),
                "k": _dense_init(gen, h, h),
                "v": _dense_init(gen, h, h),
                "attn_out": _dense_init(gen, h, h),
                "attn_ln": _ln_init(h),
                "ffn_in": _dense_init(gen, h, inter),
                "ffn_out": _dense_init(gen, inter, h),
                "ffn_ln": _ln_init(h),
            }
        )
    return params


def init_cross_encoder_params(seed: int = 0, cfg: BertConfig = MINILM_L6) -> Params:
    gen = torch.Generator().manual_seed(seed + 1)
    return {
        "bert": init_bert_params(seed, cfg),
        "pooler": _dense_init(gen, cfg.hidden_size, cfg.hidden_size),
        "classifier": _dense_init(gen, cfg.hidden_size, 1),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def matmul_f32(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``x @ kernel`` of stream-dtype operands with an f32 result, never
    rounded to the stream dtype (JAX's ``preferred_element_type=float32``):
    on the card ``torch.mm(..., out_dtype=float32)``; on the CPU, which lacks
    that form, f32 products of the operands (exact for bf16 values, so only
    the summation order differs). These are plain products that the JAX
    package leaves to XLA, not TPU kernels."""

    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        y = x2 @ kernel
    elif x.is_cuda:
        y = torch.mm(x2, kernel, out_dtype=torch.float32)
    else:
        y = x2.float() @ kernel.float()
    return y.reshape(*x.shape[:-1], kernel.shape[-1])


def _dense(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ kernel + bias`` with stream-dtype operands, f32 result and the
    bias added in f32 (plain torch: the products outside the kernels)."""

    y = matmul_f32(x.to(dtype), p["kernel"])
    if "bias" in p:
        y = y + p["bias"]
    return y


def _layer_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain f32 LayerNorm (the LNs outside the B1-B3 kernels)."""

    return kernels.layer_norm_plain(x, None, p["scale"], p["bias"], eps, torch.float32)


def stream_dtype(params: Params) -> torch.dtype:
    """The working dtype the converted matrices carry."""

    return params["layers"][0]["qkv"]["kernel"].dtype


_BERT_LINEARS = ("qkv", "attn_out", "ffn_in", "ffn_out")


def quantize_bert(params: Params) -> Params:
    """Per-channel int8 of the encoder blocks of a BERT tree in the port's
    layout with f32 matrices (``params_from_jax(..., dtype=torch.float32)``;
    pass a cross-encoder tree's ``params["bert"]`` for the reranker). The
    codes come from the f32 weights, as the JAX package quantizes its f32
    params; :func:`mmrag_tpu_torch.models.convert.params_from_jax` with
    ``q8=True`` calls this."""

    if params["layers"][0]["qkv"]["kernel"].dtype != torch.float32:
        raise ValueError("quantize_bert takes the f32 weights")
    return {"layers": quantize_encoder_layers(params["layers"], _BERT_LINEARS)}


def bert_encode(
    params: Params,
    input_ids: torch.Tensor,  # (b, s) int
    attention_mask: torch.Tensor,  # (b, s) {0,1}
    cfg: BertConfig = MINILM_L6,
    token_type_ids: torch.Tensor | None = None,
    q8_layers: Params | None = None,
    attention_impl: str = "fused",
    compute_dtype: torch.dtype = torch.float32,
    tp: "PlainShards | None" = None,
) -> torch.Tensor:
    """Last hidden states (b, s, hidden) in f32; ``q8_layers`` runs the
    blocks as B6 + B7. ``attention_impl="xla"`` runs the training forward at
    ``compute_dtype`` (the default ``"fused"`` computes in the weights'
    stream dtype and ignores it), its blocks over ``tp``'s model shards."""

    if attention_impl == "xla":
        if q8_layers is not None:
            raise ValueError("the xla forward runs the f32 weights, not q8 layers")
        return _bert_encode_xla(params, input_ids, attention_mask, cfg, token_type_ids,
                                compute_dtype, tp or PLAIN)
    if attention_impl != "fused":
        raise ValueError(f"attention_impl {attention_impl!r}: fused or xla")
    b, s = input_ids.shape
    dtype = stream_dtype(params)
    emb = params["embeddings"]
    ids = input_ids.long()
    tt = token_type_ids.long() if token_type_ids is not None else torch.zeros_like(ids)
    x = emb["word"][ids] + emb["position"][:s][None] + emb["token_type"][tt]
    x = _layer_norm(emb["ln"], x, cfg.layer_norm_eps)
    # 2-D (b*s, h) residual stream in the stream dtype; LN statistics stay f32
    x = x.reshape(b * s, cfg.hidden_size).to(dtype)
    if q8_layers is not None:
        act = "gelu_tanh" if cfg.gelu_approximate else "gelu_erf"
        for qlayer in q8_layers["layers"]:
            x = fused_attention_block_q8(x, qlayer, cfg.num_heads, s, cfg.layer_norm_eps,
                                         attention_mask, pre_ln=False, ln_key="attn_ln")
            x = fused_mlp_block_q8(x, qlayer, cfg.layer_norm_eps, pre_ln=False, act=act,
                                   k1="ffn_in", k2="ffn_out", ln_key="ffn_ln")
        return x.reshape(b, s, cfg.hidden_size).float()
    gelu = "tanh" if cfg.gelu_approximate else "none"
    for layer in params["layers"]:
        x = fused_attention_block(
            x, layer, cfg.num_heads, s, cfg.layer_norm_eps, attention_mask
        )
        inner = torch.nn.functional.gelu(_dense(layer["ffn_in"], x, dtype), approximate=gelu)
        out = _dense(layer["ffn_out"], inner, dtype)
        ln = layer["ffn_ln"]
        x = fused_add_layer_norm(
            x, out.to(dtype), ln["scale"], ln["bias"], cfg.layer_norm_eps, out_dtype=dtype
        )
    return x.reshape(b, s, cfg.hidden_size).float()


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling (sentence-transformers pooling layer)."""

    mask = attention_mask.to(torch.float32)[:, :, None]
    summed = (hidden * mask).sum(1)
    counts = torch.clamp(mask.sum(1), min=1e-9)
    return summed / counts


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return _l2_normalize(x, dim=-1, eps=eps)


def minilm_embed(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: BertConfig = MINILM_L6,
    q8_layers: Params | None = None,
    attention_impl: str = "fused",
    compute_dtype: torch.dtype = torch.float32,
    tp: "PlainShards | None" = None,
) -> torch.Tensor:
    """Sentence embeddings: encode -> masked mean pool -> L2 normalize."""

    hidden = bert_encode(params, input_ids, attention_mask, cfg, q8_layers=q8_layers,
                         attention_impl=attention_impl, compute_dtype=compute_dtype, tp=tp)
    return l2_normalize(mean_pool(hidden, attention_mask))


def cross_encoder_score(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: torch.Tensor,
    cfg: BertConfig = MINILM_L6,
    q8_layers: Params | None = None,
    attention_impl: str = "fused",
    compute_dtype: torch.dtype = torch.float32,
    tp: "PlainShards | None" = None,
) -> torch.Tensor:
    """(query, passage) pair relevance logits, shape (b,): CLS -> pooler
    dense -> tanh -> classifier dense(1). Raw logits, like the reference's
    CrossEncoder ms-marco output. ``q8_layers`` (``quantize_bert`` of
    ``params["bert"]``) runs the trunk's blocks as B6 + B7."""

    hidden = bert_encode(
        params["bert"], input_ids, attention_mask, cfg, token_type_ids=token_type_ids,
        q8_layers=q8_layers, attention_impl=attention_impl, compute_dtype=compute_dtype, tp=tp,
    )
    if attention_impl == "xla":
        pooled = torch.tanh(_dense_xla(params["pooler"], hidden[:, 0], compute_dtype))
        return _dense_xla(params["classifier"], pooled, compute_dtype)[:, 0]
    dtype = stream_dtype(params["bert"])
    pooled = torch.tanh(_dense(params["pooler"], hidden[:, 0], dtype))
    return _dense(params["classifier"], pooled, dtype)[:, 0]


# ---------------------------------------------------------------------------
# The training forward (attention_impl="xla")
# ---------------------------------------------------------------------------


class PlainShards:
    """The model axis of a data row on one device, every leaf whole.

    The xla forwards reach the model-split leaves only through these two
    calls (:mod:`mmrag_tpu_torch.parallel.training` gives the sharded
    form): ``lookup`` gathers embedding rows, and ``parallel(fn, layer,
    *args)`` runs ``fn``, a block from its column-parallel up-projections to
    its row-parallel down-projection, whose bias the caller adds after the
    sum over the shards."""

    @staticmethod
    def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return table[ids]

    @staticmethod
    def parallel(fn, layer: Params, *args) -> torch.Tensor:
        return fn(layer, *args)


PLAIN = PlainShards()


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and carried in f32: the xla forward's
    products are f32 products of compute-dtype operands, JAX's
    ``preferred_element_type=float32`` (a no-op in f32)."""

    return t.to(dtype).float()


def _dense_xla(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """``mmrag_tpu/models/bert.py::_dense``: compute-dtype operands, f32
    result, bias added in f32."""

    y = _rounded(x, dtype) @ _rounded(p["kernel"], dtype)
    if "bias" in p:
        y = y + p["bias"]
    return y


def _layer_norm_xla(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """JAX's plain ``_layer_norm`` in f32 (mean, centred variance, rsqrt)."""

    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _qkv_xla(layer: Params, x: torch.Tensor, dtype):
    """q, k and v of a (model shard of a) fused q|k|v projection, taken by
    column range, with the width of one of them."""

    w, b = layer["qkv"]["kernel"], layer["qkv"]["bias"]
    hl = w.shape[1] // 3
    return [_dense_xla({"kernel": w[:, i * hl:(i + 1) * hl], "bias": b[i * hl:(i + 1) * hl]},
                       x, dtype) for i in range(3)], hl


def _bert_attention_xla(layer: Params, x: torch.Tensor, mask_bias: torch.Tensor, *,
                        s: int, hd: int, dtype) -> torch.Tensor:
    """``_self_attention``'s einsum branch on one model shard's heads, through
    its rows of the output projection (no bias): the scale applied after
    q.k, then the additive key mask, an f32 softmax."""

    (q, k, v), hl = _qkv_xla(layer, x, dtype)
    b, nh = x.shape[0] // s, hl // hd
    q, k, v = (t.reshape(b, s, nh, hd) for t in (q, k, v))
    scores = torch.einsum("bqnd,bknd->bnqk", _rounded(q, dtype), _rounded(k, dtype))
    probs = torch.softmax(scores / math.sqrt(hd) + mask_bias, dim=-1)
    ctx = torch.einsum("bnqk,bknd->bqnd", _rounded(probs, dtype), _rounded(v, dtype))
    return _rounded(ctx.reshape(b * s, hl), dtype) @ _rounded(layer["attn_out"]["kernel"], dtype)


def _bert_ffn_xla(layer: Params, x: torch.Tensor, *, gelu: str, dtype) -> torch.Tensor:
    inner = torch.nn.functional.gelu(_dense_xla(layer["ffn_in"], x, dtype), approximate=gelu)
    return _rounded(inner, dtype) @ _rounded(layer["ffn_out"]["kernel"], dtype)


def _bert_encode_xla(params: Params, input_ids, attention_mask, cfg: BertConfig,
                     token_type_ids, dtype, tp) -> torch.Tensor:
    """``mmrag_tpu/models/bert.py::bert_encode`` with ``attention_impl="xla"``:
    the residual stream carried in ``dtype``, ``LN(x + delta)`` in f32 then
    cast (``_residual_ln(..., allow_fused=False)``)."""

    b, s = input_ids.shape
    h, eps = cfg.hidden_size, cfg.layer_norm_eps
    emb = params["embeddings"]
    ids = input_ids.long()
    tt = token_type_ids.long() if token_type_ids is not None else torch.zeros_like(ids)
    x = tp.lookup(emb["word"], ids) + emb["position"][:s][None] + emb["token_type"][tt]
    x = _layer_norm_xla(emb["ln"], x, eps).reshape(b * s, h).to(dtype)
    mask_bias = (1.0 - attention_mask.float())[:, None, None, :] * -1e9
    attention = partial(_bert_attention_xla, s=s, hd=cfg.head_dim, dtype=dtype)
    ffn = partial(_bert_ffn_xla, gelu="tanh" if cfg.gelu_approximate else "none", dtype=dtype)
    for layer in params["layers"]:
        attn = tp.parallel(attention, layer, x, mask_bias) + layer["attn_out"]["bias"]
        x = _layer_norm_xla(layer["attn_ln"], x + attn.to(dtype), eps).to(dtype)
        out = tp.parallel(ffn, layer, x) + layer["ffn_out"]["bias"]
        x = _layer_norm_xla(layer["ffn_ln"], x + out.to(dtype), eps).to(dtype)
    return x.reshape(b, s, h).float()
