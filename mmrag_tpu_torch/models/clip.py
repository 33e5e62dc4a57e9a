"""CLIP ViT-B/32 dual tower (vision + text) in PyTorch, HF numerics.

Port of ``mmrag_tpu/models/clip.py``. Architecture facts mirrored from HF
``openai/clip-vit-base-patch32``: pre-LN transformer blocks, quick_gelu,
LayerNorm eps 1e-5, vision pooling = post-LN CLS token, text pooling =
hidden state at the argmax(token id) position (EOT has the largest id),
bias-free projections to the shared 512-d space. Outputs are unnormalized
like HF's ``get_image_features``; callers L2-normalize.

The vision tower runs the JAX package's fused branch on every device: the 50
tokens are padded to 56 with masked keys, ``layers[:-1]`` run as B1 (pre-LN,
``ln_key="ln1"``) + B3, or with ``q8_layers`` (from
:func:`quantize_clip_vision`, ``TPU_ENCODER_QUANT=int8``) as B6 (pre-LN) + B7
(pre-LN, quick_gelu), and the last layer is evaluated at the CLS row only
(:func:`_final_cls_layer`, plain torch in the stream dtype). The text tower
is never quantized: its projections and MLP are plain torch products and
every layer's multi-head attention is B5 (``fused_encoder_attention``, the
JAX package's fused text branch) with the causal + padding bias, the scale
applied to the scores.

``attention_impl="xla"`` is the training forward of both towers
(``mmrag_tpu/models/clip.py:185-243, 383-420``): plain differentiable
torch at an explicit ``compute_dtype`` on f32 master weights, no padding of
the vision tokens and no CLS-pruned last layer, q scaled before the product,
and the encoder blocks over ``tp``'s model shards (``bert.PlainShards``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Dict

import numpy as np
import torch

from ..ops.attention import (
    fused_attention_block, fused_attention_block_q8, fused_encoder_attention,
)
from ..ops.mlp import fused_mlp_block, fused_mlp_block_q8
from ..ops.quant import quantize_encoder_layers
from .bert import (
    PLAIN, _dense, _dense_init, _dense_xla, _layer_norm, _layer_norm_xla, _ln_init, _normal,
    _qkv_xla, _rounded, matmul_f32,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    max_position: int = 77
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class CLIPConfig:
    vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    projection_dim: int = 512


CLIP_VIT_B32 = CLIPConfig()


# ---------------------------------------------------------------------------
# Seeded init (JAX-layout tree of numpy arrays; see convert.params_from_jax)
# ---------------------------------------------------------------------------


def _encoder_layer_init(gen, hidden: int, intermediate: int) -> Params:
    return {
        "ln1": _ln_init(hidden),
        "q": _dense_init(gen, hidden, hidden),
        "k": _dense_init(gen, hidden, hidden),
        "v": _dense_init(gen, hidden, hidden),
        "attn_out": _dense_init(gen, hidden, hidden),
        "ln2": _ln_init(hidden),
        "fc1": _dense_init(gen, hidden, intermediate),
        "fc2": _dense_init(gen, intermediate, hidden),
    }


def init_clip_params(seed: int = 1, cfg: CLIPConfig = CLIP_VIT_B32) -> Params:
    """Seeded init with the JAX package's tree and stds (``torch.Generator``
    numbers, not ``jax.random``'s)."""

    gen = torch.Generator().manual_seed(seed)
    v, t = cfg.vision, cfg.text
    patch_dim = 3 * v.patch_size * v.patch_size
    vision: Params = {
        "class_embedding": _normal(gen, (v.hidden_size,)),
        "patch_kernel": _normal(gen, (patch_dim, v.hidden_size)),
        "position_embedding": _normal(gen, (v.num_patches + 1, v.hidden_size)),
        "pre_ln": _ln_init(v.hidden_size),
        "layers": [
            _encoder_layer_init(gen, v.hidden_size, v.intermediate_size)
            for _ in range(v.num_layers)
        ],
        "post_ln": _ln_init(v.hidden_size),
    }
    text: Params = {
        "token_embedding": _normal(gen, (t.vocab_size, t.hidden_size)),
        "position_embedding": _normal(gen, (t.max_position, t.hidden_size)),
        "layers": [
            _encoder_layer_init(gen, t.hidden_size, t.intermediate_size)
            for _ in range(t.num_layers)
        ],
        "final_ln": _ln_init(t.hidden_size),
    }
    return {
        "vision": vision,
        "text": text,
        "visual_projection": {"kernel": _normal(gen, (v.hidden_size, cfg.projection_dim))},
        "text_projection": {"kernel": _normal(gen, (t.hidden_size, cfg.projection_dim))},
        "logit_scale": np.asarray(np.log(1 / 0.07), np.float32),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _split_qkv(layer: Params, h: int):
    """The q, k and v projections as views of the fused (h, 3h) kernel."""

    w, b = layer["qkv"]["kernel"], layer["qkv"]["bias"]
    return [{"kernel": w[:, i * h : (i + 1) * h], "bias": b[i * h : (i + 1) * h]}
            for i in range(3)]


def _attention(layer: Params, x: torch.Tensor, bias: torch.Tensor, num_heads: int,
               dtype) -> torch.Tensor:
    """Text-tower attention: the fused q|k|v projection cast to the stream
    dtype, B5 over its thirds (strided views, no copies) with the (b, s, s)
    ``bias``, then the output projection."""

    h = x.shape[-1]
    qkv = _dense(layer["qkv"], x, dtype).to(dtype)  # (b, s, 3h)
    ctx = fused_encoder_attention(qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:], num_heads,
                                  bias=bias)
    return _dense(layer["attn_out"], ctx, dtype)


def _encoder_layer(layer: Params, x, bias, num_heads: int, eps: float,
                   dtype) -> torch.Tensor:
    x = x + _attention(layer, _layer_norm(layer["ln1"], x, eps), bias, num_heads, dtype)
    y = _layer_norm(layer["ln2"], x, eps)
    y = _dense(layer["fc2"], quick_gelu(_dense(layer["fc1"], y, dtype)), dtype)
    return x + y


def _final_cls_layer(
    layer: Params,
    x: torch.Tensor,  # (b, s, h) residual stream entering the last layer
    mask: torch.Tensor,  # (b, s) {0,1} key validity
    v: CLIPVisionConfig,
    dtype,
) -> torch.Tensor:
    """Last pre-LN encoder layer evaluated only at the CLS position: k/v
    cover every token (CLS attends to the whole image), q, the output
    projection and the MLP run on one row per image."""

    b, s, h = x.shape
    nh, hd = v.num_heads, v.head_dim
    eps = v.layer_norm_eps
    pq, pk, pv = _split_qkv(layer, h)
    a_in = _layer_norm(layer["ln1"], x, eps).to(dtype)
    k = _dense(pk, a_in, dtype).reshape(b, s, nh, hd)
    val = _dense(pv, a_in, dtype).reshape(b, s, nh, hd)
    q = _dense(pq, a_in[:, 0], dtype).reshape(b, nh, hd) * (hd ** -0.5)
    scores = torch.einsum("bnd,bknd->bnk", q.to(dtype), k.to(dtype)).float()
    scores = scores + ((1.0 - mask.to(torch.float32)) * -1e9)[:, None, :]
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bnk,bknd->bnd", probs.to(dtype), val.to(dtype)).float().reshape(b, h)
    x_cls = x[:, 0].float() + _dense(layer["attn_out"], ctx, dtype)
    y = _layer_norm(layer["ln2"], x_cls, eps).to(dtype)
    mlp = _dense(layer["fc2"], quick_gelu(_dense(layer["fc1"], y, dtype)), dtype)
    return x_cls + mlp


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(b, H, W, 3) -> (b, n_patches, 3*patch*patch) in torch conv weight
    flattening order [in_channels, kh, kw]."""

    b, hgt, wid, c = pixels.shape
    gh, gw = hgt // patch, wid // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (b, gh, gw, c, ph, pw)
    return x.reshape(b, gh * gw, c * patch * patch)


def stream_dtype(params: Params) -> torch.dtype:
    return params["vision"]["patch_kernel"].dtype


_CLIP_LINEARS = ("qkv", "attn_out", "fc1", "fc2")


def quantize_clip_vision(params: Params) -> Params:
    """Per-channel int8 of the vision tower's encoder blocks, from a CLIP tree
    in the port's layout with f32 matrices (see ``bert.quantize_bert``)."""

    layers = params["vision"]["layers"]
    if layers[0]["qkv"]["kernel"].dtype != torch.float32:
        raise ValueError("quantize_clip_vision takes the f32 weights")
    return {"layers": quantize_encoder_layers(layers, _CLIP_LINEARS)}


def clip_image_features(
    params: Params,
    pixels: torch.Tensor,  # (b, H, W, 3) f32, already normalized
    cfg: CLIPConfig = CLIP_VIT_B32,
    q8_layers: Params | None = None,
    attention_impl: str = "fused",
    compute_dtype: torch.dtype = torch.float32,
    tp=None,
) -> torch.Tensor:
    """Unnormalized projection-dim image features (HF ``get_image_features``);
    ``q8_layers`` runs ``layers[:-1]`` as B6 + B7. ``attention_impl="xla"``
    runs the training forward at ``compute_dtype`` (see the module)."""

    if attention_impl == "xla":
        if q8_layers is not None:
            raise ValueError("the xla forward runs the f32 weights, not q8 layers")
        return _image_features_xla(params, pixels, cfg, compute_dtype, tp or PLAIN)
    if attention_impl != "fused":
        raise ValueError(f"attention_impl {attention_impl!r}: fused or xla")
    v = cfg.vision
    vp = params["vision"]
    dtype = stream_dtype(params)
    patches = patchify(pixels, v.patch_size)
    x = matmul_f32(patches.to(dtype), vp["patch_kernel"])
    cls = vp["class_embedding"].expand(x.shape[0], 1, v.hidden_size)
    x = torch.cat([cls, x], dim=1) + vp["position_embedding"][None]
    x = _layer_norm(vp["pre_ln"], x, v.layer_norm_eps)

    b, s, h = x.shape
    # pad the token dim to a multiple of 8 (ViT-B/32: 50 -> 56); padded
    # tokens are masked as keys, so real-token numerics are unchanged
    s_pad = -(-s // 8) * 8
    mask = torch.zeros((b, s_pad), dtype=torch.int32, device=x.device)
    mask[:, :s] = 1
    x2 = torch.nn.functional.pad(x, (0, 0, 0, s_pad - s))
    x2 = x2.reshape(b * s_pad, h).to(dtype)
    if q8_layers is not None:
        for qlayer in q8_layers["layers"][:-1]:
            x2 = fused_attention_block_q8(x2, qlayer, v.num_heads, s_pad, v.layer_norm_eps,
                                          mask, pre_ln=True, ln_key="ln1")
            x2 = fused_mlp_block_q8(x2, qlayer, v.layer_norm_eps)
    else:
        for layer in vp["layers"][:-1]:
            x2 = fused_attention_block(
                x2, layer, v.num_heads, s_pad, v.layer_norm_eps, mask, pre_ln=True, ln_key="ln1"
            )
            x2 = fused_mlp_block(x2, layer, v.layer_norm_eps)
    pooled = _final_cls_layer(vp["layers"][-1], x2.reshape(b, s_pad, h), mask, v, dtype)
    pooled = _layer_norm(vp["post_ln"], pooled, v.layer_norm_eps)
    return _dense(params["visual_projection"], pooled, dtype)


def clip_text_features(
    params: Params,
    input_ids: torch.Tensor,  # (b, 77) int, padded with zeros after EOT
    attention_mask: torch.Tensor,  # (b, 77) {0,1}
    cfg: CLIPConfig = CLIP_VIT_B32,
    attention_impl: str = "fused",
    compute_dtype: torch.dtype = torch.float32,
    tp=None,
) -> torch.Tensor:
    """Unnormalized projection-dim text features (HF CLIP text tower);
    ``attention_impl="xla"`` runs the training forward (see the module)."""

    if attention_impl == "xla":
        return _text_features_xla(params, input_ids, attention_mask, cfg, compute_dtype,
                                  tp or PLAIN)
    if attention_impl != "fused":
        raise ValueError(f"attention_impl {attention_impl!r}: fused or xla")
    t = cfg.text
    tp = params["text"]
    dtype = stream_dtype(params)
    ids = input_ids.long()
    b, s = ids.shape
    x = tp["token_embedding"][ids] + tp["position_embedding"][:s][None]
    causal = torch.triu(torch.full((s, s), -1e9, dtype=torch.float32, device=x.device),
                        diagonal=1)[None]
    pad = (1.0 - attention_mask.to(torch.float32))[:, None, :] * -1e9
    bias = (causal + pad).contiguous()  # (b, s, s)
    for layer in tp["layers"]:
        x = _encoder_layer(layer, x, bias, t.num_heads, t.layer_norm_eps, dtype)
    x = _layer_norm(tp["final_ln"], x, t.layer_norm_eps)
    # EOT pooling: the EOT token has the largest id in the CLIP vocab
    eot_pos = torch.argmax(ids, dim=-1)
    pooled = x[torch.arange(b, device=x.device), eot_pos]
    return _dense(params["text_projection"], pooled, dtype)


# ---------------------------------------------------------------------------
# The training forward (attention_impl="xla")
# ---------------------------------------------------------------------------


def _attention_xla(layer: Params, x: torch.Tensor, bias, *, hd: int, dtype) -> torch.Tensor:
    """``_attention``'s einsum branch on one model shard's heads, through its
    rows of the output projection (no bias): q scaled before the product,
    the additive ``bias`` (b, 1, s, s) if any, an f32 softmax."""

    b, s, _ = x.shape
    (q, k, v), hl = _qkv_xla(layer, x, dtype)
    q, k, v = (t.reshape(b, s, hl // hd, hd) for t in (q, k, v))
    scores = torch.einsum("bqnd,bknd->bnqk", _rounded(q * hd ** -0.5, dtype), _rounded(k, dtype))
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bnqk,bknd->bqnd", _rounded(probs, dtype), _rounded(v, dtype))
    return _rounded(ctx.reshape(b, s, hl), dtype) @ _rounded(layer["attn_out"]["kernel"], dtype)


def _mlp_xla(layer: Params, y: torch.Tensor, *, dtype) -> torch.Tensor:
    inner = quick_gelu(_dense_xla(layer["fc1"], y, dtype))
    return _rounded(inner, dtype) @ _rounded(layer["fc2"]["kernel"], dtype)


def _encoder_layer_xla(layer: Params, x, bias, hd: int, eps: float, dtype, tp) -> torch.Tensor:
    """Pre-LN ``_encoder_layer``: the residual stream in f32, each block's
    down-projection bias added once after the sum over the model shards."""

    attn = tp.parallel(partial(_attention_xla, hd=hd, dtype=dtype), layer,
                       _layer_norm_xla(layer["ln1"], x, eps), bias)
    x = x + (attn + layer["attn_out"]["bias"])
    y = tp.parallel(partial(_mlp_xla, dtype=dtype), layer, _layer_norm_xla(layer["ln2"], x, eps))
    return x + (y + layer["fc2"]["bias"])


def _image_features_xla(params: Params, pixels, cfg: CLIPConfig, dtype, tp) -> torch.Tensor:
    v = cfg.vision
    vp = params["vision"]
    eps = v.layer_norm_eps
    x = _rounded(patchify(pixels, v.patch_size), dtype) @ _rounded(vp["patch_kernel"], dtype)
    cls = vp["class_embedding"].expand(x.shape[0], 1, v.hidden_size)
    x = torch.cat([cls, x], dim=1) + vp["position_embedding"][None]
    x = _layer_norm_xla(vp["pre_ln"], x, eps)
    for layer in vp["layers"]:
        x = _encoder_layer_xla(layer, x, None, v.head_dim, eps, dtype, tp)
    pooled = _layer_norm_xla(vp["post_ln"], x[:, 0], eps)
    return _dense_xla(params["visual_projection"], pooled, dtype)


def _text_features_xla(params: Params, input_ids, attention_mask, cfg: CLIPConfig, dtype,
                       tp) -> torch.Tensor:
    t = cfg.text
    tp_params = params["text"]
    ids = input_ids.long()
    b, s = ids.shape
    x = tp.lookup(tp_params["token_embedding"], ids) + tp_params["position_embedding"][:s][None]
    causal = torch.triu(torch.full((s, s), -1e9, dtype=torch.float32, device=x.device),
                        diagonal=1)[None, None]
    bias = causal + (1.0 - attention_mask.float())[:, None, None, :] * -1e9
    for layer in tp_params["layers"]:
        x = _encoder_layer_xla(layer, x, bias, t.head_dim, t.layer_norm_eps, dtype, tp)
    x = _layer_norm_xla(tp_params["final_ln"], x, t.layer_norm_eps)
    # EOT pooling at the first largest id, as jnp.argmax
    pooled = x[torch.arange(b, device=x.device), ids.argmax(-1)]
    return _dense_xla(params["text_projection"], pooled, dtype)
