"""Encoder attention: the whole block (B1), its W8A8 form (B6), the
multi-head attention with a full additive bias (B5), and the multi-head
attention over 2-D (b*s, h) operands with a key row (B12).

Port of ``mmrag_tpu/ops/attention.py::fused_attention_block``, whose Pallas
kernel ``_attn_block_kernel`` held the block's q/k/v/ctx in VMEM. On Hopper
the block is a composition of the port's hand-written kernels
(``ops/kernels.py``), every launch one of them:

    [pre-LN: K-ln] -> K-gemm (x @ W_qkv + b, cast to x.dtype)
        -> K-attn (one-pass softmax, key-row mask)
        -> K-gemm (ctx @ W_o + b_o + x, residual in f32)
        -> [post-LN: K-ln]

The rounding points are the JAX kernel's: q, k and v are cast to the stream
dtype, the context is cast before the output projection, the residual sum
is f32 and (post-LN) normalized before its one cast. A query row whose keys
are all masked (batch padding) gets a context of exactly 0.

``layer`` is the port's parameter dict for one encoder layer: ``qkv`` and
``attn_out`` (``kernel`` (in, out) in the stream dtype, ``bias`` f32) and the
LayerNorm under ``ln_key`` (``scale``/``bias`` f32).

:func:`fused_attention_block_q8` ports ``fused_attention_block_q8`` (Pallas
``_attn_block_kernel_q8``, ``TPU_ENCODER_QUANT=int8``) with the JAX kernel's
rounding points:

    pre-LN: K-quant of LN(x) in f32 | post-LN: K-quant of x in f32
        -> K-gemm-i8 (q|k|v, dequant + bias, cast to the stream dtype)
        -> K-attn (stream-dtype MHA, f32 context) -> K-quant of the context
        -> K-gemm-i8 (out-projection, dequant + bias + f32 residual)
        -> [post-LN: K-ln]

Its ``qlayer`` holds ``qkv`` and ``attn_out`` as quantized linears
(``ops/quant.py``: int8 ``q`` (in, out), f32 ``scale`` and ``bias``).

:func:`fused_encoder_attention` ports ``fused_encoder_attention`` (Pallas
``_attn_kernel``, the CLIP text tower's attention) as one K-attn launch in
its full-bias mode: (b, s, h) q, k, v (or the strided thirds of a fused
projection), the bias summed from a (b, s, s) or (s, s) ``bias`` and a
(b, s) key-padding ``attention_mask`` as the JAX wrapper sums them, the
scale applied to the scores.

:func:`fused_encoder_attention2d` ports ``fused_encoder_attention2d`` (Pallas
``_attn_kernel2d``) as one K-attn launch in its key-row mode over three
separate (b*s, h) tensors (row stride h). No path of either package reaches
it: the JAX ``bert_encode`` takes B1 under the very gate that would send
``_self_attention`` to it.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from . import kernels


def key_bias(attention_mask: Optional[torch.Tensor], b: int, seq: int, device) -> torch.Tensor:
    """(b, seq) f32 additive key row: 0 on real keys, -1e9 on padding."""

    if attention_mask is None:
        return torch.zeros((b, seq), dtype=torch.float32, device=device)
    return ((1.0 - attention_mask.to(torch.float32)) * -1e9).contiguous()


def fused_attention_block(
    x: torch.Tensor,  # (b*s, h) residual stream
    layer: Mapping,
    num_heads: int,
    seq: int,
    eps: float,
    attention_mask: Optional[torch.Tensor] = None,  # (b, s) {0,1}
    pre_ln: bool = False,
    ln_key: str = "attn_ln",
) -> torch.Tensor:
    """``LN(x + AttnOut(MHA(x)))`` post-LN (BERT, default) or
    ``x + AttnOut(MHA(LN(x)))`` pre-LN (CLIP, ``pre_ln=True`` with
    ``ln_key="ln1"``), in ``x.dtype``. Launches the kernels on a CUDA
    stream, runs their plain versions on a CPU one."""

    out = _attention_block(kernels.DISPATCH, x, layer, num_heads, seq, eps,
                           attention_mask, pre_ln, ln_key)
    if x.device.type == "cuda":
        kernels.count_launch("B1")
    return out


def fused_attention_block_plain(x, layer, num_heads, seq, eps, attention_mask=None,
                                pre_ln=False, ln_key="attn_ln"):
    """The same composition in plain torch on any device."""

    return _attention_block(kernels.PLAIN, x, layer, num_heads, seq, eps,
                            attention_mask, pre_ln, ln_key)


def _attention_block(k, x, layer, num_heads, seq, eps, attention_mask, pre_ln, ln_key):
    rows, h = x.shape
    if rows % seq:
        raise ValueError(f"rows {rows} not divisible by seq {seq}")
    b = rows // seq
    ln = layer[ln_key]
    kbias = key_bias(attention_mask, b, seq, x.device)
    a_in = k.layer_norm(x, None, ln["scale"], ln["bias"], eps, x.dtype) if pre_ln else x
    qkv = k.gemm(a_in, layer["qkv"]["kernel"], layer["qkv"]["bias"])
    ctx = k.attention(qkv, kbias, num_heads, seq)
    wo = layer["attn_out"]
    if pre_ln:
        return k.gemm(ctx, wo["kernel"], wo["bias"], residual=x)
    y = k.gemm(ctx, wo["kernel"], wo["bias"], residual=x, out_dtype=torch.float32)
    return k.layer_norm(y, None, ln["scale"], ln["bias"], eps, x.dtype)


def fused_attention_block_q8(
    x: torch.Tensor,  # (b*s, h) residual stream
    qlayer: Mapping,
    num_heads: int,
    seq: int,
    eps: float,
    attention_mask: Optional[torch.Tensor] = None,  # (b, s) {0,1}
    pre_ln: bool = False,
    ln_key: str = "attn_ln",
) -> torch.Tensor:
    """W8A8 form of :func:`fused_attention_block`, in ``x.dtype``. Launches
    the kernels on a CUDA stream, runs their plain versions on a CPU one."""

    out = _attention_block_q8(kernels.DISPATCH, x, qlayer, num_heads, seq, eps,
                              attention_mask, pre_ln, ln_key)
    if x.device.type == "cuda":
        kernels.count_launch("B6")
    return out


def fused_attention_block_q8_plain(x, qlayer, num_heads, seq, eps, attention_mask=None,
                                   pre_ln=False, ln_key="attn_ln"):
    """The same composition in plain torch on any device."""

    return _attention_block_q8(kernels.PLAIN, x, qlayer, num_heads, seq, eps,
                               attention_mask, pre_ln, ln_key)


def _attention_block_q8(k, x, qlayer, num_heads, seq, eps, attention_mask, pre_ln, ln_key):
    rows, h = x.shape
    if rows % seq:
        raise ValueError(f"rows {rows} not divisible by seq {seq}")
    ln, wqkv, wo = qlayer[ln_key], qlayer["qkv"], qlayer["attn_out"]
    kbias = key_bias(attention_mask, rows // seq, seq, x.device)
    if pre_ln:
        aq, ascale = k.row_quant(x, ln["scale"], ln["bias"], eps)
    else:
        aq, ascale = k.row_quant(x)
    qkv = k.gemm_i8(aq, ascale, wqkv["q"], wqkv["scale"], wqkv["bias"], out_dtype=x.dtype)
    ctx = k.attention(qkv, kbias, num_heads, seq, out_dtype=torch.float32)
    cq, cscale = k.row_quant(ctx)
    if pre_ln:
        return k.gemm_i8(cq, cscale, wo["q"], wo["scale"], wo["bias"], residual=x,
                         out_dtype=x.dtype)
    y = k.gemm_i8(cq, cscale, wo["q"], wo["scale"], wo["bias"], residual=x,
                  out_dtype=torch.float32)
    return k.layer_norm(y, None, ln["scale"], ln["bias"], eps, x.dtype)


def fused_encoder_attention(
    q: torch.Tensor,  # (b, s, h)
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    attention_mask: Optional[torch.Tensor] = None,  # (b, s) {0,1} key padding
    bias: Optional[torch.Tensor] = None,  # (b, s, s) or (s, s) f32 additive
) -> torch.Tensor:
    """Multi-head attention over (b, s, h) q, k, v; returns the contiguous
    (b, s, h) context in ``q.dtype``. Scores are ``q.k * hd^-0.5 + bias``
    with the HF additive -1e9 key mask. Launches K-attn on a CUDA stream,
    runs its plain version on a CPU one."""

    out = kernels.attention_full_bias(q, k, v, _full_bias(q, attention_mask, bias), num_heads)
    if q.device.type == "cuda":
        kernels.count_launch("B5")
    return out


def fused_encoder_attention_plain(q, k, v, num_heads, attention_mask=None, bias=None):
    """The same attention in plain torch on any device."""

    return kernels.attention_full_bias_plain(q, k, v, _full_bias(q, attention_mask, bias),
                                             num_heads)


def _full_bias(q: torch.Tensor, attention_mask, bias) -> torch.Tensor:
    """The f32 additive bias as the JAX wrapper sums it: ``0 + bias +
    (1 - mask) * -1e9``. A lone ``bias`` is taken as it is (the text tower's
    (b, s, s) one needs no copy); a lone (s, s) one stays shared by the
    batch."""

    b, s, _ = q.shape
    if attention_mask is None and bias is not None:
        return bias.float().contiguous()
    full = torch.zeros((b, s, s), dtype=torch.float32, device=q.device)
    if bias is not None:
        full = full + bias.float()
    if attention_mask is not None:
        full = full + (1.0 - attention_mask.to(torch.float32))[:, None, :] * -1e9
    return full.contiguous()


def fused_encoder_attention2d(
    q: torch.Tensor,  # (b*s, h) row-major
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    seq: int,
    attention_mask: Optional[torch.Tensor] = None,  # (b, s) {0,1} key padding
) -> torch.Tensor:
    """Multi-head attention over (b*s, h) ``q``, ``k``, ``v`` with the HF
    additive -1e9 key mask; returns the (b*s, h) context in ``q.dtype``. A
    query whose keys are all masked (batch padding) gets exactly 0. Launches
    K-attn on a CUDA stream, runs its plain version on a CPU one."""

    out = _attention2d(kernels.attention_separate, q, k, v, num_heads, seq, attention_mask)
    if q.device.type == "cuda":
        kernels.count_launch("B12")
    return out


def fused_encoder_attention2d_plain(q, k, v, num_heads, seq, attention_mask=None):
    """The same attention in plain torch on any device."""

    return _attention2d(kernels.attention_separate_plain, q, k, v, num_heads, seq,
                        attention_mask)


def _attention2d(mha, q, k, v, num_heads, seq, attention_mask):
    rows, h = q.shape
    if rows % seq:
        raise ValueError(f"rows {rows} not divisible by seq {seq}")
    if h % num_heads:
        raise ValueError(f"hidden {h} not divisible by heads {num_heads}")
    return mha(q, k, v, key_bias(attention_mask, rows // seq, seq, q.device), num_heads, seq)
