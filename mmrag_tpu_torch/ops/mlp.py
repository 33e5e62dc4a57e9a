"""MLP blocks of the encoder layers: the pre-LN CLIP block (B3)
``x + FC2(quick_gelu(FC1(LN(x))))`` and its W8A8 form (B7).

Port of ``mmrag_tpu/ops/mlp.py::fused_mlp_block``, whose Pallas kernel
``_mlp_kernel`` kept LN, both products, the activation and the residual in
VMEM. Here it is a composition of the port's hand-written kernels
(``ops/kernels.py``): K-ln -> K-gemm (fc1 + bias + quick_gelu in f32, cast to
x.dtype) -> K-gemm (fc2 + bias + f32 residual). The rounding points are the
JAX kernel's.

In this first form the (rows, 3072) inner activation goes through device
memory (44 MB written and read again at 7168 rows in bf16), where the TPU
kept it on chip; fusing fc1 and fc2 so the inner tile stays in shared
memory is the first performance item for B3 (ROADMAP). There is no
weight-budget fallback: the f32 form runs the same kernels.

:func:`fused_mlp_block_q8` ports ``fused_mlp_block_q8`` (Pallas
``_mlp_kernel_q8``, ``TPU_ENCODER_QUANT=int8``): K-quant (after the f32 LN
for pre-LN, of the f32 stream for post-LN) -> K-gemm-i8 (fc1, dequant + bias
+ activation in f32, written f32) -> K-quant of the inner activation ->
K-gemm-i8 (fc2, dequant + bias + f32 residual) -> [post-LN: K-ln]. The
inner activation's row scale spans all its 1536 or 3072 columns, which one
N-tile of fc1's epilogue cannot see without a reduction across blocks, so
this first form writes the f32 inner activation and quantizes it in a pass
of its own.
"""

from __future__ import annotations

from typing import Mapping

import torch

from . import kernels


def fused_mlp_block(x: torch.Tensor, layer: Mapping, eps: float) -> torch.Tensor:
    """``x + FC2(quick_gelu(FC1(LN2(x))))`` over a 2-D (rows, h) stream, in
    ``x.dtype``. ``layer`` holds ``ln2``, ``fc1`` and ``fc2`` (kernels (in,
    out) in the stream dtype, biases and LN f32). Launches the kernels on a
    CUDA stream, runs their plain versions on a CPU one."""

    out = _mlp_block(kernels.DISPATCH, x, layer, eps)
    if x.device.type == "cuda":
        kernels.count_launch("B3")
    return out


def fused_mlp_block_plain(x: torch.Tensor, layer: Mapping, eps: float) -> torch.Tensor:
    """The same composition in plain torch on any device."""

    return _mlp_block(kernels.PLAIN, x, layer, eps)


def _mlp_block(k, x, layer, eps):
    ln = layer["ln2"]
    y = k.layer_norm(x, None, ln["scale"], ln["bias"], eps, x.dtype)
    inner = k.gemm(y, layer["fc1"]["kernel"], layer["fc1"]["bias"], epi="quick_gelu")
    return k.gemm(inner, layer["fc2"]["kernel"], layer["fc2"]["bias"], residual=x)


def fused_mlp_block_q8(
    x: torch.Tensor,  # (rows, h) residual stream
    qlayer: Mapping,  # ops/quant.py::quantize_encoder_layer output
    eps: float,
    pre_ln: bool = True,
    act: str = "quick_gelu",
    k1: str = "fc1",
    k2: str = "fc2",
    ln_key: str = "ln2",
) -> torch.Tensor:
    """W8A8 MLP block in ``x.dtype``: ``x + FC2(act(FC1(LN(x))))`` pre-LN
    (CLIP, the defaults) or ``LN(x + FC2(act(FC1(x))))`` post-LN (BERT:
    ``pre_ln=False, act="gelu_tanh" | "gelu_erf", k1="ffn_in",
    k2="ffn_out", ln_key="ffn_ln"``). Launches the kernels on a CUDA stream,
    runs their plain versions on a CPU one."""

    out = _mlp_block_q8(kernels.DISPATCH, x, qlayer, eps, pre_ln, act, k1, k2, ln_key)
    if x.device.type == "cuda":
        kernels.count_launch("B7")
    return out


def fused_mlp_block_q8_plain(x, qlayer, eps, pre_ln=True, act="quick_gelu", k1="fc1",
                             k2="fc2", ln_key="ln2"):
    """The same composition in plain torch on any device."""

    return _mlp_block_q8(kernels.PLAIN, x, qlayer, eps, pre_ln, act, k1, k2, ln_key)


def _mlp_block_q8(k, x, qlayer, eps, pre_ln, act, k1, k2, ln_key):
    ln, w1, w2 = qlayer[ln_key], qlayer[k1], qlayer[k2]
    if pre_ln:
        aq, ascale = k.row_quant(x, ln["scale"], ln["bias"], eps)
    else:
        aq, ascale = k.row_quant(x)
    inner = k.gemm_i8(aq, ascale, w1["q"], w1["scale"], w1["bias"], epi=act,
                      out_dtype=torch.float32)
    iq, iscale = k.row_quant(inner)
    if pre_ln:
        return k.gemm_i8(iq, iscale, w2["q"], w2["scale"], w2["bias"], residual=x,
                         out_dtype=x.dtype)
    y = k.gemm_i8(iq, iscale, w2["q"], w2["scale"], w2["bias"], residual=x,
                  out_dtype=torch.float32)
    return k.layer_norm(y, None, ln["scale"], ln["bias"], eps, x.dtype)
