"""W8A8 dynamic quantization of the encoder towers (``TPU_ENCODER_QUANT=int8``).

Port of ``mmrag_tpu/ops/quant.py``: the port's own copy of the scheme, with
the same f32 formulas, shared by the int8 blocks B6
(:func:`mmrag_tpu_torch.ops.attention.fused_attention_block_q8`) and B7
(:func:`mmrag_tpu_torch.ops.mlp.fused_mlp_block_q8`):

* **Weights**: per-output-channel symmetric int8, ``q[i, o] = round(w[i, o] /
  s_o)`` with ``s_o = max(max_i |w[i, o]| * (1/127), 1e-12)``, quantized once
  from the f32 weights at model load. Scales are per column, so the port's
  fused (h, 3h) q|k|v kernel quantizes to exactly the JAX package's three
  sets of codes and scales side by side.
* **Activations**: per-row symmetric int8 with the same formula, computed on
  the card by K-quant (``csrc/layernorm.cu``) right after the f32 LayerNorm
  (pre-LN) or on the f32 stream (post-LN). A product dequantizes with
  ``((acc * row_scale) * col_scale) + bias`` in f32.

``torch.round`` rounds halves to even, as ``jnp.round`` does, and ``a / scale``
is a true division: the codes are those of the JAX package bit for bit.
Everything here is plain torch; :func:`q8_dense` sums the int8 products
exactly in f64 so that it runs on either device.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

Params = Dict[str, object]

# quantized linear: {"q": int8 (in, out) stored N x K, "scale": f32 (out,), "bias": f32 (out,)}


def quantize_rows(a: torch.Tensor):
    """Per-row symmetric int8: ``(q, scale)`` with ``a ~= q * scale``;
    ``scale`` is (rows, 1) f32. Safe for all-zero rows (scale 1e-12, q 0)."""

    a = a.float()
    scale = (a.abs().amax(-1, keepdim=True) * (1.0 / 127.0)).clamp_min(1e-12)
    q = torch.round(a / scale).to(torch.int8)
    return q, scale


def quantize_weight(kernel: torch.Tensor) -> Params:
    """Per-output-channel symmetric int8 of an (in, out) dense kernel; the
    scale is (out,) f32.

    ``q`` is the logical (in, out) matrix, stored N x K: the (in, out) view
    of an (out, in) contiguous buffer, strides (1, in). K-gemm-i8's ``wgmma``
    reads int8 operands K-major only (and ``torch._int_mm`` wants the same
    layout); ``.to(device)`` keeps it, and the plain forms index ``q`` as
    (in, out) whatever its strides."""

    w = kernel.float()
    scale = (w.abs().amax(0) * (1.0 / 127.0)).clamp_min(1e-12)
    q = torch.round(w / scale).to(torch.int8)
    return {"q": q.t().contiguous().t(), "scale": scale}


def quantize_linear(p: Params) -> Params:
    """One dense layer ``{"kernel", "bias"?}`` -> ``{"q", "scale", "bias"}``."""

    out = quantize_weight(p["kernel"])
    if "bias" in p:
        out["bias"] = p["bias"].float().reshape(-1)
    else:
        out["bias"] = torch.zeros(out["q"].shape[1], dtype=torch.float32,
                                  device=out["q"].device)
    return out


def quantize_encoder_layer(layer: Params, linears: Iterable[str]) -> Params:
    """Quantize the named dense sublayers of one encoder block; LayerNorms
    and any other entries are carried through unchanged."""

    linears = tuple(linears)
    return {key: quantize_linear(val) if key in linears else val for key, val in layer.items()}


def quantize_encoder_layers(layers, linears: Iterable[str]):
    """:func:`quantize_encoder_layer` over a tower's blocks."""

    linears = tuple(linears)
    return [quantize_encoder_layer(layer, linears) for layer in layers]


def q8_dense(aq: torch.Tensor, row_scale: torch.Tensor, qlin: Params) -> torch.Tensor:
    """f32 output of a quantized dense: ``((aq @ q) * row_scale) * scale +
    bias`` with ``row_scale`` (rows, 1); the int8 products are summed exactly
    in f64 (exact for any K below 2^53 / 127^2), then rounded to f32 as the
    int32 sum would be."""

    acc = (aq.double() @ qlin["q"].double()).float()
    return acc * row_scale * qlin["scale"] + qlin["bias"]
