"""The yardstick's arithmetic: published peaks, operations and bytes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
full 700 W: 989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s float32 off the
tensor cores, 3.35 TB/s of HBM. :func:`bound` is ``chip_smoke.py``'s roofline
(the larger of the operations' and the bytes' least time), copied here so
that a change to the program cannot change the yardstick.

Operation counts are of what the inputs need: a product of (m, k) by (k, n)
is ``2 m k n``; an encoder step is counted at each sequence's real tokens
(no padding rows or positions); causal attention counts the lower triangle.
"""

from __future__ import annotations

from typing import Dict, Sequence

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def bound(flops: float, nbytes: float, bf16: bool = True) -> float:
    """Least time in seconds: the products at the bf16 (or float32) peak,
    or the bytes at the HBM's rate, whichever is longer."""

    return max(flops / (BF16_FLOPS if bf16 else F32_FLOPS), nbytes / HBM_BYTES)


def encoder_linear_flops(tokens: int, layers: int, h: int, inter: int) -> float:
    """The four projections and the two FFN products of ``layers`` blocks."""

    return 2.0 * tokens * layers * (4 * h * h + 2 * h * inter)


def attention_flops(lengths: Sequence[int], layers: int, h: int, causal: bool = False) -> float:
    """Scores and context: ``2 * 2 * pairs * h`` a layer."""

    pairs = sum(n * (n + 1) / 2 if causal else n * n for n in lengths)
    return 4.0 * pairs * h * layers


def bert_step(lengths: Sequence[int], m: Dict) -> Dict[str, float]:
    """``{"attention": ..., "linear": ...}``: a BERT pass over sequences of these
    real lengths; ``linear`` is the part a W8A8 tower runs in int8."""

    tokens = sum(lengths)
    lin = encoder_linear_flops(tokens, m["num_hidden_layers"], m["hidden_size"],
                               m["intermediate_size"])
    att = attention_flops(lengths, m["num_hidden_layers"], m["hidden_size"])
    return {"linear": lin, "attention": att}


def clip_text_step(lengths: Sequence[int], m: Dict) -> float:
    t = m["text_config"]
    tokens = sum(lengths)
    return (encoder_linear_flops(tokens, t["num_hidden_layers"], t["hidden_size"],
                                 t["intermediate_size"])
            + attention_flops(lengths, t["num_hidden_layers"], t["hidden_size"], causal=True)
            + 2.0 * len(lengths) * t["hidden_size"] * m["projection_dim"])


def search_flops(queries: int, rows: int, dim: int) -> float:
    return 2.0 * queries * rows * dim


def least_time(flops_float: float, flops_int8: float) -> float:
    """A step's least time: float products at the bf16 peak, W8A8's int8
    products at the int8 peak."""

    return flops_float / BF16_FLOPS + flops_int8 / INT8_OPS


def kbmax_bound(q: int, n: int, d: int, elem: int, mask_bytes: int, out_bytes: int) -> float:
    """K-bmax: the corpus, the mask and the queries read once, the bucket
    maxima written once; ``2 q n d`` products at the bf16 peak."""

    nbytes = n * d * elem + mask_bytes + q * d * 4 + out_bytes
    return bound(2.0 * q * n * d, nbytes, bf16=elem == 2)


def gemm_bound(m: int, k: int, n: int, elem: int, out_elem: int, residual: bool) -> float:
    """K-gemm: ``a`` and ``w`` read once, the bias, the residual and the
    output once; ``2 m k n`` products."""

    nbytes = (m * k + k * n) * elem + n * 4 + m * n * out_elem + (m * n * elem if residual else 0)
    return bound(2.0 * m * k * n, nbytes, bf16=elem == 2)
