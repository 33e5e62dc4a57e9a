#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmrag_tpu_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name
   and power limit);
2. builds the hand-written kernels from ``mmrag_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and prints the build time and the
   compiler's register / spill report;
3. holds each ported TPU kernel (B1-B11) against its plain PyTorch version on
   the card at the main path's shapes in bf16 (B9: int8), then once in f32,
   and times the kernel, the plain version and one PyTorch library
   composition computing the same function (CUDA events, median of 25 runs
   after warm-up), beside the least time the card could take (``bound_ms``);
4. drives the main path at full width (MiniLM-L6, the ms-marco MiniLM-L-6
   cross-encoder, CLIP ViT-B/32; seeded weights unless ``WEIGHTS_DIR`` holds
   converted ones) twice, each pass with the launch counts set to 0 just
   before it and read just after: the default (bf16) engine, and a
   ``TPU_ENCODER_QUANT=int8`` engine whose MiniLM, cross-encoder and CLIP
   vision blocks are W8A8. Each pass ingests text chunks for two tenants and
   seeded images, fills its indexes (bf16 pass: 1,048,576 text and 131,072
   image rows; int8 pass: 262,144 and 65,536), then runs 16 coalesced chat
   queries through ``retrieve_batch`` and 4 single ``retrieve`` calls; and
   checks the card's embeddings and rerank scores against the port on the
   CPU in f32, and the int8 towers against the bf16 ones;
5. drives the partitioned and compressed index layouts, each with the launch
   counts set to 0 just before it and read just after: three passes on
   ``VectorIndex`` at 1,048,576 x 384 (``ivf`` over bf16: B8; ``ivf`` over
   int8: B9; flat ``pq``: B10 + B11), each filled with topic-structured rows
   for three tenants, built synchronously, given a 4096-row append tail and
   searched (16 coalesced + 4 single) with isolation and recall@10 checks
   against the exact search; then the IVF_PQ engine pass
   (``TPU_TOPK_BACKEND=ivf``, ``TPU_INDEX_DTYPE=pq``, the bf16 pass's
   runtime) over 1,048,576 text and 131,072 image rows, served as in 4;
6. prints the kernel table as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Every phase raises on failure, so any fault exits non-zero before the last
line. Without CUDA it exits 2 and prints no result. ``--profile`` adds, in each
pass, one ``torch.profiler`` window over a coalesced ``retrieve_batch`` (device time by
kernel, device idle share); ``--kernels-only`` stops after step 3.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, same sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES = 3.35e12  # HBM3 bytes/s
REPEATS = 25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median of per-call CUDA-event times after two warm-up calls."""

    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(flops: float, nbytes: float, bf16: bool, int8_ops: float = 0.0):
    """The larger of the operations' and the bytes' least times (ms): float
    ``flops`` at the bf16 or f32 peak plus ``int8_ops`` at the int8 peak."""

    t_ops = (flops / (H100_BF16_FLOPS if bf16 else H100_F32_FLOPS)
             + int8_ops / H100_INT8_OPS) * 1e3
    t_bytes = nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def _layer(gen, h: int, inter: int, dtype, dev, std: float = 0.05):
    import torch

    def mat(i, o, s=std):
        return (torch.randn((i, o), generator=gen) * s).to(dev, dtype)

    def vec(n, s=0.02, mean=0.0):
        return (torch.randn((n,), generator=gen) * s + mean).to(dev)

    return {
        "qkv": {"kernel": mat(h, 3 * h), "bias": vec(3 * h)},
        "attn_out": {"kernel": mat(h, h), "bias": vec(h)},
        "attn_ln": {"scale": vec(h, 0.1, 1.0), "bias": vec(h)},
        "ln1": {"scale": vec(h, 0.1, 1.0), "bias": vec(h)},
        "ln2": {"scale": vec(h, 0.1, 1.0), "bias": vec(h)},
        "fc1": {"kernel": mat(h, inter, 0.03), "bias": vec(inter)},
        "fc2": {"kernel": mat(inter, h, 0.03), "bias": vec(h)},
    }


def _ln_ok(got, want, bf16: bool):
    diff = (got.float() - want.float()).abs()
    max_abs, mean_abs = float(diff.max()), float(diff.mean())
    if bf16:
        ok = max_abs <= 5e-2 and mean_abs <= 5e-3
    else:
        ok = max_abs <= 1e-3
    return ok, max_abs, mean_abs


def _resid_ok(got, want, x, bf16: bool):
    diff = (got.float() - want.float()).abs()
    max_abs = float(diff.max())
    scale = float(x.float().abs().max())
    tol = (1e-2 if bf16 else 1e-4) * scale
    return max_abs <= tol, max_abs, float(diff.mean())


def phase_b1(case, dtype, seed: int):
    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops.attention import (
        fused_attention_block, fused_attention_block_plain,
    )

    b, s, h, nh, pre_ln = case
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    layer = _layer(gen, h, 4 * h, dtype, dev)
    x = torch.randn((b * s, h), generator=gen).to(dev, dtype)
    lengths = torch.randint(s // 4, s + 1, (b,), generator=gen)
    if pre_ln:  # CLIP: 50 real tokens of the 56-token padded rows
        lengths[:] = min(50, s)
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
    ln_key = "ln1" if pre_ln else "attn_ln"
    eps = 1e-5 if pre_ln else 1e-12
    args = (x, layer, nh, s, eps, mask, pre_ln, ln_key)
    got = fused_attention_block(*args)
    want = fused_attention_block_plain(*args)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    real = mask.reshape(-1).bool()
    if pre_ln:
        ok, max_abs, mean_abs = _resid_ok(got[real], want[real], x, bf16)
    else:
        ok, max_abs, mean_abs = _ln_ok(got[real], want[real], bf16)
    ln = layer[ln_key]
    wqkv, bqkv = layer["qkv"]["kernel"], layer["qkv"]["bias"]
    wo, bo = layer["attn_out"]["kernel"], layer["attn_out"]["bias"]
    attn_mask = mask.bool()[:, None, None, :]

    def library():
        a = F.layer_norm(x, (h,), ln["scale"].to(dtype), ln["bias"].to(dtype), eps) if pre_ln else x
        qkv = F.linear(a, wqkv.T, bqkv.to(dtype)).reshape(b, s, 3, nh, h // nh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        y = x + F.linear(ctx.transpose(1, 2).reshape(b * s, h), wo.T, bo.to(dtype))
        return y if pre_ln else F.layer_norm(y, (h,), ln["scale"].to(dtype), ln["bias"].to(dtype), eps)

    rows = b * s
    flops = 8 * rows * h * h + 4 * rows * s * h
    item = x.element_size()
    # x in, out written, the four projections, the int32 mask, f32 biases + LN
    nbytes = 2 * rows * h * item + 4 * h * h * item + b * s * 4 + 6 * h * 4
    bms, by = bound(flops, nbytes, bf16)
    return {
        "kernel": "B1", "shape": f"{b}x{s} h{h} {'pre' if pre_ln else 'post'}-LN",
        "dtype": str(dtype).split(".")[-1], "ok": ok, "max_abs_err": max_abs,
        "mean_abs_err": mean_abs,
        "kernel_ms": time_ms(lambda: fused_attention_block(*args)),
        "plain_ms": time_ms(lambda: fused_attention_block_plain(*args)),
        "library_ms": time_ms(library),
        "bound_ms": bms, "bound_by": by,
    }


def phase_b2(rows: int, h: int, dtype, seed: int):
    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.layernorm import fused_add_layer_norm

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, h), generator=gen).to(dev, dtype)
    d = (torch.randn((rows, h), generator=gen) * 0.5).to(dev, dtype)
    scale = (torch.randn((h,), generator=gen) * 0.1 + 1).to(dev)
    bias = (torch.randn((h,), generator=gen) * 0.02).to(dev)
    args = (x, d, scale, bias, 1e-12, dtype)
    got = fused_add_layer_norm(*args)
    want = kernels.layer_norm_plain(*args)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    ok, max_abs, mean_abs = _ln_ok(got, want, bf16)
    item = x.element_size()
    bms, by = bound(10 * rows * h, 3 * rows * h * item + 8 * h, bf16)
    sd, bd = scale.to(dtype), bias.to(dtype)
    return {
        "kernel": "B2", "shape": f"{rows}x{h}", "dtype": str(dtype).split(".")[-1],
        "ok": ok, "max_abs_err": max_abs, "mean_abs_err": mean_abs,
        "kernel_ms": time_ms(lambda: fused_add_layer_norm(*args)),
        "plain_ms": time_ms(lambda: kernels.layer_norm_plain(*args)),
        "library_ms": time_ms(lambda: F.layer_norm(x + d, (h,), sd, bd, 1e-12)),
        "bound_ms": bms, "bound_by": by,
    }


def phase_b3(rows: int, h: int, inter: int, dtype, seed: int):
    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops.mlp import fused_mlp_block, fused_mlp_block_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    layer = _layer(gen, h, inter, dtype, dev)
    x = torch.randn((rows, h), generator=gen).to(dev, dtype)
    got = fused_mlp_block(x, layer, 1e-5)
    want = fused_mlp_block_plain(x, layer, 1e-5)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    ok, max_abs, mean_abs = _resid_ok(got, want, x, bf16)
    ln, w1, w2 = layer["ln2"], layer["fc1"], layer["fc2"]

    def library():
        y = F.layer_norm(x, (h,), ln["scale"].to(dtype), ln["bias"].to(dtype), 1e-5)
        i = F.linear(y, w1["kernel"].T, w1["bias"].to(dtype))
        i = i * torch.sigmoid(1.702 * i)
        return x + F.linear(i, w2["kernel"].T, w2["bias"].to(dtype))

    item = x.element_size()
    nbytes = 2 * rows * h * item + 2 * h * inter * item + (inter + 3 * h) * 4
    bms, by = bound(4 * rows * h * inter, nbytes, bf16)
    return {
        "kernel": "B3", "shape": f"{rows}x{h}->{inter}", "dtype": str(dtype).split(".")[-1],
        "ok": ok, "max_abs_err": max_abs, "mean_abs_err": mean_abs,
        "kernel_ms": time_ms(lambda: fused_mlp_block(x, layer, 1e-5)),
        "plain_ms": time_ms(lambda: fused_mlp_block_plain(x, layer, 1e-5)),
        "library_ms": time_ms(library),
        "bound_ms": bms, "bound_by": by,
    }


def phase_b4(n: int, d: int, q: int, per_query: bool, dtype, seed: int, k: int = 50):
    import torch

    from mmrag_tpu_torch.ops.pallas_topk import fused_cosine_topk, fused_cosine_topk_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    corpus = torch.randn((n, d), generator=gen, device=dev)
    corpus = (corpus / corpus.norm(dim=1, keepdim=True)).to(dtype)
    queries = torch.randn((q, d), generator=gen, device=dev)
    queries = queries / queries.norm(dim=1, keepdim=True)
    tenants = torch.randint(0, 3, (n,), generator=gen, device=dev)
    if per_query:
        mask = tenants[None, :] == (torch.arange(q, device=dev) % 3)[:, None]
    else:
        mask = tenants == 0
    got_s, got_i = fused_cosine_topk(queries, corpus, mask, k)
    want_s, want_i = fused_cosine_topk_plain(queries, corpus, mask, k)
    torch.cuda.synchronize()
    max_abs = float((got_s - want_s).abs().max())
    # same ids except at ties: where ids differ, the scores must be near-equal
    differ = got_i != want_i
    tie_ok = bool(((got_s - want_s).abs()[differ] < 1e-3).all()) if bool(differ.any()) else True
    ok = max_abs <= 1e-3 and tie_ok
    bias = torch.where(mask, 0.0, -1e30).float()
    if bias.ndim == 1:
        bias = bias[None, :]

    def library():
        return torch.topk(queries.to(dtype) @ corpus.T + bias, k, dim=-1)

    # the function's inputs read once (corpus, bool mask, f32 queries) and its
    # (q, k) scores and ids written once
    nbytes = corpus.numel() * corpus.element_size() + mask.numel() + q * d * 4 + 2 * q * k * 4
    bms, by = bound(2 * q * n * d, nbytes, dtype == torch.bfloat16)
    return {
        "kernel": "B4", "shape": f"{n}x{d} q{q} {'per-query' if per_query else 'shared'} mask",
        "dtype": str(dtype).split(".")[-1], "ok": ok, "max_abs_err": max_abs,
        "ids_differ": int(differ.sum()),
        "kernel_ms": time_ms(lambda: fused_cosine_topk(queries, corpus, mask, k)),
        "plain_ms": time_ms(lambda: fused_cosine_topk_plain(queries, corpus, mask, k)),
        "library_ms": time_ms(library),
        "bound_ms": bms, "bound_by": by,
    }


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


def _q8_ok(got, want, x, bf16: bool, pre_ln: bool):
    """B6/B7 kernel vs plain: both round the same int8 codes, but an input
    summed in another order (LN statistics, the attention context) may sit
    within an ulp of a code boundary and take the next code; one code moves
    an output by about amax/127 of its row times a weight, and a flip in a
    first product's input moves the second product's input row and may flip
    more codes there. Within 1e-2 of the output's scale at most and 5e-5 on
    average (a few flips in a block, no systematic error), plus 2 bf16 ulps
    at most and 1 on average for a bf16 stream (the tolerance of
    tests/test_torch_cuda.py)."""

    diff = (got.float() - want.float()).abs()
    max_abs, mean_abs = float(diff.max()), float(diff.mean())
    scale = float(x.float().abs().max()) if pre_ln else 4.0
    ulp = 2 ** -8 if bf16 else 0.0
    ok = max_abs <= (2 * ulp + 1e-2) * scale and mean_abs <= (ulp + 5e-5) * scale
    return ok, max_abs, mean_abs


def _q8_layer(gen, h: int, inter: int, dev):
    """A seeded f32 layer, quantized on the CPU as the runtime quantizes."""

    import torch

    from mmrag_tpu_torch.ops import quant

    layer = _layer(gen, h, inter, torch.float32, torch.device("cpu"))
    q8 = quant.quantize_encoder_layer(layer, ("qkv", "attn_out", "fc1", "fc2"))
    return layer, {k: {kk: vv.to(dev) for kk, vv in v.items()} for k, v in q8.items()}


def _lib_quant(a):
    """Per-row int8 of f32 rows with PyTorch ops (the library yardstick's)."""

    import torch

    scale = (a.abs().amax(-1, keepdim=True) * (1.0 / 127.0)).clamp_min(1e-12)
    return torch.round(a / scale).to(torch.int8), scale


def phase_b5(b: int, s: int, h: int, nh: int, dtype, seed: int):
    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops.attention import (
        fused_encoder_attention, fused_encoder_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h), generator=gen).to(dev, dtype)
    q, k, v = qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:]  # the tower's views
    lengths = torch.randint(2, s + 1, (b,), generator=gen)
    causal = torch.triu(torch.full((s, s), -1e9), diagonal=1)
    pad = (1.0 - (torch.arange(s)[None, :] < lengths[:, None]).float())[:, None, :] * -1e9
    bias = (causal[None] + pad).to(dev).contiguous()
    got = fused_encoder_attention(q, k, v, nh, bias=bias)
    want = fused_encoder_attention_plain(q, k, v, nh, bias=bias)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    ok, max_abs, mean_abs = _ln_ok(got, want, bf16)
    hd = h // nh
    mask4 = bias[:, None].to(dtype)

    def library():
        def heads(t):
            return t.reshape(b, s, nh, hd).transpose(1, 2)

        ctx = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask4)
        return ctx.transpose(1, 2).reshape(b, s, h)

    item = qkv.element_size()
    # q, k, v read once, the context written once, the f32 (b, s, s) bias
    nbytes = 4 * b * s * h * item + b * s * s * 4
    bms, by = bound(4 * b * s * s * h, nbytes, bf16)
    return {
        "kernel": "B5", "shape": f"{b}x{s}x{h} causal+pad", "dtype": _dt(dtype), "ok": ok,
        "max_abs_err": max_abs, "mean_abs_err": mean_abs,
        "kernel_ms": time_ms(lambda: fused_encoder_attention(q, k, v, nh, bias=bias)),
        "plain_ms": time_ms(lambda: fused_encoder_attention_plain(q, k, v, nh, bias=bias)),
        "library_ms": time_ms(library), "bound_ms": bms, "bound_by": by,
    }


def phase_b6(case, dtype, seed: int):
    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops.attention import (
        fused_attention_block, fused_attention_block_q8, fused_attention_block_q8_plain,
    )

    b, s, h, nh, pre_ln = case
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    layer, qlayer = _q8_layer(gen, h, 4 * h, dev)
    x = torch.randn((b * s, h), generator=gen).to(dev, dtype)
    lengths = torch.randint(s // 4, s + 1, (b,), generator=gen)
    if pre_ln:  # CLIP: 50 real tokens of the 56-token padded rows
        lengths[:] = min(50, s)
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
    ln_key = "ln1" if pre_ln else "attn_ln"
    eps = 1e-5 if pre_ln else 1e-12
    args = (x, qlayer, nh, s, eps, mask, pre_ln, ln_key)
    got = fused_attention_block_q8(*args)
    want = fused_attention_block_q8_plain(*args)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    real = mask.reshape(-1).bool()
    ok, max_abs, mean_abs = _q8_ok(got[real], want[real], x, bf16, pre_ln)
    ln, wqkv, wo = qlayer[ln_key], qlayer["qkv"], qlayer["attn_out"]
    # torch._int_mm takes the int8 weight column-major
    wqkv_t, wo_t = wqkv["q"].t().contiguous().t(), wo["q"].t().contiguous().t()
    attn_mask = mask.bool()[:, None, None, :]
    hd = h // nh

    def library():
        a = F.layer_norm(x.float(), (h,), ln["scale"], ln["bias"], eps) if pre_ln else x.float()
        aq, asc = _lib_quant(a)
        qkv = (torch._int_mm(aq, wqkv_t).float() * asc * wqkv["scale"] + wqkv["bias"]).to(dtype)
        qkv = qkv.reshape(b, s, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        cq, csc = _lib_quant(ctx.transpose(1, 2).reshape(b * s, h).float())
        y = x.float() + torch._int_mm(cq, wo_t).float() * csc * wo["scale"] + wo["bias"]
        if not pre_ln:
            y = F.layer_norm(y, (h,), ln["scale"], ln["bias"], eps)
        return y.to(dtype)

    # the same block in bf16 through B1, for comparison (not held to it)
    b1_layer = {k: {kk: (vv.to(dev, dtype) if kk == "kernel" else vv.to(dev))
                    for kk, vv in v.items()} for k, v in layer.items()}
    b1_args = (x, b1_layer, nh, s, eps, mask, pre_ln, ln_key)
    rows = b * s
    item = x.element_size()
    # x in, out written, four int8 (h, h) weights, their f32 scales and biases,
    # the LN, the int32 mask
    nbytes = 2 * rows * h * item + 4 * h * h + 10 * h * 4 + b * s * 4
    bms, by = bound(4 * rows * s * h, nbytes, bf16, int8_ops=8 * rows * h * h)
    return {
        "kernel": "B6", "shape": f"{b}x{s} h{h} {'pre' if pre_ln else 'post'}-LN",
        "dtype": _dt(dtype), "ok": ok, "max_abs_err": max_abs, "mean_abs_err": mean_abs,
        "kernel_ms": time_ms(lambda: fused_attention_block_q8(*args)),
        "plain_ms": time_ms(lambda: fused_attention_block_q8_plain(*args)),
        "library_ms": time_ms(library), "bound_ms": bms, "bound_by": by,
        "b1_ms_same_shape": time_ms(lambda: fused_attention_block(*b1_args)),
    }


def phase_b7(rows: int, h: int, inter: int, pre_ln: bool, act: str, dtype, seed: int):
    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.mlp import (
        fused_mlp_block, fused_mlp_block_q8, fused_mlp_block_q8_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    layer, qlayer = _q8_layer(gen, h, inter, dev)
    x = torch.randn((rows, h), generator=gen).to(dev, dtype)
    eps = 1e-5 if pre_ln else 1e-12
    args = (x, qlayer, eps, pre_ln, act)
    got = fused_mlp_block_q8(*args)
    want = fused_mlp_block_q8_plain(*args)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    ok, max_abs, mean_abs = _q8_ok(got, want, x, bf16, pre_ln)
    ln, w1, w2 = qlayer["ln2"], qlayer["fc1"], qlayer["fc2"]
    w1_t, w2_t = w1["q"].t().contiguous().t(), w2["q"].t().contiguous().t()

    def library():
        y = x.float()
        a = F.layer_norm(y, (h,), ln["scale"], ln["bias"], eps) if pre_ln else y
        aq, asc = _lib_quant(a)
        i = kernels.activation_plain(
            torch._int_mm(aq, w1_t).float() * asc * w1["scale"] + w1["bias"], act)
        iq, isc = _lib_quant(i)
        o = y + torch._int_mm(iq, w2_t).float() * isc * w2["scale"] + w2["bias"]
        if not pre_ln:
            o = F.layer_norm(o, (h,), ln["scale"], ln["bias"], eps)
        return o.to(dtype)

    b3_layer = {k: {kk: (vv.to(dev, dtype) if kk == "kernel" else vv.to(dev))
                    for kk, vv in v.items()} for k, v in layer.items()}
    item = x.element_size()
    nbytes = 2 * rows * h * item + 2 * h * inter + (2 * inter + 4 * h) * 4
    bms, by = bound(0.0, nbytes, bf16, int8_ops=4 * rows * h * inter)
    return {
        "kernel": "B7", "shape": f"{rows}x{h}->{inter} {'pre' if pre_ln else 'post'}-LN {act}",
        "dtype": _dt(dtype), "ok": ok, "max_abs_err": max_abs, "mean_abs_err": mean_abs,
        "kernel_ms": time_ms(lambda: fused_mlp_block_q8(*args)),
        "plain_ms": time_ms(lambda: fused_mlp_block_q8_plain(*args)),
        "library_ms": time_ms(library), "bound_ms": bms, "bound_by": by,
        "b3_ms_same_shape": time_ms(lambda: fused_mlp_block(x, b3_layer, eps)),
    }


def _probe_inputs(gen, C: int, B: int, q: int, nprobe: int, dev):
    """Predicate planes for three tenants and five documents, a tenth of the
    slots dead, distinct probes per query; query 5 filters on a document."""

    import torch

    planes = (
        torch.arange(C * B, dtype=torch.int32, device=dev).reshape(C, 1, B),
        torch.randint(0, 3, (C, 1, B), generator=gen, device=dev, dtype=torch.int32),
        torch.randint(0, 5, (C, 1, B), generator=gen, device=dev, dtype=torch.int32),
        (torch.rand((C, 1, B), generator=gen, device=dev) > 0.1).to(torch.int32),
    )
    probes = torch.rand((q, C), generator=gen, device=dev).topk(nprobe, dim=1).indices
    uids = (torch.arange(q, device=dev) % 3).to(torch.int32)
    dids = torch.full((q,), -1, dtype=torch.int32, device=dev)
    dids[min(5, q - 1)] = 2
    return planes, probes.to(torch.int32).contiguous(), uids, dids


def _probe_library(buckets, planes, probes, uids, dids, q_in, scale=None, neg=-1e30):
    """A gather of the probed blocks + torch.bmm + torch.where (library
    yardstick of B8/B9; the int8 blocks cast to bf16 first)."""

    import torch

    from mmrag_tpu_torch.ops.topk import predicate_mask

    q, nprobe = probes.shape
    pl = probes.long()
    sub = buckets[pl].reshape(q, -1, buckets.shape[2])
    if sub.dtype == torch.int8:
        sub = sub.to(torch.bfloat16)
    s = torch.bmm(sub, q_in.to(sub.dtype)[:, :, None])[:, :, 0].float()
    if scale is not None:
        s = s * scale[pl].reshape(q, -1)
    ids, users, docs, live = (p[pl].reshape(q, -1) for p in planes)
    valid = predicate_mask(users, docs, live, uids[:, None], dids[:, None])
    return torch.where(valid, s, neg), ids


def _probed_blocks(probes) -> int:
    """Distinct clusters this run's queries probe: a block that several
    queries probe need be read once."""

    return int(probes.unique().numel())


def phase_b8(C: int, B: int, d: int, q: int, nprobe: int, dtype, seed: int):
    import torch

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.ivf import pallas_probe_scores

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    buckets = torch.randn((C, B, d), generator=gen, device=dev)
    buckets = (buckets / buckets.norm(dim=-1, keepdim=True)).to(dtype)
    queries = torch.randn((q, d), generator=gen, device=dev)
    queries = queries / queries.norm(dim=1, keepdim=True)
    planes, probes, uids, dids = _probe_inputs(gen, C, B, q, nprobe, dev)
    args = (queries, buckets, *planes, probes, uids, dids)
    gs, gi = pallas_probe_scores(*args)
    ws, wi = kernels.probe_scores_plain(*args)
    torch.cuda.synchronize()
    max_abs = float((gs - ws).abs().max())
    bf16 = dtype == torch.bfloat16
    tol = 2 ** -8 * float(ws[ws > -1e29].abs().max()) if bf16 else 1e-5
    ok = bool(torch.equal(gi, wi)) and max_abs <= tol
    qd = queries.to(dtype)
    # each distinct probed block read once with its four int32 planes, the
    # queries, probes and predicate ids read; scores and ids written
    blocks = _probed_blocks(probes)
    nbytes = (blocks * B * (d * buckets.element_size() + 16) + q * d * 4
              + q * nprobe * 4 + q * 8 + 2 * q * nprobe * B * 4)
    bms, by = bound(2 * q * nprobe * B * d, nbytes, bf16)
    return {
        "kernel": "B8", "shape": f"q{q} nprobe{nprobe} C{C} B{B} d{d}", "dtype": _dt(dtype),
        "probed_blocks": blocks, "ok": ok, "max_abs_err": max_abs, "tol": tol,
        "kernel_ms": time_ms(lambda: pallas_probe_scores(*args)),
        "plain_ms": time_ms(lambda: kernels.probe_scores_plain(*args)),
        "library_ms": time_ms(lambda: _probe_library(buckets, planes, probes, uids, dids, qd)),
        "bound_ms": bms, "bound_by": by,
    }


def phase_b9(C: int, B: int, d: int, q: int, nprobe: int, seed: int):
    import torch

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.ivf import pallas_probe_scores_q
    from mmrag_tpu_torch.ops.topk import quantize_rows_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn((C * B, d), generator=gen, device=dev)
    bq, bscale = quantize_rows_int8(rows / rows.norm(dim=1, keepdim=True))
    buckets, scales = bq.reshape(C, B, d), bscale.reshape(C, 1, B).contiguous()
    qq, _ = quantize_rows_int8(torch.randn((q, d), generator=gen, device=dev))
    planes, probes, uids, dids = _probe_inputs(gen, C, B, q, nprobe, dev)
    args = (qq, buckets, scales, *planes, probes, uids, dids)
    gs, gi = pallas_probe_scores_q(*args)
    ws, wi = kernels.probe_scores_q_plain(*args)
    ones = torch.ones_like(scales)  # the raw integer dot
    raw_ok = torch.equal(pallas_probe_scores_q(qq, buckets, ones, *args[3:])[0],
                         kernels.probe_scores_q_plain(qq, buckets, ones, *args[3:])[0])
    torch.cuda.synchronize()
    fin = torch.isfinite(ws)
    ok = bool(torch.equal(gi, wi)) and bool(torch.equal(gs, ws)) and bool(raw_ok)
    # as B8's, with int8 blocks, their f32 scale plane and int8 queries
    blocks = _probed_blocks(probes)
    nbytes = blocks * B * (d + 20) + q * d + q * nprobe * 4 + q * 8 + 2 * q * nprobe * B * 4
    bms, by = bound(0.0, nbytes, True, int8_ops=2 * q * nprobe * B * d)
    return {
        "kernel": "B9", "shape": f"q{q} nprobe{nprobe} C{C} B{B} d{d}", "dtype": "int8",
        "probed_blocks": blocks, "ok": ok, "max_abs_err": float((gs[fin] - ws[fin]).abs().max()),
        "raw_bitwise": raw_ok,
        "kernel_ms": time_ms(lambda: pallas_probe_scores_q(*args)),
        "plain_ms": time_ms(lambda: kernels.probe_scores_q_plain(*args)),
        "library_ms": time_ms(lambda: _probe_library(buckets, planes, probes, uids, dids, qq,
                                                     scales, float("-inf"))),
        "bound_ms": bms, "bound_by": by,
    }


def _adc_library(tables, codes_t, bias, bucket: bool):
    """torch.gather of the table entries summed over j, + bias, then (B10)
    the max of each 128-row bucket: the library yardstick of B10/B11.
    ``codes_t`` is (q|1, m, S) lane-major."""

    import torch

    m, q, _ = tables.shape
    tq = tables.permute(1, 0, 2).float()  # (q, m, K)
    idx = (codes_t.long() + 128).expand(q, -1, -1)
    s = torch.gather(tq, 2, idx).sum(1) + bias
    if not bucket:
        return s
    n = s.shape[1]
    pad = -(-n // 128) * 128 - n
    return torch.nn.functional.pad(s, (0, pad), value=-1e30).reshape(q, -1, 128).amax(-1)


def phase_b10(n: int, m: int, q: int, per_query: bool, seed: int):
    import torch

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.pq import _adc_bucket_max_counted

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = (torch.randn((m, q, 256), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    codes = torch.randint(-128, 128, (n, m), generator=gen, device=dev, dtype=torch.int8)
    keep = torch.rand((q if per_query else 1, n), generator=gen, device=dev) > 0.3
    bias = torch.where(keep, 0.0, -1e30).float()
    got = _adc_bucket_max_counted(tables, codes, bias)
    want = kernels.adc_bucket_max_plain(tables, codes, bias)
    torch.cuda.synchronize()
    ok = bool(torch.equal(got, want))
    codes_t = codes.T[None]
    nbytes = n * m + bias.numel() * 4 + tables.numel() * 2 + got.numel() * 4
    bms, by = bound(n * m * q, nbytes, False)  # f32 adds of the looked-up entries
    return {
        "kernel": "B10",
        "shape": f"{n} codes m{m} q{q} {'per-query' if per_query else 'shared'} bias",
        "dtype": "bfloat16", "ok": ok, "max_abs_err": float((got - want).abs().max()),
        "kernel_ms": time_ms(lambda: kernels.adc_bucket_max(tables, codes, bias)),
        "plain_ms": time_ms(lambda: kernels.adc_bucket_max_plain(tables, codes, bias)),
        "library_ms": time_ms(lambda: _adc_library(tables, codes_t, bias, True)),
        "bound_ms": bms, "bound_by": by,
    }


def phase_b11(q: int, m: int, S: int, shared: bool, seed: int):
    import torch

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.pq import adc_rescore_scores

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = (torch.randn((m, q, 256), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    codes = torch.randint(-128, 128, (1 if shared else q, m, S), generator=gen, device=dev,
                          dtype=torch.int8)
    bias = torch.where(torch.rand((q, S), generator=gen, device=dev) > 0.3, 0.0, -1e30).float()
    got = adc_rescore_scores(tables, codes, bias)
    want = kernels.adc_rescore_plain(tables, codes, bias)
    torch.cuda.synchronize()
    ok = bool(torch.equal(got, want))
    nbytes = codes.numel() + 2 * q * S * 4 + tables.numel() * 2
    bms, by = bound(q * S * m, nbytes, False)
    return {
        "kernel": "B11", "shape": f"q{q} m{m} S{S}{' shared' if shared else ''}",
        "dtype": "bfloat16", "ok": ok, "max_abs_err": float((got - want).abs().max()),
        "kernel_ms": time_ms(lambda: kernels.adc_rescore(tables, codes, bias)),
        "plain_ms": time_ms(lambda: kernels.adc_rescore_plain(tables, codes, bias)),
        "library_ms": time_ms(lambda: _adc_library(tables, codes, bias, False)),
        "bound_ms": bms, "bound_by": by,
    }


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

_WORDS = (
    "posture risk assessment computer vision model accuracy warehouse worker lifting "
    "box pipeline retrieval architecture diagram chart results deep learning dataset "
    "camera sensor ergonomics injury prevention training evaluation benchmark latency "
    "throughput index embedding query document image caption video frame transcript"
).split()


def _chunks(rng, n: int, tenant: str):
    nodes = []
    for i in range(n):
        words = rng.choice(_WORDS, size=int(rng.integers(40, 180)))
        nodes.append({
            "id": f"{tenant}-c{i}",
            "text": " ".join(words) + ".",
            "metadata": {"document_id": f"{tenant}-doc{i % 16}", "page": int(i % 40)},
        })
    return nodes


RERANK_TOL_F32 = 1e-4  # f32 kernels vs plain on an H100: <= 1.4e-5 a block
RERANK_TOL_BF16 = 2e-3  # bf16 stream vs f32 on an H100: about 1.1e-3 over 6 layers
# int8 towers on the card vs the port's int8 towers on the CPU (f32): the same
# codes but for rare flips at a code boundary, which compound over 12 blocks
# (f32 stream: 5.3e-4 measured at the served 8 pairs on an H100 80GB HBM3 at
# 700 W), plus the bf16 stream's rounding (bf16 stream: 1.7e-3 in the same run)
RERANK_TOL_INT8_F32 = 1.5e-3
RERANK_TOL_INT8_BF16 = 4e-3
INT8_DRIFT_TOL = 2e-3  # embedding cosine drift, card int8 vs CPU int8
W8A8_DRIFT_TOL = 5e-3  # card int8 vs card bf16: cosine >= 0.995, the JAX W8A8 contract


def _min_gap(scores) -> float:
    s = np.sort(np.asarray(scores))
    return float(np.diff(s).min()) if s.size > 1 else float("inf")


def _order_kept(got, want, tie: float) -> bool:
    """Every pair ``want`` ranks apart by more than ``tie`` keeps its order
    in ``got`` (near-ties may swap)."""

    got, want = np.asarray(got), np.asarray(want)
    apart = (want[:, None] - want[None, :]) > tie
    return bool((got[:, None] > got[None, :])[apart].all())


def profile_serving(rv, engine, items) -> None:
    """One profiled ``retrieve_batch`` (``--profile``): device time by kernel
    and the device's busy share of the call's wall time."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    rv.retrieve_batch(items, engine)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rv.retrieve_batch(items, engine)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:  # operator rows repeat their kernels
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    tag = "int8" if engine.runtime.quant else "bf16"
    emit({"phase": f"profile {tag}", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "top": [{"ms": ms, "kernel": key[:80], "calls": n} for ms, key, n in rows[:15]]})


def _ingest(engine, runtime, cfg, rng, depth: dict, tag: str, blocks) -> tuple:
    """Ingest ``depth["text_chunks"]`` text chunks for two tenants and
    ``depth["images"]`` seeded images through the engine; checks the image
    batches ran ``blocks``. Returns the nodes and images."""

    import torch

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.rag import index_build as ib
    from mmrag_tpu_torch.storage.records import Chunk, VectorRow

    n_text = depth["text_chunks"]
    nodes = {t: _chunks(rng, n_text // 2, t) for t in ("tenant-a", "tenant-b")}
    images = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
              for _ in range(depth["images"])]
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = sum(ib.index_text_nodes(t, nodes[t], engine) for t in nodes)
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t0
    after_text = dict(kernels.LAUNCHES)

    t0 = time.perf_counter()
    img_emb = runtime.embed_images_batch(images)
    rows, chunks = [], []
    for i, emb in enumerate(img_emb):
        tenant = ("tenant-a", "tenant-b")[i % 2]
        cid = f"{tenant}-img{i}"
        rows.append(VectorRow(chunk_id=cid, user_id=tenant, document_id=f"{tenant}-doc{i % 16}",
                              modality="image", embedding=emb))
        chunks.append(Chunk(chunk_id=cid, document_id=f"{tenant}-doc{i % 16}", user_id=tenant,
                            modality="image", media_path=f"{cid}.png"))
    for tenant in ("tenant-a", "tenant-b"):
        sel = [j for j, r in enumerate(rows) if r.user_id == tenant]
        ib.index_image_rows(tenant, [rows[j] for j in sel], [chunks[j] for j in sel], engine)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    image_launches = {k: kernels.LAUNCHES[k] - after_text[k] for k in kernels.LAUNCHES}
    image_batches = -(-len(images) // cfg.tpu.image_batch_buckets[-1])
    if not all(image_launches[k] > 0 for k in blocks):
        raise AssertionError(f"image ingest did not run {blocks}: {image_launches}")
    if not np.isfinite(img_emb).all() or img_emb.shape != (len(images), 512):
        raise AssertionError("image embeddings are not finite (n, 512)")
    emit({"phase": f"ingest {tag}", "text_rows": written, "text_s": text_s,
          "text_chunks_per_s": written / text_s, "images": len(images), "image_s": image_s,
          "images_per_s": len(images) / image_s,
          "launches_text": {k: after_text[k] - before[k] for k in kernels.LAUNCHES},
          "launches_images": image_launches, "image_batches": image_batches})
    return nodes, images


TOPICS = ["posture risk assessment", "warehouse worker lifting a box",
          "model accuracy results", "architecture diagram of the pipeline"]


def _serve(rv, engine, cfg, tag: str, require_images: bool = True) -> dict:
    """16 coalesced chat queries through ``retrieve_batch`` (both tenants, one
    with a document filter) and 4 single ``retrieve`` calls; checks tenant
    isolation, the filter and the rerank head, and that every answer has
    text hits (and image hits, unless ``require_images`` is off). Returns the
    timings, the launches of this serving, the coalesced items and how many
    answers had image hits."""

    import torch

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.utils.profiling import metrics

    items = []
    for i in range(16):
        tenant = ("tenant-a", "tenant-b")[i % 2]
        doc = f"{tenant}-doc3" if i == 5 else None
        items.append((tenant, f"{TOPICS[i % 4]} query {i}", doc))
    before_serve = dict(kernels.LAUNCHES)
    metrics.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payloads = rv.retrieve_batch(items, engine)
    batch_ms = (time.perf_counter() - t0) * 1e3
    stages = metrics.summary()["latency_ms"]
    single_ms = []
    singles = []
    for i in range(4):
        tenant = ("tenant-a", "tenant-b")[i % 2]
        before = dict(kernels.LAUNCHES)
        t1 = time.perf_counter()
        singles.append((tenant, None, rv.retrieve(tenant, f"single {TOPICS[i]}", engine)))
        single_ms.append((time.perf_counter() - t1) * 1e3)
        per_query = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    torch.cuda.synchronize()
    serve_launches = {k: kernels.LAUNCHES[k] - before_serve[k] for k in kernels.LAUNCHES}

    rerank_topk = cfg.retrieval.rerank_topk
    checked = [(u, d, p) for (u, _, d), p in zip(items, payloads)] + singles
    for tenant, doc, payload in checked:
        if not payload["results"] or not payload["text"] or (
                require_images and not payload["images"]):
            raise AssertionError(f"empty result for {tenant}")
        for hit in payload["results"] + payload["text"] + payload["images"]:
            if hit["user_id"] != tenant:
                raise AssertionError(f"hit of {hit['user_id']} served to {tenant}")
            if doc is not None and hit["document_id"] != doc:
                raise AssertionError(f"hit of {hit['document_id']} escaped filter {doc}")
        reranked = sum(h.get("rerank_score") is not None for h in payload["text"])
        if reranked != min(rerank_topk, len(payload["text"])):
            raise AssertionError(f"{reranked} reranked text hits, expected the top {rerank_topk}")
    return {"tag": tag, "batch_ms": batch_ms, "stages": stages, "single_ms": single_ms,
            "per_query": per_query, "serve_launches": serve_launches, "items": items,
            "with_images": sum(bool(p["images"]) for _, _, p in checked)}


# the kernels each pass of the main path must launch while serving, and those
# it must not launch anywhere (every block of a quantized tower is W8A8)
SERVE_LAUNCHES = {False: ("B1", "B2", "B4", "B5"), True: ("B4", "B5", "B6", "B7")}
NEVER_LAUNCHED = {False: ("B6", "B7", "B8", "B9", "B10", "B11"),
                  True: ("B1", "B2", "B3", "B8", "B9", "B10", "B11")}


def _engine_env(tmp: str, **extra) -> dict:
    return {
        "TPU_INDEX_DIR": os.path.join(tmp, "index"),
        "NOTES_DB_PATH": os.path.join(tmp, "notes.db"),
        "WEIGHTS_DIR": os.environ.get("WEIGHTS_DIR") or os.path.join(tmp, "weights"),
        "TPU_MICROBATCH_WINDOW_MS": "0",
        **extra,
    }


def main_path(args_depth: dict, seed: int, quant: bool = False, bf16_runtime=None,
              profile: bool = False):
    """One pass of the main path; returns its launch counts and its runtime.
    ``quant`` runs it with ``TPU_ENCODER_QUANT=int8`` and then holds its towers
    against the port's int8 towers on the CPU and against ``bf16_runtime``'s."""

    import torch

    from mmrag_tpu_torch.cache import clear_all_caches
    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.rag import retrieve as rv
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings
    from mmrag_tpu_torch.storage.records import VectorRow

    rng = np.random.default_rng(seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    env = _engine_env(tmp, TPU_ENCODER_QUANT="int8" if quant else "")
    cfg = load_settings(env)
    runtime = EncoderRuntime(cfg)
    engine = RagEngine(cfg, runtime)
    tag = "int8" if quant else "bf16"
    t0 = time.perf_counter()
    runtime._ensure_minilm(), runtime._ensure_clip(), runtime._ensure_cross()
    emit({"phase": f"load {tag}", "weights_s": time.perf_counter() - t0,
          "dtype": str(runtime.compute_dtype).split(".")[-1],
          "encoder_quant": cfg.tpu.encoder_quant})

    clear_all_caches()  # the process-wide query caches would serve the other pass's answers
    kernels.reset_launches()  # this pass of the main path starts here
    nodes, images = _ingest(engine, runtime, cfg, rng, args_depth, tag,
                            ("B6", "B7") if quant else ("B1", "B3"))

    # fill both slabs with a third tenant's seeded unit vectors
    t0 = time.perf_counter()
    for index, total, dim in ((engine.text_index, args_depth["text_rows"], runtime.text_dim),
                              (engine.image_index, args_depth["image_rows"], runtime.clip_dim)):
        step = 131072
        while index._size < total:
            n = min(step, total - index._size)
            vecs = rng.standard_normal((n, dim), dtype=np.float32)
            base = index._size
            index.upsert([
                VectorRow(chunk_id=f"fill-{dim}-{base + i}", user_id="tenant-fill",
                          document_id=f"fill-doc{(base + i) % 997}", modality="text",
                          embedding=vecs[i])
                for i in range(n)
            ])
    torch.cuda.synchronize()
    emit({"phase": f"fill {tag}", "text_index_rows": engine.text_index._size,
          "text_capacity": engine.text_index._capacity,
          "image_index_rows": engine.image_index._size,
          "image_capacity": engine.image_index._capacity,
          "fill_s": time.perf_counter() - t0})

    served = _serve(rv, engine, cfg, tag)
    main_launches = dict(kernels.LAUNCHES)  # this whole pass, read just after it
    serve_launches = served["serve_launches"]
    for name in SERVE_LAUNCHES[quant]:
        if serve_launches[name] <= 0:
            raise AssertionError(f"{tag} serving did not launch {name}: {serve_launches}")
    for name in NEVER_LAUNCHED[quant]:
        if main_launches[name] != 0:
            raise AssertionError(f"the {tag} pass launched {name}: {main_launches}")
    for name in ("B1", "B2", "B3", "B4", "B5") if not quant else ("B4", "B5", "B6", "B7"):
        if main_launches[name] <= 0:
            raise AssertionError(f"the {tag} pass never launched {name}: {main_launches}")
    emit({"phase": f"serve {tag}", "batch_queries": len(served["items"]),
          "batch_ms": served["batch_ms"],
          "batch_stage_ms": {k: v["p50"] for k, v in served["stages"].items()},
          "single_ms": served["single_ms"],
          "chat_latency_median_ms": float(np.median(served["single_ms"])),
          "launches_per_chat_query": served["per_query"], "launches_serve": serve_launches,
          "launches_main_path": main_launches})
    if profile:
        profile_serving(rv, engine, served["items"])
    if quant:
        reference_int8(cfg, env, runtime, bf16_runtime, nodes, images, TOPICS)
        engine.close()
        return main_launches, runtime

    # the card against the port on the CPU in f32, same seeded weights
    cpu = EncoderRuntime(cfg, device="cpu")
    texts = [n["text"] for n in nodes["tenant-a"][:4]]
    drift = {}
    for name, fn_gpu, fn_cpu in (
        ("minilm", runtime.embed_text_batch, cpu.embed_text_batch),
        ("clip_text", runtime.embed_queries_for_images, cpu.embed_queries_for_images),
    ):
        a, b = fn_gpu(texts), fn_cpu(texts)
        drift[name] = float(1.0 - (a * b).sum(1).min())
    a, b = runtime.embed_images_batch(images[:4]), cpu.embed_images_batch(images[:4])
    drift["clip_image"] = float(1.0 - (a * b).sum(1).min())
    # rerank at the served depth (8 pairs, seq 512): the card in f32 must keep
    # the CPU's order and its logits within 1e-4 (its kernels agree with the
    # plain versions to about 1e-5, well below the logits' spread); the card
    # in bf16 must keep every order whose CPU gap exceeds its own error bound
    rerank_topk = cfg.retrieval.rerank_topk
    passages = [n["text"] for n in nodes["tenant-b"][:rerank_topk]]
    query = [TOPICS[1]] * len(passages)
    rb = cpu.rerank_pairs(query, passages)
    card32 = EncoderRuntime(load_settings({**env, "TPU_COMPUTE_DTYPE": "float32"}))
    ra32 = card32.rerank_pairs(query, passages)
    ra = runtime.rerank_pairs(query, passages)
    err32, err = float(np.abs(ra32 - rb).max()), float(np.abs(ra - rb).max())
    spread = float(np.ptp(rb))
    emit({"phase": "reference", "embedding_cosine_drift": drift, "rerank_pairs": len(rb),
          "rerank_spread": spread, "rerank_min_gap": _min_gap(rb),
          "rerank_max_abs_err_f32": err32, "rerank_max_abs_err_bf16": err,
          "rerank_order_cpu": np.argsort(-rb).tolist(),
          "rerank_order_f32": np.argsort(-ra32).tolist(),
          "rerank_order_bf16": np.argsort(-ra).tolist()})
    if max(drift.values()) > 1e-3:
        raise AssertionError(f"bf16 embedding drift above 1e-3: {drift}")
    if len(rb) != rerank_topk or not spread > 20 * RERANK_TOL_F32:
        raise AssertionError(f"rerank check is blind: {len(rb)} pairs, spread {spread}")
    if not err32 <= RERANK_TOL_F32 or not _order_kept(ra32, rb, RERANK_TOL_F32):
        raise AssertionError(f"f32 rerank on the card off: {ra32} vs {rb}")
    if not err <= RERANK_TOL_BF16 or not _order_kept(ra, rb, 2 * RERANK_TOL_BF16):
        raise AssertionError(f"bf16 rerank on the card off: {ra} vs {rb}")
    engine.close()
    return main_launches, runtime


class TopicGeometry:
    """Seeded fill rows with the structure that embedding corpora have and
    that the ivf and pq layouts rely on (isotropic rows fail both data gates:
    the structure gate discards the layout and the pq quality gate demotes
    the index to int8). Each of the ``m`` subvectors draws from a pool of 16
    patterns; a row's center shares its first ``m/2`` patterns with the other
    centers of its topic (256 topics) and draws the rest on its own; rows are
    clouds of 16 around a center with per-coordinate noise 0.25 (the
    ``_clustered`` recipe of tests/test_pq.py around each center). A cloud
    belongs to one tenant (of three) and one document (of 97)."""

    CLOUD = 16

    def __init__(self, rng, n: int, d: int, m: int = 16, topics: int = 256, pool: int = 16,
                 noise: float = 0.25):
        ds = d // m
        pats = rng.standard_normal((m, pool, ds)).astype(np.float32)
        n_centers = -(-n // self.CLOUD)
        topic_codes = rng.integers(0, pool, (topics, m // 2))
        own = rng.integers(0, pool, (n_centers, m - m // 2))
        codes = np.concatenate([topic_codes[np.arange(n_centers) % topics], own], axis=1)
        self.centers = np.concatenate([pats[j][codes[:, j]] for j in range(m)], axis=1)
        self.rng, self.noise = rng, noise

    def rows(self, lo: int, hi: int) -> np.ndarray:
        c = self.centers[np.arange(lo, hi) // self.CLOUD]
        x = c + self.noise * self.rng.standard_normal(c.shape, dtype=np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    @classmethod
    def tenant(cls, i: int) -> str:
        return f"t{(i // cls.CLOUD) % 3}"

    @classmethod
    def doc(cls, i: int) -> str:
        return f"doc{(i // cls.CLOUD) % 97}"


def _fill_topic(index, geo, lo: int, hi: int, host=None, tenant=None, prefix="r") -> None:
    """Upsert rows [lo, hi) of ``geo``; their f32 originals go to ``host``."""

    from mmrag_tpu_torch.storage.records import VectorRow

    step = 131072
    for a in range(lo, hi, step):
        b = min(a + step, hi)
        vecs = geo.rows(a, b)
        if host is not None:
            host[a:b] = vecs
        index.upsert([
            VectorRow(chunk_id=f"{prefix}{a + i}", user_id=tenant or geo.tenant(a + i),
                      document_id=geo.doc(a + i), modality="text", embedding=vecs[i])
            for i in range(b - a)
        ])


def _exact_ids(rows, index, queries, users, docs, k: int = 10):
    """Exact masked top-k row ids over f32 ``rows`` (on the card) with the
    index's own tenant/document predicate: the recall reference."""

    import torch

    from mmrag_tpu_torch.ops.topk import predicate_mask_multi

    n = rows.shape[0]
    dev = rows.device
    uids = torch.tensor([index._user_intern.get(u, -2) for u in users], dtype=torch.int32,
                        device=dev)
    dids = torch.tensor([-1 if d is None else index._doc_intern.get(d, 2 ** 31 - 1)
                         for d in docs], dtype=torch.int32, device=dev)
    mask = predicate_mask_multi(index._users[:n], index._docs[:n], index._live[:n], uids, dids)
    q = torch.as_tensor(queries, device=dev).float()
    top = torch.topk(torch.where(mask, q @ rows.T, -1e30), k, dim=1)
    ids = top.indices.cpu().numpy()
    return [set(r[s > -1e29].tolist()) for r, s in zip(ids, top.values.cpu().numpy())]


def _recall(hits, exact, index) -> float:
    got = [{index._chunk_to_row[c] for c, _ in h[:10]} for h in hits]
    return float(np.mean([len(g & e) / max(len(e), 1) for g, e in zip(got, exact)]))


def _near_queries(rng, rows: np.ndarray, sel) -> np.ndarray:
    q = rows[sel] + 0.02 * rng.standard_normal((len(sel), rows.shape[1])).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# layout of each index pass: (dtype, backend), the kernels its searches must
# launch, its recall floor (the JAX package's: tests/test_ops_ivf.py:53 and
# :304 for ivf and ivf + int8, tests/test_pq.py:69 for refined pq)
INDEX_PASSES = {
    "ivf bf16": (("bfloat16", "ivf"), ("B8", "B4"), 0.9),
    "ivf int8": (("int8", "ivf"), ("B9",), 0.9),
    "pq": (("pq", "auto"), ("B10", "B11"), 0.95),
}
TAIL = 4096


def index_pass(kind: str, n: int, seed: int) -> dict:
    """One index layout at ``n`` x 384 on ``VectorIndex`` directly: fill
    n - 4096 rows of three tenants, build synchronously, append a 4096-row
    tail, then 16 coalesced ``search_batch_multi`` queries (one with a
    document filter, two near tail rows) and 4 single ``search`` calls.
    Returns the pass's launch counts."""

    import torch

    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.ops import kernels

    (dtype, backend), expect, floor = INDEX_PASSES[kind]
    d = 384
    rng = np.random.default_rng(seed)
    geo = TopicGeometry(rng, n, d)
    host = np.empty((n, d), np.float32)
    kernels.reset_launches()  # this pass starts here
    index = VectorIndex(dim=d, dtype=dtype, backend=backend)
    index.ivf_build_async = False
    t0 = time.perf_counter()
    _fill_topic(index, geo, 0, n - TAIL, host)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if backend == "ivf":
        index.build_ivf()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _fill_topic(index, geo, n - TAIL, n, host)  # the append tail
    layout = index._ivf
    if backend == "ivf" and (layout is None or layout.built_rows != n - TAIL):
        raise AssertionError(f"{kind}: the ivf layout was not installed (structure gate?)")
    if dtype == "pq" and not (index.is_pq and index.dtype == torch.bfloat16):
        raise AssertionError(f"{kind}: the pq index was demoted (quality gate)")
    if dtype == "int8" and not (index.is_int8 and layout.scales_b is not None):
        raise AssertionError(f"{kind}: the int8 layout is missing")

    sel = np.concatenate([rng.choice(n - TAIL, 14, replace=False),
                          n - TAIL + rng.choice(TAIL, 2, replace=False)])
    queries = _near_queries(rng, host, sel)
    users = [geo.tenant(i) for i in sel]
    docs = [geo.doc(i) if j == 5 else None for j, i in enumerate(sel)]
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = index.search_batch_multi(queries, users, 10, docs)
    batch_ms = (time.perf_counter() - t0) * 1e3
    single_ms, singles = [], []
    for j in range(4):
        t1 = time.perf_counter()
        singles.append(index.search(queries[j], users[j], 10))
        single_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    pass_launches = dict(kernels.LAUNCHES)  # the whole pass, read just after it
    for name in kernels.LAUNCHES:
        if (launches[name] > 0) != (name in expect):
            raise AssertionError(f"{kind}: searches launched {launches}, expected {expect}")
    for h, user, doc in list(zip(hits, users, docs)) + [(h, users[j], None)
                                                        for j, h in enumerate(singles)]:
        if not h:
            raise AssertionError(f"{kind}: empty result for {user}")
        for cid, _ in h:
            row = index._chunk_to_row[cid]
            if geo.tenant(row) != user or (doc is not None and geo.doc(row) != doc):
                raise AssertionError(f"{kind}: {cid} served to {user} / {doc}")
    rows_dev = torch.from_numpy(host).cuda()
    recall = _recall(hits, _exact_ids(rows_dev, index, queries, users, docs), index)
    del rows_dev
    emit({"phase": f"index {kind}", "rows": n, "capacity": index._capacity,
          "fill_s": fill_s, "build_s": build_s,
          "clusters": layout.n_clusters if layout is not None else None,
          "bucket": layout.bucket_size if layout is not None else None,
          "spill": int(layout.spill.shape[0]) if layout is not None else None,
          "structure": layout.structure if layout is not None else None,
          "batch_ms": batch_ms, "single_ms": single_ms,
          "search_median_ms": float(np.median(single_ms)), "recall_at_10": recall,
          "recall_floor": floor, "launches_search": launches})
    if recall < floor:
        raise AssertionError(f"{kind}: recall@10 {recall} below the JAX floor {floor}")
    del index, host
    torch.cuda.empty_cache()
    return pass_launches


def ivf_pq_pass(depth: dict, seed: int, runtime) -> dict:
    """The IVF_PQ engine pass (``TPU_TOPK_BACKEND=ivf``, ``TPU_INDEX_DTYPE=pq``)
    on the bf16 pass's runtime: ingest as the main path does, fill both
    indexes with topic-structured rows, build both layouts, append a tail,
    serve. Returns the pass's launch counts."""

    import torch

    from mmrag_tpu_torch.cache import clear_all_caches
    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.rag import retrieve as rv
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings

    rng = np.random.default_rng(seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg = load_settings(_engine_env(tmp, TPU_TOPK_BACKEND="ivf", TPU_INDEX_DTYPE="pq"))
    engine = RagEngine(cfg, runtime)
    indexes = (engine.text_index, engine.image_index)
    for index in indexes:
        index.ivf_build_async = False
    clear_all_caches()
    kernels.reset_launches()  # this pass starts here
    _ingest(engine, runtime, cfg, rng, depth, "ivf_pq", ("B1", "B3"))
    geos, t0 = [], time.perf_counter()
    for index, total in zip(indexes, (depth["text_rows"], depth["image_rows"])):
        geo = TopicGeometry(rng, total, index.dim)
        _fill_topic(index, geo, index._size, total - TAIL, tenant="tenant-fill", prefix="f")
        geos.append(geo)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for index in indexes:
        if not (index.is_pq and index.dtype == torch.bfloat16):
            raise AssertionError("the IVF_PQ pass's index was demoted (quality gate)")
        index.build_ivf()
        if index._ivf is None or not index._ivf.is_pq:
            raise AssertionError("the IVF_PQ layout was not installed (structure gate?)")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for index, geo, total in zip(indexes, geos, (depth["text_rows"], depth["image_rows"])):
        _fill_topic(index, geo, total - TAIL, total, tenant="tenant-fill", prefix="f")
    # a text query picks its image clusters by its cosine to their centroids,
    # so a small tenant's image clusters may go unprobed (the JAX package's
    # IVF semantics, held against it in tests/test_torch_ivf_pq_tenants.py):
    # image hits are counted here and checked below with every cluster probed
    served = _serve(rv, engine, cfg, "ivf_pq", require_images=False)
    pass_launches = dict(kernels.LAUNCHES)
    serve = served["serve_launches"]
    if serve["B10"] <= 0 or serve["B11"] <= 0:
        raise AssertionError(f"IVF_PQ serving did not launch B10 and B11: {serve}")
    if any(pass_launches[k] for k in ("B4", "B8", "B9")):
        raise AssertionError(f"the IVF_PQ pass launched B4, B8 or B9: {pass_launches}")

    text = engine.text_index
    host = text._host_rows_f32()  # the pq index's f32 originals
    rows_dev = torch.from_numpy(host).cuda()
    fill_rows = np.flatnonzero(np.char.startswith(np.asarray(text._chunk_ids), "f"))
    sel = rng.choice(fill_rows, 16, replace=False)
    queries = _near_queries(rng, host, sel)
    fill_users = ["tenant-fill"] * 16
    t0 = time.perf_counter()
    hits = text.search_batch_multi(queries, fill_users, 10)
    search_ms = (time.perf_counter() - t0) * 1e3
    recall = _recall(hits, _exact_ids(rows_dev, text, queries, fill_users, [None] * 16), text)
    users = [u for u, _, _ in served["items"]]
    docs = [d for _, _, d in served["items"]]
    tvecs = runtime.embed_text_batch([q for _, q, _ in served["items"]])
    served_exact = _exact_ids(rows_dev, text, tvecs, users, docs)
    served_recall = _recall(text.search_batch_multi(tvecs, users, 10, docs), served_exact, text)
    del rows_dev
    # the served tenants' rows are a random-weight encoder's near-duplicates;
    # probing every cluster parts what the probe loses from what the ADC
    # shortlist loses, and reaches the tenants' image rows
    image = engine.image_index
    ivecs = runtime.embed_queries_for_images([q for _, q, _ in served["items"]])
    every = {}
    for index, vecs in ((text, tvecs), (image, ivecs)):
        nprobe, index.ivf_nprobe = index.ivf_nprobe, index._ivf.n_clusters
        every[index] = index.search_batch_multi(vecs, users, 10, docs)
        index.ivf_nprobe = nprobe
    for index in (text, image):
        for h, user, doc in zip(every[index], users, docs):
            if not h:
                raise AssertionError(f"IVF_PQ with every cluster probed: no hit for {user}")
            for cid, _ in h:
                row = index._chunk_to_row[cid]
                if int(index._users[row]) != index._user_intern[user] or (
                        doc is not None and index._row_doc[row] != doc):
                    raise AssertionError(f"IVF_PQ: {cid} served to {user} / {doc}")
    emit({"phase": "serve ivf_pq", "text_rows": text._size,
          "image_rows": engine.image_index._size, "fill_s": fill_s, "build_s": build_s,
          "text_clusters": text._ivf.n_clusters, "text_bucket": text._ivf.bucket_size,
          "image_clusters": engine.image_index._ivf.n_clusters,
          "batch_ms": served["batch_ms"],
          "batch_stage_ms": {k: v["p50"] for k, v in served["stages"].items()},
          "single_ms": served["single_ms"],
          "chat_latency_median_ms": float(np.median(served["single_ms"])),
          "launches_serve": serve, "launches_main_path": pass_launches,
          "answers_with_image_hits": served["with_images"],
          "text_search_ms_16_fill_queries": search_ms, "text_recall_at_10": recall,
          "text_recall_at_10_served_queries": served_recall,
          "text_recall_at_10_served_queries_every_cluster": _recall(every[text], served_exact,
                                                                    text),
          "image_hits_served_queries_every_cluster": sum(len(h) for h in every[image])})
    if recall < 0.9:
        raise AssertionError(f"IVF_PQ text recall@10 {recall} below 0.9")
    engine.close()
    del engine, indexes, text
    torch.cuda.empty_cache()
    return pass_launches


def _drift(a, b) -> float:
    return float(1.0 - (a * b).sum(1).min())  # both L2-normalized


def reference_int8(cfg, env, runtime, bf16_runtime, nodes, images, topics) -> None:
    """The int8 towers on the card against the port's int8 towers on the CPU
    (f32) and against the bf16 towers on the card, same seeded weights."""

    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.settings import load_settings

    cpu = EncoderRuntime(cfg, device="cpu")
    texts = [n["text"] for n in nodes["tenant-a"][:4]]
    drift_cpu, drift_bf16 = {}, {}
    for name, fn in (("minilm", "embed_text_batch"), ("clip_text", "embed_queries_for_images"),
                     ("clip_image", "embed_images_batch")):
        inputs = images[:4] if name == "clip_image" else texts
        card = getattr(runtime, fn)(inputs)
        drift_cpu[name] = _drift(card, getattr(cpu, fn)(inputs))
        drift_bf16[name] = _drift(card, getattr(bf16_runtime, fn)(inputs))
    rerank_topk = cfg.retrieval.rerank_topk
    passages = [n["text"] for n in nodes["tenant-b"][:rerank_topk]]
    query = [topics[1]] * len(passages)
    rb = cpu.rerank_pairs(query, passages)
    card32 = EncoderRuntime(load_settings({**env, "TPU_COMPUTE_DTYPE": "float32"}))
    ra32 = card32.rerank_pairs(query, passages)
    ra = runtime.rerank_pairs(query, passages)
    rbf = bf16_runtime.rerank_pairs(query, passages)
    err32, err = float(np.abs(ra32 - rb).max()), float(np.abs(ra - rb).max())
    apart = int(((rb[:, None] - rb[None, :]) > 2 * RERANK_TOL_INT8_F32).sum())
    emit({"phase": "reference int8", "embedding_cosine_drift_vs_cpu_int8": drift_cpu,
          "embedding_cosine_drift_vs_card_bf16": drift_bf16, "rerank_pairs": len(rb),
          "rerank_spread": float(np.ptp(rb)), "rerank_min_gap": _min_gap(rb),
          "rerank_max_abs_err_f32": err32, "rerank_max_abs_err_bf16": err,
          "rerank_max_abs_diff_vs_card_bf16": float(np.abs(ra - rbf).max()),
          "rerank_ordered_pairs_checked_f32": apart,
          "rerank_order_cpu": np.argsort(-rb).tolist(),
          "rerank_order_f32": np.argsort(-ra32).tolist(),
          "rerank_order_bf16": np.argsort(-ra).tolist()})
    if max(drift_cpu.values()) > INT8_DRIFT_TOL:
        raise AssertionError(f"int8 drift vs the CPU port above {INT8_DRIFT_TOL}: {drift_cpu}")
    if max(drift_bf16.values()) > W8A8_DRIFT_TOL:
        raise AssertionError(f"int8 vs bf16 cosine below 0.995: {drift_bf16}")
    if len(rb) != rerank_topk or apart == 0:
        raise AssertionError(f"int8 rerank check is blind: {len(rb)} pairs, gaps {rb}")
    if not err32 <= RERANK_TOL_INT8_F32 or not _order_kept(ra32, rb, 2 * RERANK_TOL_INT8_F32):
        raise AssertionError(f"f32 int8 rerank on the card off: {ra32} vs {rb}")
    if not err <= RERANK_TOL_INT8_BF16 or not _order_kept(ra, rb, 2 * RERANK_TOL_INT8_BF16):
        raise AssertionError(f"bf16 int8 rerank on the card off: {ra} vs {rb}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from mmrag_tpu_torch.ops import kernels  # fails outside a checkout of the repo

    kernels_only = "--kernels-only" in argv
    seed = 0
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    emit({"phase": "card", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    seconds = kernels.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for src in kernels.SOURCES:
        ptxas[src] = [line.strip() for line in kernels.build_log(src).splitlines()
                      if "registers" in line or "spill" in line]
    emit({"phase": "build", "wall_s": build_s, "per_source_s": seconds, "ptxas": ptxas})

    bf16, f32 = torch.bfloat16, torch.float32
    results = []
    cases = [
        lambda: phase_b1((128, 512, 384, 12, False), bf16, 14),
        lambda: phase_b1((8, 512, 384, 12, False), bf16, 1),
        lambda: phase_b1((32, 64, 384, 12, False), bf16, 2),
        lambda: phase_b1((128, 56, 768, 12, True), bf16, 3),
        lambda: phase_b2(4096, 384, bf16, 4),
        lambda: phase_b3(7168, 768, 3072, bf16, 5),
        lambda: phase_b4(1 << 20, 384, 1, True, bf16, 6),
        lambda: phase_b4(1 << 20, 384, 16, True, bf16, 7),
        lambda: phase_b4(131072, 512, 16, False, bf16, 8),
        lambda: phase_b5(16, 77, 512, 8, bf16, 15),
        lambda: phase_b6((128, 512, 384, 12, False), bf16, 16),
        lambda: phase_b6((8, 512, 384, 12, False), bf16, 17),
        lambda: phase_b6((32, 64, 384, 12, False), bf16, 18),
        lambda: phase_b6((128, 56, 768, 12, True), bf16, 19),
        lambda: phase_b7(7168, 768, 3072, True, "quick_gelu", bf16, 20),
        lambda: phase_b7(65536, 384, 1536, False, "gelu_tanh", bf16, 21),
        lambda: phase_b8(2048, 768, 384, 16, 64, bf16, 26),
        lambda: phase_b8(1024, 256, 512, 16, 64, bf16, 27),
        lambda: phase_b9(2048, 768, 384, 16, 64, 28),
        lambda: phase_b10(1 << 20, 16, 16, True, 29),
        lambda: phase_b10(1 << 20, 16, 16, False, 30),
        lambda: phase_b11(16, 16, 49152, False, 31),
        lambda: phase_b11(16, 16, 102912, False, 32),
        lambda: phase_b11(16, 16, 49152, True, 33),
        lambda: phase_b1((8, 512, 384, 12, False), f32, 9),
        lambda: phase_b1((128, 56, 768, 12, True), f32, 10),
        lambda: phase_b2(4096, 384, f32, 11),
        lambda: phase_b3(7168, 768, 3072, f32, 12),
        lambda: phase_b4(1 << 20, 384, 16, True, f32, 13),
        lambda: phase_b5(16, 77, 512, 8, f32, 22),
        lambda: phase_b6((8, 512, 384, 12, False), f32, 23),
        lambda: phase_b6((128, 56, 768, 12, True), f32, 24),
        lambda: phase_b7(7168, 768, 3072, True, "quick_gelu", f32, 25),
        lambda: phase_b8(2048, 768, 384, 16, 64, f32, 34),
    ]
    for case in cases:
        res = case()
        emit(res)
        results.append(res)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # launches: every pass of the main path (each counted from 0), summed
    launches = {k: None for k in kernels.LAUNCHES}
    if not kernels_only:
        depth = {"text_chunks": 2048, "images": 256, "text_rows": 1 << 20,
                 "image_rows": 131072}
        passes = {}
        passes["bf16"], bf16_runtime = main_path(depth, seed, profile="--profile" in argv)
        depth_q8 = dict(depth, text_rows=1 << 18, image_rows=1 << 16)
        passes["int8"], _ = main_path(depth_q8, seed, quant=True, bf16_runtime=bf16_runtime,
                                      profile="--profile" in argv)
        for i, kind in enumerate(INDEX_PASSES):
            passes[f"index {kind}"] = index_pass(kind, 1 << 20, seed + 1 + i)
        passes["ivf_pq"] = ivf_pq_pass(depth, seed + 7, bf16_runtime)
        launches = {k: sum(p[k] for p in passes.values()) for k in kernels.LAUNCHES}
        emit({"phase": "main path launches", **passes})

    headline = {  # name, replaces, source, headline shape, dtype
        "B1": ("_attn_block_kernel", "mmrag_tpu/ops/attention.py:371", "attention.cu",
               "128x512 h384 post-LN"),
        "B2": ("_add_ln_kernel", "mmrag_tpu/ops/layernorm.py:43", "layernorm.cu", "4096x384"),
        "B3": ("_mlp_kernel", "mmrag_tpu/ops/mlp.py:29", "gemm.cu", "7168x768->3072"),
        "B4": ("_bucket_max_kernel", "mmrag_tpu/ops/pallas_topk.py:58", "bucket_max.cu",
               "1048576x384 q16 per-query mask"),
        "B5": ("_attn_kernel", "mmrag_tpu/ops/attention.py:268", "attention.cu",
               "16x77x512 causal+pad"),
        "B6": ("_attn_block_kernel_q8", "mmrag_tpu/ops/attention.py:440", "gemm_i8.cu",
               "128x512 h384 post-LN"),
        "B7": ("_mlp_kernel_q8", "mmrag_tpu/ops/mlp.py:114", "gemm_i8.cu",
               "7168x768->3072 pre-LN quick_gelu"),
        "B8": ("_probe_kernel", "mmrag_tpu/ops/ivf.py:435", "ivf_probe.cu",
               "q16 nprobe64 C2048 B768 d384"),
        "B9": ("_probe_kernel_q", "mmrag_tpu/ops/ivf.py:520", "ivf_probe.cu",
               "q16 nprobe64 C2048 B768 d384", "int8"),
        "B10": ("_adc_bucket_max_kernel", "mmrag_tpu/ops/pq.py:229", "adc.cu",
                "1048576 codes m16 q16 per-query bias"),
        "B11": ("_adc_rescore_kernel", "mmrag_tpu/ops/pq.py:270", "adc.cu", "q16 m16 S49152"),
    }
    table = []
    for key, (kname, replaces, src, shape, *dt) in headline.items():
        dtype = dt[0] if dt else "bfloat16"
        r = next(r for r in results
                 if r["kernel"] == key and r["shape"] == shape and r["dtype"] == dtype)
        table.append({
            "name": f"{key} {kname}", "route": "cuda",
            "source": f"mmrag_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[key], "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
