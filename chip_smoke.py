#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmrag_tpu_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name
   and power limit);
2. builds the hand-written kernels from ``mmrag_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and, beside them, the native host
   runtime (``mmrag_tpu_torch/native/host_runtime.cpp``, g++), and prints the
   build time and the compiler's register / spill report;
3. holds each ported TPU kernel (B1-B12) against its plain PyTorch version on
   the card at the main path's shapes in bf16 (B9: int8), then once in f32,
   and times the kernel, the plain version and one PyTorch library
   composition computing the same function (CUDA events, median of 25 runs
   after warm-up), beside the least time the card could take (``bound_ms``);
   B12 (the 2-D encoder attention) lies on no path of either package and is
   held here only: every pass below checks that it never launches. B4's row
   splits into phase A (K-bmax) and the torch phases B and C; K-bmax alone
   (1M x 384 q16 per-query, 128K x 512 q16 shared, against its byte bound and
   ``(q @ c.T + bias).view(q, -1, 128).amax(-1)``), K-gemm alone (B3's fc1
   and fc2 at 7168 rows, B1's q|k|v at 65536 x 384 -> 1152, with TFLOP/s
   against ``F.linear``, the product alone), K-gemm-i8 alone (the four
   products of a rerank layer at 65536 rows and B7's fc1 and fc2 at 7168,
   with TOPS against ``torch._int_mm``, the int8 product alone) and K-quant
   alone (against PyTorch ops and its byte bound, at every width the path
   gives it) are timed over 10 back-to-back launches between two events;
   K-quant, B2 (K-ln), B8-B11 also over 10 launches queued behind a spin of
   the card (``device_ms``: the kernel without its wrapper's host time, with
   ``bound_share``, the bound over it); B8 and B9 also at q1, the shape of
   every single ``retrieve``, each row with the distinct blocks its queries
   probe (``probed_blocks``); B2 at every K-ln shape of the main path (the
   query towers' 512 x 384 and the coalesced call's 2048 x 384 add-LN, the
   rerank's post-LN at 4096 and 65536 rows, CLIP vision's 7168 x 768 pre-LN)
   and B11 also at q1 (a single retrieve's IVF_PQ probe), with
   ``lookup_floor_ms`` (every table entry looked up once at the banks' rate);
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
   CPU in f32, and the int8 towers against the bf16 ones. The int8 pass
   keeps the index journal and checks a restart: ``persist_indexes``, then
   a second engine over the same directory must hold the same rows and give
   the same final 4 for the single calls (save and load seconds printed);
   between the two, the ``serve http`` phase serves the HTTP API
   (``mmrag_tpu_torch.serving.http``) on the bf16 pass's runtime under the
   default batcher settings (4 ms window, up to 16, 3 runners) over 262,144
   text and 65,536 image rows of two tenants: warmup, ``/healthz`` (the
   watchdog's probe), an 8-page PDF a tenant, one YouTube job (its network
   stages replaced; scene scores and pHash dedup on the card over a seeded
   64 x 720p stack), 32 concurrent ``/chat_pro`` from 16 threads (payload
   shape, tenant isolation, citations, a batch above 1, the final 4 against
   a direct ``retrieve_batch``), its launches, then X3 and the scene
   histograms held against the port on the CPU and timed; after it, the
   ``serve asr`` phase: seeded whisper-base weights written by the port, a
   served YouTube job whose captions fail and whose download and audio
   stages return a seeded 75 s wav, so the ladder transcribes it with the
   port's Whisper (auto detection, timestamps, bf16: log-mel X4, encoder,
   KV-cached greedy decode X5; no B1-B12 launch during the transcription),
   its segments equal to a direct ``transcribe_wav`` and indexed for that
   tenant alone; the aligned path (X6, ``MODEL_ASR_WORD_ALIGN=1``); X4, the
   encoder, X5 and X6 held against the port on the CPU in f32 on one
   window, the bf16 runtime against f32; and the stage times and real-time
   factors;
5. drives the partitioned and compressed index layouts, each with the launch
   counts set to 0 just before it and read just after: three passes on
   ``VectorIndex`` at 1,048,576 x 384 (``ivf`` over bf16: B8; ``ivf`` over
   int8: B9; flat ``pq``: B10 + B11), each filled with topic-structured rows
   for three tenants, built synchronously, given a 4096-row append tail and
   searched (16 coalesced + 4 single) with isolation and recall@10 checks
   against the exact search; then the IVF_PQ engine pass
   (``TPU_TOPK_BACKEND=ivf``, ``TPU_INDEX_DTYPE=pq``, the bf16 pass's
   runtime) over 1,048,576 text and 131,072 image rows, served as in 4;
   then the mesh pass (each part with the launch counts set to 0 before it):
   every index layout (dense bf16, int8, pq, ivf bf16, ivf int8, IVF_PQ) at
   1,048,576 x 384 twice over the same rows, on one device and row-sharded
   over a 4-shard mesh of the card: the sharded hits held against the
   single-device ones and recall@10 against the exact search, each kernel
   of the layout launched 4 times as often, ms per search at q 1 and q 16;
   the data-parallel ``EncoderRuntime`` and ``RagEngine`` on a 2-shard mesh
   at full width, bf16 and int8 (each kernel twice as often, the embeddings
   and logits against the single-device runtime's, ``retrieve_batch`` of 16
   held on raw scores and its final 4), ``dp_clip_image_embed`` on a
   256-pixel canvas (X2) against the port on the CPU; and the native
   WordPiece timed against the Python one on a served batch and 256 ingest
   chunks of up to 510 tokens (no word a whole piece of the vocabulary), ids
   equal. A mesh over one card runs its
   shards one after another: it measures the shard-and-merge path, not a
   multi-GPU speed;
6. runs the train phase (``mmrag_tpu_torch.parallel.training``, plain torch
   in f32, the launch counts set to 0 before the steps and read after them,
   all 0, as JAX's training reaches no ``pallas_call``): MiniLM-L6 MNR (32
   pairs at seq 128), the cross-encoder (16 pairs at seq 512) and CLIP
   ViT-B/32 (32 images at 224 against 77 tokens) each take 10 AdamW steps
   on a fixed batch at full width and depth and must learn (the least of the
   last 3 losses below the first); median step ms after two warm-up steps,
   samples/s, peak memory and TFLOP/s against the f32 peak; one step of
   each at batch 4 on the card and on the CPU (loss 1e-5 relative,
   gradients 1e-4 of each leaf's max-abs); one CLIP step on a (data 2,
   model 2) mesh of the card against one device; MiniLM saved at step 5,
   restored into a fresh state and run to step 10 (losses within 1e-6 of
   the uninterrupted run); then the fine-tuned MiniLM and CLIP exported
   (``params_to_jax`` + ``save_params``) and served by a bf16
   ``EncoderRuntime`` through B1-B3 within the 1e-3 cosine drift of the
   trained f32 forward;
7. runs the models phase (``models_pass``): seeded full-width MiniLM-L6,
   ms-marco cross-encoder, CLIP ViT-B/32 and whisper-base weights as HF state
   dicts (HF's key names and shapes), converted by the port's
   ``convert_bert`` / ``convert_cross_encoder`` / ``convert_clip`` /
   ``convert_whisper`` (each equal to the tree it was made from) and written
   with ``save_params`` into a ``WEIGHTS_DIR``; the production
   ``EncoderRuntime`` booted from it on the card (bf16) against the port on
   the CPU in f32 (cosine drift 1e-3, the rerank order kept); each family's
   battery (``mmrag_tpu_torch.models.validate``) on the card with the port's
   CPU f32 outputs as the reference (``parity_ok`` held) and on the CPU, the
   W8A8 cosine and the PQ recall held between the two (``MODELS_*_TOL``);
   B1-B3, B5-B7, B10 and B11 must launch;
8. runs the approx phase (``approx_pass``, X1): ``VectorIndex(backend=
   "approx")`` at 1,048,576 x 384 bf16 for three tenants, each document's
   chunks in contiguous rows, filled twice: 16-chunk documents (k 50, text,
   and 12, image) and documents of 32-96 chunks across bucket edges (k 50);
   on one device and on a 4-shard mesh of the card, 16 coalesced and 4
   single searches at each k: isolation, recall@k against the exact top-k
   at least 0.95 and every query's against the exact path on the same rows
   at least ``min(1, APPROX_TOP / k)``, K-bmax's top-k form and its merge
   launched once a search a shard and neither K-bmax, B4 nor phases B and
   C, ms at q1 and q16 beside the exact path on the same rows. The kernel
   phases of 3 hold the top-k form alone (``phase_kbmax_top``, 1M x 384 q16
   and q1 per-query, 128K x 512 q16 shared) against its plain form at the
   kernel's grid, the merge alone (``phase_topk_merge``) against its plain
   form, and the approximate search (``phase_x1``, q16 and q1, and q16 at k
   100, above the lists' capacity) against its plain version, ids held
   wherever the plain scores are apart
   (``_ids_held``, as in ``phase_b4``), with the exact B4 search timed
   beside it;
9. runs the dcn phase (``dcn_pass``, item 8d): two fresh processes of this
   script (``--dcn-worker``) join a gloo group through
   ``initialize_multihost``, each holding half of 1,048,576 x 384 bf16 rows
   on the card on a 2-shard mesh of its own, and search through
   ``sharded_topk_fn`` at q1 and q16, k 50: ids and scores equal to a
   one-process search of the whole corpus, B4 launched in each, ms beside
   the one-process time (one card: the path, not a multi-GPU speed);
10. runs the graft phase (``graft_pass``, ``mmrag_tpu_torch.graft_entry``):
   ``entry()``'s forward (CLIP ViT-B/32 over 8 seeded 224 x 224 images) on
   the card in bf16 against the same forward on the CPU in f32 over the same
   seeded params (cosine drift within 1e-3), B1 and B3 (K-ln, K-gemm,
   K-attn) launched, its median ms over 10 calls; then
   ``dryrun_multichip(4)`` on four shards of the card (the engine, pq and
   sharded ivf indexes, a (2, 2) CLIP training step), its seconds, report
   and each part's kernels; and the op_profile phase
   (``op_profile_pass``, ``mmrag_tpu_torch.tools.op_profile``): the six
   encoder targets at JAX's shapes, bf16, 20 profiled steps each, device
   ms a step, the top 5 kernels and the hand-written kernels' share;
11. prints the kernel table as one JSON line (B1-B12, then the building
   kernels K-gemm, K-gemm-i8, K-ln, K-quant, K-attn and K-bmax, and X1's
   K-bmax-top and K-bmax-topk-merge, each alone at a main-path shape,
   with its launches in the passes above, every one of which must be
   nonzero), the card line, and last ``{"ok": true, "device": {...}}``.

Each pass's ``serve`` line splits the coalesced call's ``retrieve.search``
stage (``search_split_ms``, from the program's span ring): the journal
check, the dispatch, the readback's wait and host merge, dispatch to done,
garbage collection, and the threads alive and the caching allocator's
retries; ``--r15`` runs the build, the
bf16 pass and then the int8 pass three times (before the served phases,
after them, after them without the journal), without the kernel phases.

Every phase raises on failure, so any fault exits non-zero before the last
line. Without CUDA it exits 2 and prints no result. ``--profile`` adds, in each
pass, one ``torch.profiler`` window over a coalesced ``retrieve_batch`` (device time by
kernel, device idle share); ``--kernels-only`` stops after step 3.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, same sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES = 3.35e12  # HBM3 bytes/s
# exp on the SFU: 16 a clock per SM (CUDA C Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 132 SMs x 1.83 GHz, the
# clock implied by the 989 TFLOP/s bf16 peak
H100_EXP = 16 * 132 * 1.83e9
# shared memory: 32 banks of 4 bytes a clock per SM, same clock
H100_SMEM = 128 * 132 * 1.83e9
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


def time_ms_batched(fn, calls: int = 10, repeats: int = 9) -> float:
    """Median over ``repeats`` of the mean CUDA-event time of ``calls``
    back-to-back calls: the host enqueues the next launch while the device
    runs this one, so a launch alone is timed without the host's gap."""

    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


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


def device_ms(fn, calls: int = 10, repeats: int = 9) -> float:
    """Like ``time_ms_batched``, with the host ahead of the device: each batch
    of ``calls`` is enqueued behind a 2 ms spin of the card, so the launches
    run back to back and the events time the device alone, not a wrapper's
    host time (15-40 us a call, more than the shortest kernels take)."""

    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # cycles: about 2 ms
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def bound(flops: float, nbytes: float, bf16: bool, int8_ops: float = 0.0, exps: float = 0.0):
    """The largest of three least times (ms): the products (float ``flops``
    at the bf16 or f32 peak plus ``int8_ops`` at the int8 peak), the ``exps``
    at the SFU's rate, and the bytes."""

    t_ops = max((flops / (H100_BF16_FLOPS if bf16 else H100_F32_FLOPS)
                 + int8_ops / H100_INT8_OPS) * 1e3, exps / H100_EXP * 1e3)
    t_bytes = nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _live_pairs(mask) -> int:
    """(query, key) pairs a key-padding mask leaves live: every query row of
    a batch row against its unmasked keys (what the attention must compute;
    K-attn skips 64-key tiles that are all padding)."""

    return int(mask.shape[1] * mask.sum())


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
    """A LayerNorm's output (or a block's that ends in one) against the plain
    version: the f32 statistics are summed in another order, so a bf16 value
    may round to the neighbouring bf16 (within 5e-2 at most, 5e-3 on
    average, for outputs of a few units); f32 within 1e-3."""

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
    pairs = _live_pairs(mask)
    flops = 8 * rows * h * h + 4 * pairs * h
    item = x.element_size()
    # x in, out written, the four projections, the int32 mask, f32 biases + LN
    nbytes = 2 * rows * h * item + 4 * h * h * item + b * s * 4 + 6 * h * 4
    bms, by = bound(flops, nbytes, bf16, exps=pairs * nh)
    return {
        "kernel": "B1", "shape": f"{b}x{s} h{h} {'pre' if pre_ln else 'post'}-LN",
        "dtype": str(dtype).split(".")[-1], "ok": ok, "max_abs_err": max_abs,
        "mean_abs_err": mean_abs,
        "kernel_ms": time_ms(lambda: fused_attention_block(*args)),
        "plain_ms": time_ms(lambda: fused_attention_block_plain(*args)),
        "library_ms": time_ms(library),
        "bound_ms": bms, "bound_by": by,
    }


def phase_b2(rows: int, h: int, dtype, seed: int, delta: bool = True, out_dtype=None,
             pre_ln: bool = False):
    """B2: ``LN(x [+ delta])`` (one K-ln launch), f32 statistics, output in
    ``out_dtype`` (default: the input's). Without ``delta`` this is a
    post-LN block's K-ln, f32 in and bf16 out, or with ``pre_ln`` CLIP
    vision's pre-LN, bf16 in and out."""

    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.layernorm import fused_add_layer_norm

    out_dtype = out_dtype or dtype
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, h), generator=gen).to(dev, dtype)
    d = (torch.randn((rows, h), generator=gen) * 0.5).to(dev, dtype) if delta else None
    scale = (torch.randn((h,), generator=gen) * 0.1 + 1).to(dev)
    bias = (torch.randn((h,), generator=gen) * 0.02).to(dev)
    args = (x, d, scale, bias, 1e-12, out_dtype)
    got = fused_add_layer_norm(*args)
    want = kernels.layer_norm_plain(*args)
    torch.cuda.synchronize()
    bf16 = out_dtype == torch.bfloat16
    ok, max_abs, mean_abs = _ln_ok(got, want, bf16)
    nbytes = rows * h * (x.element_size() * (2 if delta else 1) + got.element_size()) + 8 * h
    bms, by = bound(10 * rows * h, nbytes, bf16)
    sd, bd = (scale, bias) if dtype == torch.float32 else (scale.to(dtype), bias.to(dtype))
    shape = (f"{rows}x{h}" if delta else f"{rows}x{h} pre-LN" if pre_ln
             else f"{rows}x{h} post-LN, {_dt(out_dtype)} out")
    dms = device_ms(lambda: kernels.layer_norm(*args))
    return {
        "kernel": "B2", "shape": shape, "dtype": _dt(dtype),
        "ok": ok, "max_abs_err": max_abs, "mean_abs_err": mean_abs,
        "kernel_ms": time_ms_batched(lambda: fused_add_layer_norm(*args)),
        "device_ms": dms, "bound_share": bms / dms,
        "plain_ms": time_ms_batched(lambda: kernels.layer_norm_plain(*args)),
        "library_ms": time_ms_batched(
            lambda: F.layer_norm(x + d if delta else x, (h,), sd, bd, 1e-12).to(out_dtype)),
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


def _ids_held(got_i, want_s, want_i, tol: float):
    """Ids of a top-k against its plain version's top-(k + 1) ``want_s`` /
    ``want_i``: wherever a place's plain score is more than ``tol`` (the
    score tolerance) from both its neighbours, the one below included, the
    ids must be equal; closer places may swap. Returns (held, places
    checked)."""

    import torch

    k = got_i.shape[1]
    inf = torch.full_like(want_s[:, :1], float("inf"))
    up = torch.cat([inf, want_s[:, :k - 1] - want_s[:, 1:k]], 1)
    apart = torch.minimum(up, want_s[:, :k] - want_s[:, 1:k + 1]) > tol
    return bool(torch.equal(got_i[apart], want_i[:, :k][apart])), int(apart.sum())


def phase_b4(n: int, d: int, q: int, per_query: bool, dtype, seed: int, k: int = 50):
    import torch

    from mmrag_tpu_torch.ops import kernels
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
    want_s, want_i = fused_cosine_topk_plain(queries, corpus, mask, k + 1)
    torch.cuda.synchronize()
    max_abs = float((got_s - want_s[:, :k]).abs().max())
    differ = got_i != want_i[:, :k]
    ids_held, ids_checked = _ids_held(got_i, want_s, want_i, 1e-3)
    ok = max_abs <= 1e-3 and ids_held
    bias = torch.where(mask, 0.0, -1e30).float()
    if bias.ndim == 1:
        bias = bias[None, :]

    def library():
        return torch.topk(queries.to(dtype) @ corpus.T + bias, k, dim=-1)

    # phase A alone on the inputs the wrapper hands it (q padded to 8s),
    # timed the same way, so the wrapper's time splits into K-bmax and the
    # torch phases B and C
    qp = max(8, -(-q // 8) * 8)
    qa = torch.nn.functional.pad(queries.to(dtype), (0, 0, 0, qp - q)).contiguous()
    ma = mask[None, :] if mask.ndim == 1 else torch.cat([mask, mask.new_zeros((qp - q, n))])
    phase_a_ms = time_ms(lambda: kernels.bucket_max(qa[:32], corpus, ma[:32]))

    # the function's inputs read once (corpus, bool mask, f32 queries) and its
    # (q, k) scores and ids written once
    nbytes = corpus.numel() * corpus.element_size() + mask.numel() + q * d * 4 + 2 * q * k * 4
    bms, by = bound(2 * q * n * d, nbytes, dtype == torch.bfloat16)
    return {
        "kernel": "B4", "shape": f"{n}x{d} q{q} {'per-query' if per_query else 'shared'} mask",
        "dtype": str(dtype).split(".")[-1], "ok": ok, "max_abs_err": max_abs,
        "ids_differ": int(differ.sum()), "ids_held": ids_held, "ids_checked": ids_checked,
        "kernel_ms": (kms := time_ms(lambda: fused_cosine_topk(queries, corpus, mask, k))),
        "plain_ms": time_ms(lambda: fused_cosine_topk_plain(queries, corpus, mask, k)),
        "library_ms": time_ms(library),
        "bound_ms": bms, "bound_by": by,
        "phase_a_ms": phase_a_ms, "phases_bc_ms": kms - phase_a_ms,
    }


def _kbmax_inputs(n: int, d: int, q: int, per_query: bool, seed: int):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    corpus = torch.randn((n, d), generator=gen, device=dev)
    corpus = (corpus / corpus.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    queries = torch.randn((q, d), generator=gen, device=dev)
    queries = (queries / queries.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    tenants = torch.randint(0, 3, (n,), generator=gen, device=dev)
    if per_query:
        mask = tenants[None, :] == (torch.arange(q, device=dev) % 3)[:, None]
    else:
        mask = (tenants == 0)[None, :]
    return corpus, queries, mask


def phase_kbmax(n: int, d: int, q: int, per_query: bool, seed: int):
    """K-bmax alone (one ``mm_bucket_max`` launch, bf16) against its plain
    version (exact f32 sums of the bf16 products; 1e-4, sums in another
    order) and against one PyTorch composition of the same function,
    ``(q @ c.T + bias).view(q, -1, 128).amax(-1)`` with the mask as an f32
    bias built beforehand (n a multiple of 128)."""

    import torch

    from mmrag_tpu_torch.ops import kernels

    corpus, queries, mask = _kbmax_inputs(n, d, q, per_query, seed)
    got = kernels.bucket_max(queries, corpus, mask)
    want = kernels.bucket_max_plain(queries, corpus, mask)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    bias = torch.where(mask, 0.0, -1e30).float()

    def library():
        return (queries @ corpus.T + bias).view(q, -1, 128).amax(-1)

    nb = -(-n // 128)
    # corpus, mask (1 B an entry), queries read once; the maxima written once
    nbytes = corpus.numel() * 2 + mask.numel() + q * d * 2 + q * nb * 4
    bms, by = bound(2 * q * n * d, nbytes, True)
    return {
        "kernel": "K-bmax", "shape": f"{n}x{d} q{q} {'per-query' if per_query else 'shared'} mask",
        "dtype": "bfloat16", "ok": max_abs <= 1e-4, "max_abs_err": max_abs,
        "kernel_ms": time_ms_batched(lambda: kernels.bucket_max(queries, corpus, mask)),
        "plain_ms": time_ms_batched(lambda: kernels.bucket_max_plain(queries, corpus, mask)),
        "library_ms": time_ms_batched(library),
        "bound_ms": bms, "bound_by": by,
    }


def phase_kbmax_top(n: int, d: int, q: int, per_query: bool, seed: int, k: int = 50):
    """K-bmax's top-k form alone (one ``mm_bucket_topk`` launch, bf16: each
    persistent block's best k of its buckets' ``APPROX_TOP``-row union, X1's
    first kernel) against ``bucket_topk_plain`` at the kernel's grid: scores
    within 1e-4 (sums in another order, as K-bmax), -1e30 and the sentinels
    where the plain lists have them, and the same rows wherever a score is
    more than 1e-4 from its neighbours in the plain list (the list one
    longer gives the neighbour past its end; ``rows_held``). Library:
    ``torch.topk(q @ c.T + bias, k)``, the mask an f32 bias built
    beforehand (the whole search: no one call keeps per-block lists)."""

    import torch

    from mmrag_tpu_torch.ops import kernels

    corpus, queries, mask = _kbmax_inputs(n, d, q, per_query, seed)
    vals, rows = kernels.bucket_topk(queries, corpus, mask, k)
    grid, out_len = vals.shape[1], vals.shape[2]
    want_v, want_r = kernels.bucket_topk_plain(queries, corpus, mask, k, grid)
    below = kernels.bucket_topk_plain(queries, corpus, mask, k + 1, grid)[0][..., out_len:]
    if below.shape[-1] == 0:
        below = torch.full_like(vals[..., :1], float("-inf"))
    torch.cuda.synchronize()
    live = torch.isfinite(want_v)
    max_abs = float((vals[live] - want_v[live]).abs().max())
    up = torch.cat([torch.full_like(want_v[..., :1], float("inf")),
                    want_v[..., :-1] - want_v[..., 1:]], -1)
    gap = torch.minimum(up, want_v - torch.cat([want_v[..., 1:], below[..., :1]], -1))
    dead = want_v == kernels.NEG  # equal -1e30: in row order on both sides
    held_at = ((gap > 1e-4) & live) | dead | ~live
    held = (bool(torch.equal(rows[held_at], want_r[held_at]))
            and bool(torch.equal(torch.isfinite(vals), live))
            and bool(torch.equal(vals == kernels.NEG, dead)))
    bias = torch.where(mask, 0.0, -1e30).float()

    def library():
        return torch.topk(queries @ corpus.T + bias, k, dim=-1)

    # corpus, mask (1 B an entry), queries read once; the blocks' lists written once
    nbytes = corpus.numel() * 2 + mask.numel() + q * d * 2 + q * grid * out_len * 8
    bms, by = bound(2 * q * n * d, nbytes, True)
    return {
        "kernel": "K-bmax-top", "shape": f"{n}x{d} q{q} {'per-query' if per_query else 'shared'} mask",
        "dtype": "bfloat16", "ok": max_abs <= 1e-4 and held, "max_abs_err": max_abs,
        "rows_checked": int(held_at.sum()), "rows_held": held, "k": k, "grid": grid,
        "list_entries": out_len,
        "kernel_ms": time_ms_batched(lambda: kernels.bucket_topk(queries, corpus, mask, k)),
        "plain_ms": time_ms_batched(
            lambda: kernels.bucket_topk_plain(queries, corpus, mask, k, grid), calls=2),
        "library_ms": time_ms_batched(library),
        "bound_ms": bms, "bound_by": by,
    }


def phase_topk_merge(n: int, d: int, q: int, per_query: bool, seed: int, k: int = 50):
    """K-bmax-topk-merge alone (one ``mm_topk_merge`` launch: one block a
    query takes the blocks' lists through pairwise merge levels) on the
    lists K-bmax-top gives at this shape, against ``topk_merge_plain``: a
    selection, so ids and scores equal. ``device_ms``: launches queued
    behind a spin (the wrapper's host time is longer than the kernel).
    Library: ``torch.topk`` of the lists as one row a query."""

    import torch

    from mmrag_tpu_torch.ops import kernels

    corpus, queries, mask = _kbmax_inputs(n, d, q, per_query, seed)
    vals, rows = kernels.bucket_topk(queries, corpus, mask, k)
    got = kernels.topk_merge(vals, rows, k)
    want = kernels.topk_merge_plain(vals, rows, k)
    torch.cuda.synchronize()
    ok = bool(torch.equal(got[0], want[0])) and bool(torch.equal(got[1], want[1]))
    flat = vals.reshape(q, -1)
    # the lists read once, the answer written once
    bms, by = bound(0, vals.numel() * 8 + q * k * 8, True)
    return {
        "kernel": "K-bmax-topk-merge",
        "shape": f"{n}x{d} q{q} {'per-query' if per_query else 'shared'} mask",
        "dtype": "bfloat16", "ok": ok, "max_abs_err": float((got[0] - want[0]).abs().max()),
        "lists": vals.shape[1], "list_entries": vals.shape[2], "k": k,
        "kernel_ms": device_ms(lambda: kernels.topk_merge(vals, rows, k)),
        "plain_ms": time_ms_batched(lambda: kernels.topk_merge_plain(vals, rows, k)),
        "library_ms": device_ms(lambda: torch.topk(flat, k, dim=-1)),
        "bound_ms": bms, "bound_by": by,
    }


def phase_x1(n: int, d: int, q: int, per_query: bool, seed: int, k: int = 50):
    """The approximate search (X1, ``cosine_topk(..., backend="approx")``):
    K-bmax-top, then K-bmax-topk-merge, against the same answer in plain
    torch (one stable sort of the union; scores within 1e-4; ids equal
    wherever the plain score is more than 1e-4 from both neighbours,
    ``_ids_held``) and its recall@k against the exact top-k on these random
    rows; the exact search (B4, ``fused_cosine_topk``) timed beside it on the
    same inputs. Library: ``torch.topk(q @ c.T + bias, k)``."""

    import torch

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.pallas_topk import (
        approx_cosine_topk, approx_cosine_topk_plain, fused_cosine_topk,
    )

    corpus, queries, mask = _kbmax_inputs(n, d, q, per_query, seed)
    mask = mask if per_query else mask[0]
    kernels.reset_launches()
    got_s, got_i = approx_cosine_topk(queries, corpus, mask, k)
    torch.cuda.synchronize()
    launched = {key: v for key, v in kernels.KERNEL_LAUNCHES.items() if v}
    want_s, want_i = approx_cosine_topk_plain(queries, corpus, mask, k + 1)
    bias = torch.where(mask, 0.0, -1e30).float()
    exact = torch.topk(queries.float() @ corpus.float().T + bias, k, dim=-1).indices
    torch.cuda.synchronize()
    max_abs = float((got_s - want_s[:, :k]).abs().max())
    differ = got_i != want_i[:, :k]
    ids_held, ids_checked = _ids_held(got_i, want_s, want_i, 1e-4)
    recall = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                            for a, b in zip(got_i.cpu(), exact.cpu())]))

    def library():
        return torch.topk(queries @ corpus.T + bias, k, dim=-1)

    nbytes = corpus.numel() * 2 + mask.numel() + q * d * 2 + 2 * q * k * 4
    bms, by = bound(2 * q * n * d, nbytes, True)
    kernel_ms = time_ms(lambda: approx_cosine_topk(queries, corpus, mask, k))
    exact_ms = time_ms(lambda: fused_cosine_topk(queries, corpus, mask, k))
    return {
        "kernel": "X1", "shape": f"{n}x{d} q{q} {'per-query' if per_query else 'shared'} mask",
        "dtype": "bfloat16",
        "ok": (max_abs <= 1e-4 and ids_held and recall >= 0.95
               and launched == {"K-bmax-top": 1, "K-bmax-topk-merge": 1}),
        "max_abs_err": max_abs, "ids_differ": int(differ.sum()), "ids_held": ids_held,
        "ids_checked": ids_checked, "recall_at_k": recall, "k": k, "launches": launched,
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: approx_cosine_topk_plain(queries, corpus, mask, k)),
        "library_ms": time_ms(library), "exact_b4_ms": exact_ms,
        "faster_than_exact": kernel_ms < exact_ms,
        "bound_ms": bms, "bound_by": by,
    }


def phase_kgemm(m: int, k: int, n: int, epi: str, resid: bool, seed: int):
    """K-gemm alone (one ``mm_gemm`` launch, bf16 in and out) against its
    plain version (2 bf16 ulps of the output's scale: f32 sums in another
    order, then one rounding) and against ``F.linear`` at the same shape:
    the product alone, without the bias, activation or residual."""

    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((m, k), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((k, n), generator=gen) * k ** -0.5).to(dev, torch.bfloat16)
    b = (torch.randn((n,), generator=gen) * 0.02).to(dev)
    r = torch.randn((m, n), generator=gen).to(dev, torch.bfloat16) if resid else None
    got = kernels.gemm(a, w, b, r, epi)
    want = kernels.gemm_plain(a, w, b, r, epi)
    torch.cuda.synchronize()
    max_abs = float((got.float() - want.float()).abs().max())
    tol = 2 * 2 ** -8 * max(float(want.float().abs().max()), 1.0)
    flops = 2 * m * n * k
    nbytes = 2 * (m * k + k * n + m * n * (2 if resid else 1)) + 4 * n
    bms, by = bound(flops, nbytes, True)
    kms = time_ms_batched(lambda: kernels.gemm(a, w, b, r, epi))
    lms = time_ms_batched(lambda: F.linear(a, w.T))
    return {
        "kernel": "K-gemm", "shape": f"{m}x{k}->{n} {epi}{' +residual' if resid else ''}",
        "dtype": "bfloat16", "ok": max_abs <= tol, "max_abs_err": max_abs,
        "kernel_ms": kms, "plain_ms": time_ms_batched(lambda: kernels.gemm_plain(a, w, b, r, epi)),
        "library_ms": lms, "bound_ms": bms, "bound_by": by,
        "tflops": flops / kms / 1e9, "library_tflops": flops / lms / 1e9,
    }


def phase_kgemm_i8(m: int, k: int, n: int, epi: str, resid: bool, out_dtype, seed: int):
    """K-gemm-i8 alone (one ``mm_gemm_i8`` launch) at a product of B6 or B7,
    with that product's output dtype and a bf16 residual where it has one,
    against its plain version (bit for bit without an activation: an exact
    int32 sum and the same rounded steps; with one, its transcendental within
    an ulp, so 2 ulps of the output's scale) and against ``torch._int_mm``
    of the product alone (cuBLASLt int8, the int32 sum without the epilogue).
    The weight comes from ``quant.quantize_weight``, in the layout the
    wrapper takes; ``_int_mm`` gets it column-major."""

    import torch

    from mmrag_tpu_torch.ops import kernels, quant

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    aq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).to(dev)
    qlin = quant.quantize_weight(torch.randn((k, n), generator=gen) * k ** -0.5)
    wq, w_scale = qlin["q"].to(dev), qlin["scale"].to(dev)
    a_scale = (torch.rand((m,), generator=gen) * 0.02 + 1e-3).to(dev)
    b = (torch.randn((n,), generator=gen) * 0.02).to(dev)
    r = torch.randn((m, n), generator=gen).to(dev, torch.bfloat16) if resid else None
    got = kernels.gemm_i8(aq, a_scale, wq, w_scale, b, r, epi, out_dtype)
    want = kernels.gemm_i8_plain(aq, a_scale, wq, w_scale, b, r, epi, out_dtype)
    torch.cuda.synchronize()
    max_abs = float((got.float() - want.float()).abs().max())
    if epi == "none":
        ok = bool(torch.equal(got, want))
    else:
        ulp = 2 ** -8 if out_dtype == torch.bfloat16 else 2 ** -23
        ok = max_abs <= 2 * ulp * max(float(want.float().abs().max()), 1.0)
    w_cm = wq.t().contiguous().t()  # column-major (K, N): _int_mm's layout
    ops = 2 * m * n * k
    out_item = torch.empty((), dtype=out_dtype).element_size()
    nbytes = m * k + k * n + m * n * (out_item + (2 if resid else 0)) + 4 * m + 8 * n
    bms, by = bound(0.0, nbytes, True, int8_ops=ops)
    kms = time_ms_batched(lambda: kernels.gemm_i8(aq, a_scale, wq, w_scale, b, r, epi, out_dtype))
    lms = time_ms_batched(lambda: torch._int_mm(aq, w_cm))
    return {
        "kernel": "K-gemm-i8", "shape": f"{m}x{k}->{n} {epi}{' +residual' if resid else ''}",
        "dtype": _dt(out_dtype), "ok": ok, "max_abs_err": max_abs, "kernel_ms": kms,
        "plain_ms": time_ms_batched(
            lambda: kernels.gemm_i8_plain(aq, a_scale, wq, w_scale, b, r, epi, out_dtype), 2, 3),
        "library_ms": lms, "bound_ms": bms, "bound_by": by,
        "tops": ops / kms / 1e9, "library_tops": ops / lms / 1e9,
    }


def phase_kquant(rows: int, h: int, dtype, seed: int, ln: bool = False):
    """K-quant alone (one ``mm_row_quant`` launch): per-row int8 codes and f32
    scales of a (rows, h) stream, or of its f32 LayerNorm (``ln``, the pre-LN
    blocks), against ``_lib_quant`` (PyTorch ops, after ``F.layer_norm``)
    and its byte bound (the rows and the LayerNorm vectors read once, the
    codes and scales written once). Without LayerNorm the codes and scales
    are bit for bit the plain version's (true division, half-to-even
    rounding); with it the statistics are summed in another order, so a
    value within an ulp of a code boundary may take the next code (at most
    1 apart, at most 1 in 1000, scales within 1e-5), as in
    ``tests/test_torch_cuda.py::test_row_quant``."""

    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((rows, h), generator=gen) * 3).to(dev, dtype)
    args = ()
    if ln:
        args = ((torch.randn((h,), generator=gen) * 0.1 + 1).to(dev),
                (torch.randn((h,), generator=gen) * 0.02).to(dev), 1e-5)
    q, scale = kernels.row_quant(x, *args)
    wq, wscale = kernels.row_quant_plain(x, *args)
    torch.cuda.synchronize()
    differ = (q.int() - wq.int()).abs()
    if ln:
        ok = (int(differ.max()) <= 1 and int(differ.sum()) <= max(1, q.numel() // 1000)
              and bool(torch.allclose(scale, wscale, rtol=1e-5, atol=0)))
    else:
        ok = bool(torch.equal(q, wq)) and bool(torch.equal(scale, wscale))
    nbytes = rows * h * (x.element_size() + 1) + rows * 4 + (8 * h if ln else 0)
    bms, by = bound(0.0, nbytes, True)

    def library():
        a = x.float()
        if ln:
            a = F.layer_norm(a, (h,), args[0], args[1], args[2])
        return _lib_quant(a)

    return {
        "kernel": "K-quant", "shape": f"{rows}x{h}{' pre-LN' if ln else ''}", "dtype": _dt(dtype),
        "ok": ok, "codes_differ": int((differ > 0).sum()),
        "max_abs_err": float((scale - wscale).abs().max()),
        "kernel_ms": time_ms_batched(lambda: kernels.row_quant(x, *args)),
        "device_ms": device_ms(lambda: kernels.row_quant(x, *args)),
        "plain_ms": time_ms_batched(lambda: kernels.row_quant_plain(x, *args)),
        "library_ms": time_ms_batched(library),
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
    # q, k, v read once, the context written once, the f32 (b, s, s) bias;
    # the live (query, key) pairs are those the bias leaves above -1e8
    nbytes = 4 * b * s * h * item + b * s * s * 4
    pairs = int((bias > -1e8).sum())
    bms, by = bound(4 * pairs * h, nbytes, bf16, exps=pairs * nh)
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
    pairs = _live_pairs(mask)
    bms, by = bound(4 * pairs * h, nbytes, bf16, int8_ops=8 * rows * h * h, exps=pairs * nh)
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


def phase_b12(b: int, s: int, h: int, nh: int, dtype, seed: int):
    """B12 over three separate (b*s, h) tensors: K-attn alone in its key-row
    mode (at 128 x 512 h 384, the rerank's attention). Keys live: uniform
    lengths s/4..s, as B1's phase."""

    import torch
    import torch.nn.functional as F

    from mmrag_tpu_torch.ops.attention import (
        fused_encoder_attention2d, fused_encoder_attention2d_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b * s, h), generator=gen).to(dev, dtype) for _ in range(3))
    lengths = torch.randint(s // 4, s + 1, (b,), generator=gen)
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
    args = (q, k, v, nh, s, mask)
    got = fused_encoder_attention2d(*args)
    want = fused_encoder_attention2d_plain(*args)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    real = mask.reshape(-1).bool()
    ok, max_abs, mean_abs = _ln_ok(got[real], want[real], bf16)
    hd = h // nh
    attn_mask = mask.bool()[:, None, None, :]

    def heads(t):
        return t.view(b, s, nh, hd).transpose(1, 2)

    def library():
        ctx = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=attn_mask)
        return ctx.transpose(1, 2).reshape(b * s, h)

    pairs = _live_pairs(mask)
    # q, k, v read once, the context written once, the int32 mask
    nbytes = 4 * b * s * h * q.element_size() + b * s * 4
    bms, by = bound(4 * pairs * h, nbytes, bf16, exps=pairs * nh)
    return {
        "kernel": "B12", "shape": f"{b}x{s} h{h}", "dtype": _dt(dtype), "ok": ok,
        "max_abs_err": max_abs, "mean_abs_err": mean_abs,
        "live_key_share": pairs / (b * s * s),
        "kernel_ms": time_ms(lambda: fused_encoder_attention2d(*args)),
        "plain_ms": time_ms(lambda: fused_encoder_attention2d_plain(*args)),
        "library_ms": time_ms(library), "bound_ms": bms, "bound_by": by,
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
    dms = device_ms(lambda: pallas_probe_scores(*args))
    return {
        "kernel": "B8", "shape": f"q{q} nprobe{nprobe} C{C} B{B} d{d}", "dtype": _dt(dtype),
        "probed_blocks": blocks, "ok": ok, "max_abs_err": max_abs, "tol": tol,
        "kernel_ms": time_ms(lambda: pallas_probe_scores(*args)),
        "device_ms": dms, "bound_share": bms / dms,
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
    dms = device_ms(lambda: pallas_probe_scores_q(*args))
    return {
        "kernel": "B9", "shape": f"q{q} nprobe{nprobe} C{C} B{B} d{d}", "dtype": "int8",
        "probed_blocks": blocks, "ok": ok, "max_abs_err": float((gs[fin] - ws[fin]).abs().max()),
        "raw_bitwise": raw_ok,
        "kernel_ms": time_ms(lambda: pallas_probe_scores_q(*args)),
        "device_ms": dms, "bound_share": bms / dms,
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
        "kernel_ms": time_ms_batched(lambda: kernels.adc_bucket_max(tables, codes, bias)),
        "device_ms": device_ms(lambda: kernels.adc_bucket_max(tables, codes, bias)),
        "plain_ms": time_ms_batched(lambda: kernels.adc_bucket_max_plain(tables, codes, bias),
                                    2, 3),
        "library_ms": time_ms_batched(lambda: _adc_library(tables, codes_t, bias, True)),
        "bound_ms": bms, "bound_by": by,
        # the shared-memory floor: every bf16 entry looked up once, at the
        # banks' full rate (random codes hit random banks, so more in fact)
        "lookup_floor_ms": n * m * q * 2 / H100_SMEM * 1e3,
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
    dms = device_ms(lambda: kernels.adc_rescore(tables, codes, bias))
    return {
        "kernel": "B11", "shape": f"q{q} m{m} S{S}{' shared' if shared else ''}",
        "dtype": "bfloat16", "ok": ok, "max_abs_err": float((got - want).abs().max()),
        "kernel_ms": time_ms(lambda: kernels.adc_rescore(tables, codes, bias)),
        "device_ms": dms, "bound_share": bms / dms,
        "plain_ms": time_ms(lambda: kernels.adc_rescore_plain(tables, codes, bias)),
        "library_ms": time_ms(lambda: _adc_library(tables, codes, bias, False)),
        "bound_ms": bms, "bound_by": by,
        # every bf16 entry looked up once at the banks' full rate, as B10's
        "lookup_floor_ms": q * S * m * 2 / H100_SMEM * 1e3,
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
    port = {}  # the port's own kernels (csrc/*.cu), all template instances summed
    for ms, key, n in rows:
        if key.startswith("void (anonymous namespace)::"):
            name = key.split("::")[1].split("<")[0].split("(")[0]
            if name.endswith("_kernel"):
                ms0, n0 = port.get(name, (0.0, 0))
                port[name] = (ms0 + ms, n0 + n)
    tag = "int8" if engine.runtime.quant else "bf16"
    emit({"phase": f"profile {tag}", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "port_kernels": {k: {"ms": ms, "calls": n} for k, (ms, n) in port.items()},
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


class _SearchSplit:
    """The ``retrieve.search`` stage of one coalesced call, split apart
    (R15), read from the program's span ring for the call: each index's
    journal check (``index.replay``), its dispatch (``index.dispatch``), its
    readback's wait for the device work queued before it (``index.wait``)
    and the host merge (``index.collect``); from the first dispatch to the
    end of the last wait (``device_ms_dispatch_to_done``, on the host's
    clock: the wait ends when the card is done); Python's garbage
    collection while the call runs (the ring's ``gc`` records); and, from
    outside, the threads alive at its start and the caching allocator's
    retries, cudaMalloc / cudaFree calls and reserved memory across the
    call."""

    PARTS = ("replay", "dispatch", "wait", "collect")

    def __init__(self, engine) -> None:
        self.keys = {engine.text_index.name: "text", engine.image_index.name: "image"}

    @staticmethod
    def _memory() -> dict:
        import torch

        stats = torch.cuda.memory_stats()
        return {key: stats.get(key, 0) for key in (
            "num_alloc_retries", "num_device_alloc", "num_device_free", "num_sync_all_streams",
            "reserved_bytes.all.current", "allocated_bytes.all.current")}

    def __enter__(self):
        import gc

        self.threads = sorted(t.name for t in threading.enumerate())
        self.memory_before = self._memory()
        # what a full collection would traverse, and what is frozen out of it
        self.gc_heap = {"tracked": len(gc.get_objects()), "frozen": gc.get_freeze_count()}
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        from mmrag_tpu_torch.utils import profiling

        self.t1 = time.monotonic()
        self.memory_after = self._memory()
        self.spans = [r for r in profiling.records() if self.t0 <= r[5] and r[6] <= self.t1]

    def report(self) -> dict:
        ms = {f"{part}_{key}": 0.0 for key in self.keys.values() for part in self.PARTS}
        gc_ms, gc_runs, dispatched, done = 0.0, 0, [], []
        for _, _, _, name, _, start, end, _, attrs in self.spans:
            if name == "gc":
                gc_ms += (end - start) * 1e3
                gc_runs += 1
                continue
            layer, _, part = name.partition(".")
            key = self.keys.get(dict(attrs or ()).get("index"))
            if layer != "index" or part not in self.PARTS or key is None:
                continue
            ms[f"{part}_{key}"] += (end - start) * 1e3
            if part == "dispatch":
                dispatched.append(start)
            elif part == "wait":
                done.append(end)
        device = (max(done) - min(dispatched)) * 1e3 if dispatched and done else 0.0
        before, after = self.memory_before, self.memory_after
        return {**ms, "device_ms_dispatch_to_done": device, "gc_ms": gc_ms,
                "gc_runs": gc_runs, "gc_heap": self.gc_heap, "threads": self.threads,
                # the caching allocator across the call: a retry frees every
                # cached block (a device-wide sync) before cudaMalloc again
                "alloc_retries": after["num_alloc_retries"] - before["num_alloc_retries"],
                "cuda_mallocs": after["num_device_alloc"] - before["num_device_alloc"],
                "cuda_frees": after["num_device_free"] - before["num_device_free"],
                "syncs_all_streams": (after["num_sync_all_streams"]
                                      - before["num_sync_all_streams"]),
                "reserved_gb_before": before["reserved_bytes.all.current"] / 2 ** 30,
                "allocated_gb_before": before["allocated_bytes.all.current"] / 2 ** 30}


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
    with _SearchSplit(engine) as split:
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
    return {"tag": tag, "batch_ms": batch_ms, "stages": stages, "search_split": split.report(),
            "single_ms": single_ms,
            "per_query": per_query, "serve_launches": serve_launches, "items": items,
            "singles": singles, "with_images": sum(bool(p["images"]) for _, _, p in checked)}


def _final4(payload) -> list:
    return [hit["chunk_id"] for hit in payload["results"]]


def restart_check(rv, engine, cfg, runtime, singles) -> None:
    """``persist_indexes``, then a second ``RagEngine`` over the same
    directory (snapshots loaded, the journal attached) must hold the same
    rows and answer the single ``retrieve`` calls with the same final 4."""

    import torch

    from mmrag_tpu_torch.cache import clear_all_caches
    from mmrag_tpu_torch.rag.engine import RagEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.persist_indexes()
    save_s = time.perf_counter() - t0
    clear_all_caches()  # the second engine must answer from its own indexes
    t0 = time.perf_counter()
    second = RagEngine(cfg, runtime)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rows = {name: (len(getattr(engine, name)), len(getattr(second, name)))
            for name in ("text_index", "image_index")}
    answers = []
    for i, (tenant, _, payload) in enumerate(singles):
        again = rv.retrieve(tenant, f"single {TOPICS[i]}", second)
        answers.append((_final4(payload), _final4(again)))
    emit({"phase": "restart int8", "save_s": save_s, "load_s": load_s, "rows": rows,
          "journal": second.journal is not None,
          "final4_before_after": answers})
    second.close()
    clear_all_caches()
    if any(a != b for a, b in rows.values()):
        raise AssertionError(f"rows lost across the restart: {rows}")
    if any(not before or before != after for before, after in answers):
        raise AssertionError(f"the restarted engine answers otherwise: {answers}")


def _launches() -> dict:
    """The B1-B12 counts and the building kernels' (K-gemm, K-quant, ...)."""

    from mmrag_tpu_torch.ops import kernels

    return {**kernels.LAUNCHES, **getattr(kernels, "KERNEL_LAUNCHES", {})}


# the kernels each pass of the main path must launch while serving, and those
# it must not launch anywhere (every block of a quantized tower is W8A8)
SERVE_LAUNCHES = {False: ("B1", "B2", "B4", "B5"), True: ("B4", "B5", "B6", "B7")}
NEVER_LAUNCHED = {False: ("B6", "B7", "B8", "B9", "B10", "B11", "B12"),
                  True: ("B1", "B2", "B3", "B8", "B9", "B10", "B11", "B12")}


def _engine_env(tmp: str, **extra) -> dict:
    return {
        "TPU_INDEX_DIR": os.path.join(tmp, "index"),
        "NOTES_DB_PATH": os.path.join(tmp, "notes.db"),
        "WEIGHTS_DIR": os.environ.get("WEIGHTS_DIR") or os.path.join(tmp, "weights"),
        "TPU_MICROBATCH_WINDOW_MS": "0",
        **extra,
    }


def main_path(args_depth: dict, seed: int, quant: bool = False, bf16_runtime=None,
              profile: bool = False, journal=None):
    """One pass of the main path; returns its launch counts and its runtime.
    ``quant`` runs it with ``TPU_ENCODER_QUANT=int8`` and then holds its towers
    against the port's int8 towers on the CPU and against ``bf16_runtime``'s.
    ``journal`` keeps the index journal (default: in the int8 pass only)."""

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
    # the int8 pass keeps the index journal (the default) and checks a
    # restart; the bf16 pass's synthetic fill of 1M rows is not journaled
    journal = quant if journal is None else journal
    env = _engine_env(tmp, TPU_ENCODER_QUANT="int8" if quant else "",
                      TPU_INDEX_JOURNAL="1" if journal else "0")
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
    main_launches = _launches()  # this whole pass, read just after it
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
          "search_split_ms": served["search_split"], "single_ms": served["single_ms"],
          "chat_latency_median_ms": float(np.median(served["single_ms"])),
          "launches_per_chat_query": served["per_query"], "launches_serve": serve_launches,
          "launches_main_path": main_launches})
    if profile:
        profile_serving(rv, engine, served["items"])
    if quant:
        restart_check(rv, engine, cfg, runtime, served["singles"])
        reference_int8(cfg, env, runtime, bf16_runtime, nodes, images, TOPICS)
        engine.close()
        shutil.rmtree(tmp, ignore_errors=True)  # its snapshots and journal
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


# ---------------------------------------------------------------------------
# the served path: HTTP API, coalescing batchers, grounded answers, ingest
# ---------------------------------------------------------------------------

SERVE_KEYS = {"key-a": "tenant-a", "key-b": "tenant-b"}
SERVE_FILL = {"text": 1 << 18, "image": 1 << 16}  # seeded rows, half each tenant's
SERVE_CHATS, SERVE_THREADS = 32, 16
# final 4 of a coalesced /chat_pro vs a direct retrieve_batch of the same
# query: the batch shapes differ, so bf16 sums may differ a little; pairs the
# direct call ranks further apart than this (fused z-score units) keep order
SERVE_TIE = 0.05
HIST_TOL = 1e-6  # the card's HSV histograms vs the port's on the CPU


def _pdf_bytes(pages) -> bytes:
    """A small valid PDF with one Flate-compressed text stream a page (the
    port's pure-Python reader parses it; no PDF library needed)."""

    import zlib

    objects, kids, next_id = [], [], 3
    for text in pages:
        comp = zlib.compress(f"BT /F1 12 Tf 72 720 Td ({text}) Tj ET".encode())
        kids.append(next_id)
        objects.append((next_id, f"<< /Type /Page /Parent 2 0 R /Contents {next_id + 1} 0 R >>"
                        .encode()))
        objects.append((next_id + 1, b"<< /Filter /FlateDecode /Length " + str(len(comp)).encode()
                        + b" >>\nstream\n" + comp + b"\nendstream"))
        next_id += 2
    refs = " ".join(f"{k} 0 R" for k in kids)
    body = b"%PDF-1.4\n"
    for num, payload in [(1, b"<< /Type /Catalog /Pages 2 0 R >>"),
                         (2, f"<< /Type /Pages /Kids [{refs}] /Count {len(kids)} >>".encode())
                         ] + objects:
        body += f"{num} 0 obj\n".encode() + payload + b"\nendobj\n"
    return body + b"%%EOF"


class _Client:
    """One keep-alive HTTP/1.1 connection to the server (``http.client``)."""

    def __init__(self, port: int, key: str):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        self.key = key

    def call(self, method: str, path: str, body=None, headers=None):
        hdrs = {"X-API-Key": self.key, **(headers or {})}
        if isinstance(body, dict):
            body = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        self.conn.request(method, path, body=body, headers=hdrs)
        res = self.conn.getresponse()
        data = res.read()
        return res.status, (json.loads(data) if data else None)

    def upload_pdf(self, filename: str, data: bytes):
        boundary = "chipsmoke" + os.urandom(8).hex()
        body = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                f'filename="{filename}"\r\nContent-Type: application/pdf\r\n\r\n').encode()
        body += data + f"\r\n--{boundary}--\r\n".encode()
        return self.call("POST", "/process-pdf/", body,
                         {"Content-Type": f"multipart/form-data; boundary={boundary}"})

    def close(self):
        self.conn.close()


def _video_stack(rng, scenes: int = 8, per_scene: int = 8) -> np.ndarray:
    """(scenes x per_scene, 720, 1280, 3) uint8: runs of near-duplicate frames
    (a textured scene plus pixel noise), so the pHash dedup drops frames."""

    stack = np.empty((scenes * per_scene, 720, 1280, 3), np.uint8)
    for s in range(scenes):
        blocks = rng.integers(0, 255, (8, 8, 3)).astype(np.int16)
        base = np.kron(blocks, np.ones((90, 160, 1), np.int16))
        for j in range(per_scene):
            noise = rng.integers(-4, 5, base.shape, dtype=np.int16)
            stack[s * per_scene + j] = np.clip(base + noise, 0, 255)
    return stack


def _hold_x3(stack, rng) -> dict:
    """X3 and the scene histograms on the card against the port on the CPU:
    pHash bits, Hamming distances and kept indices identical, histograms
    within ``HIST_TOL``; each timed on the card."""

    import torch

    from mmrag_tpu_torch.ingest import frames as fr
    from mmrag_tpu_torch.ops import phash

    dev = torch.device("cuda")
    bits_card, bits_cpu, hist_err = [], [], 0.0
    for lo in range(0, len(stack), phash._PHASH_CHUNK):
        chunk = torch.from_numpy(stack[lo: lo + phash._PHASH_CHUNK])
        bits_card.append(phash.phash_batch(chunk.to(dev)).cpu())
        bits_cpu.append(phash.phash_batch(chunk))
        h_card = fr._hsv_histograms(chunk.to(dev)).cpu()
        hist_err = max(hist_err, float((h_card - fr._hsv_histograms(chunk)).abs().max()))
    bits_card, bits_cpu = torch.cat(bits_card), torch.cat(bits_cpu)
    # 2,000 hashes: the 64 frames' hashes with up to 8 bits flipped each
    base = bits_cpu.numpy()[rng.integers(0, len(stack), 2000)]
    flips = rng.random(base.shape) < rng.integers(0, 9, (2000, 1)) / 64.0
    bits2k = torch.from_numpy(np.abs(base - flips).astype(np.float32))
    d_card = phash.hamming_matrix(bits2k.to(dev))
    d_cpu = phash.hamming_matrix(bits2k)
    keep_card = phash.greedy_dedup_mask(d_card, 6.0).cpu()
    keep_cpu = phash.greedy_dedup_mask(d_cpu, 6.0)
    chunk = torch.from_numpy(stack[: phash._PHASH_CHUNK]).to(dev)
    bits_dev = bits2k.to(dev)
    times = {  # device-resident inputs
        "phash_batch_32x720p_ms": time_ms(lambda: phash.phash_batch(chunk), repeats=9),
        "hsv_histograms_32x720p_ms": time_ms(lambda: fr._hsv_histograms(chunk), repeats=9),
        "hamming_matrix_2000_ms": time_ms(lambda: phash.hamming_matrix(bits_dev), repeats=9),
    }
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        phash.greedy_dedup_mask(phash.hamming_matrix(bits_dev), 6.0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    times["hamming_plus_greedy_2000_wall_ms"] = float(np.median(walls))
    out = {"phase": "serve http x3", "frames": len(stack),
           "bits_equal": bool(torch.equal(bits_card, bits_cpu)),
           "hamming_equal": bool(torch.equal(d_card.cpu(), d_cpu)),
           "kept_equal": bool(torch.equal(keep_card, keep_cpu)),
           "kept_of_2000": int(keep_cpu.sum()), "hist_max_abs_err": hist_err, **times}
    emit(out)
    if not (out["bits_equal"] and out["hamming_equal"] and out["kept_equal"]):
        raise AssertionError(f"X3 on the card differs from the CPU: {out}")
    if not hist_err <= HIST_TOL:
        raise AssertionError(f"HSV histograms on the card off by {hist_err}")
    return out


def serve_http_pass(seed: int, runtime, smi: str) -> dict:
    """The served path under the default serving settings (window 4 ms, up to
    16 a batch, 3 runners), through ``mmrag_tpu_torch.serving.http`` on
    ``runtime`` (the bf16 pass's full-width encoders): fill both indexes with
    two tenants' seeded rows, warm up, start the server with a job queue and
    the device watchdog, ingest a PDF for each tenant and one YouTube job
    (its network stages replaced; scene scores and pHash dedup on the card
    over a seeded 64-frame 720p stack), then 32 concurrent ``/chat_pro``
    calls from 16 threads. Checks health, payloads, tenant isolation, the
    final 4 against a direct ``retrieve_batch``, coalescing and launches;
    holds X3 and the histograms against the CPU. Returns the phase's
    launches."""

    import threading

    import torch

    from mmrag_tpu_torch.cache import clear_all_caches
    from mmrag_tpu_torch.ingest.frames import ExtractedFrame, select_scene_frames
    from mmrag_tpu_torch.ingest.youtube import TranscriptSegment
    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.rag import retrieve as rv
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.serving import tasks
    from mmrag_tpu_torch.serving.http import make_server
    from mmrag_tpu_torch.serving.jobs import LocalJobQueue
    from mmrag_tpu_torch.settings import load_settings
    from mmrag_tpu_torch.storage.records import VectorRow
    from mmrag_tpu_torch.utils import watchdog
    from mmrag_tpu_torch.utils.profiling import metrics

    rng = np.random.default_rng(seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    env = _engine_env(tmp, INGEST_CACHE_DIR=os.path.join(tmp, "cache"),
                      MEDIA_DIR=os.path.join(tmp, "media"), TPU_INDEX_JOURNAL="1",
                      API_KEYS=json.dumps(SERVE_KEYS), RATE_LIMIT_PER_MIN="100000",
                      YT_LAZY_FRAMES="0")
    del env["TPU_MICROBATCH_WINDOW_MS"]  # the default serving settings hold
    cfg = load_settings(env)
    tpu = cfg.tpu
    if (tpu.microbatch_window_ms, tpu.microbatch_max, tpu.microbatch_workers) != (4.0, 16, 3):
        raise AssertionError(f"not the default batcher settings: {tpu}")
    clear_all_caches()
    engine = RagEngine(cfg, runtime)
    tenants = list(SERVE_KEYS.values())
    t0 = time.perf_counter()
    for index, total, dim in ((engine.text_index, SERVE_FILL["text"], runtime.text_dim),
                              (engine.image_index, SERVE_FILL["image"], runtime.clip_dim)):
        step = 65536
        while index._size < total:
            n = min(step, total - index._size)
            vecs = rng.standard_normal((n, dim), dtype=np.float32)
            base = index._size
            index.upsert([
                VectorRow(chunk_id=f"fill-{dim}-{base + i}", user_id=tenants[(base + i) % 2],
                          document_id=f"fill-doc{(base + i) % 997}", modality="text",
                          embedding=vecs[i])
                for i in range(n)
            ])
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0

    kernels.reset_launches()  # this phase of the main path starts here
    t0 = time.perf_counter()
    warm = engine.warmup_serving()  # raises on a build or launch fault
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    after_warm = _launches()
    emit({"phase": "serve http warmup", "dispatches": warm, "seconds": warm_s,
          "fill_s": fill_s, "text_rows": engine.text_index._size,
          "image_rows": engine.image_index._size, "launches": after_warm})

    queue = LocalJobQueue(os.path.join(tmp, "jobs.db"), workers=1)
    server = make_server("127.0.0.1", 0, cfg=cfg, engine=engine, queue=queue)
    port = server.server_address[1]
    ctx = server.ctx
    video_id = "sm0keV1deo0"
    stack = _video_stack(rng)
    stamps = [5.0 * i for i in range(len(stack))]
    kept_seen = []

    def info_fn(url, cfg_):  # the network stages (metadata, captions) replaced
        return {"video_id": video_id, "title": "Warehouse lifting safety", "duration": 320}

    def ladder_fn(url, work_dir, cfg_, **kwargs):
        words = [" ".join(rng.choice(_WORDS, 24)) for _ in range(12)]
        return {"video_id": video_id, "source": "transcript",
                "video_path": os.path.join(work_dir, "video.mp4"),
                "segments": [TranscriptSegment(w, 5.0 * i, 5.0) for i, w in enumerate(words)]}

    def frames_fn(user_id, document_id, video_path, cfg_, return_arrays=True, device=None):
        # decode replaced by the seeded stack; scene scores and dedup on the card
        kept = select_scene_frames(stack, cfg_.youtube.frame_dedup_delta,
                                   cfg_.youtube.max_frames, device)
        kept_seen.append(kept)
        frames = [ExtractedFrame(path=f"{video_id}/frame_{r:04d}_{stamps[i]:.1f}.jpg",
                                 ts=stamps[i]) for r, i in enumerate(kept)]
        return frames, [stack[i] for i in kept]

    ctx.queue.register("ingest_youtube", lambda progress, user_id, url: tasks.ingest_youtube_task(
        progress, user_id=user_id, url=url, engine=engine, kv=ctx.kv, info_fn=info_fn,
        ladder_fn=ladder_fn, frames_fn=frames_fn))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    watchdog.start_watchdog(1.0)
    metrics.reset()  # the server's stage timings, from here
    clients = {t: _Client(port, k) for k, t in SERVE_KEYS.items()}
    try:
        deadline = time.monotonic() + 30
        while True:  # the watchdog's first probe
            status, health = clients["tenant-a"].call("GET", "/healthz")
            if status == 200 and health["device"] == "ok":
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"/healthz never reported the device ok: {health}")
            time.sleep(0.2)

        docs = {t: set() for t in tenants}
        pdf_s = {}
        for t in tenants:
            pages = [f"{t} page {p} " + " ".join(rng.choice(_WORDS, 90)) for p in range(8)]
            t1 = time.perf_counter()
            status, out = clients[t].upload_pdf(f"{t}-report.pdf", _pdf_bytes(pages))
            pdf_s[t] = time.perf_counter() - t1
            if status != 200 or out["document_status"] != "ready" or out["text_nodes"] < 8:
                raise AssertionError(f"PDF ingest for {t} failed: {status} {out}")
            docs[t].add(out["document_id"])

        t1 = time.perf_counter()
        status, job = clients["tenant-a"].call("POST", "/ingest/youtube",
                                               {"url": f"https://youtu.be/{video_id}"})
        if status != 202:
            raise AssertionError(f"YouTube enqueue failed: {status} {job}")
        deadline = time.monotonic() + 300
        while True:
            status, st = clients["tenant-a"].call("GET", f"/yt_status/{job['job_id']}")
            if st["state"] in ("SUCCESS", "FAILURE") or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        video_s = time.perf_counter() - t1
        if st["state"] != "SUCCESS" or st["pct"] != 100:
            raise AssertionError(f"YouTube job did not succeed: {st}")
        kept = kept_seen[0]
        if not (2 <= len(kept) < len(stack)) or st["image_nodes"] != len(kept):
            raise AssertionError(f"the dedup kept {len(kept)} of {len(stack)} frames: {st}")
        status, notes = clients["tenant-a"].call("GET", f"/videos/{video_id}/notes")
        if status != 200 or not notes.get("summary") or not notes.get("quiz"):
            raise AssertionError(f"no notes for the video: {status} {notes}")
        docs["tenant-a"].add(video_id)
        after_ingest = _launches()

        queries = [(tenants[i % 2], f"{TOPICS[i % 4]} served {i}") for i in range(SERVE_CHATS)]
        answers, walls = [None] * SERVE_CHATS, [0.0] * SERVE_CHATS
        start = threading.Barrier(SERVE_THREADS)
        errors = []

        def ask(w: int):
            client = _Client(port, [k for k, t in SERVE_KEYS.items()
                                    if t == queries[w][0]][0])
            try:
                start.wait()
                for i in range(w, SERVE_CHATS, SERVE_THREADS):
                    t2 = time.perf_counter()
                    answers[i] = client.call("POST", "/chat_pro", {"query": queries[i][1]})
                    walls[i] = (time.perf_counter() - t2) * 1e3
            except Exception as exc:  # re-raised below, in the main thread
                errors.append(exc)
            finally:
                client.close()

        threads = [threading.Thread(target=ask, args=(w,)) for w in range(SERVE_THREADS)]
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        chat_s = time.perf_counter() - t1
        if errors:
            raise errors[0]
        after_chat = _launches()
        batch_sizes = dict(engine.retrieval_batcher.batch_sizes)
        stages = metrics.summary()["latency_ms"]

        keys = {"response", "answer", "citations", "citation_tokens", "snippets",
                "abstained", "results", "index_version"}
        for (tenant, query), (status, payload) in zip(queries, answers):
            if status != 200 or not keys <= set(payload) or not payload["results"]:
                raise AssertionError(f"/chat_pro for {tenant} {query!r}: {status} {payload}")
            if set(payload["citations"]) != {"text", "images"}:
                raise AssertionError(f"citations not in the reference shape: {payload}")
            for hit in payload["results"]:
                if hit["user_id"] != tenant or hit["document_id"] not in docs[tenant]:
                    raise AssertionError(f"hit of {hit['user_id']}/{hit['document_id']} "
                                         f"served to {tenant}")
            for tok in payload["citation_tokens"]:
                if tok["document_id"] not in docs[tenant]:
                    raise AssertionError(f"{tenant} cited {tok}")
                if not (tok["token"].startswith(f"[doc:{tok['document_id']}")
                        or tok["token"].startswith("[ts:")):
                    raise AssertionError(f"citation token {tok['token']} names no document")
        if max(batch_sizes) <= 1:
            raise AssertionError(f"no request coalesced: {batch_sizes}")
        clear_all_caches()
        step = tpu.microbatch_max  # the batcher's largest batch
        direct = [p for lo in range(0, SERVE_CHATS, step) for p in rv.retrieve_batch(
            [(t, q, None) for t, q in queries[lo: lo + step]], engine)]
        for (tenant, query), (_, payload), want in zip(queries, answers, direct):
            got_ids = [h["chunk_id"] for h in payload["results"]]
            want_ids = [h["chunk_id"] for h in want["results"]]
            if set(got_ids) != set(want_ids):
                raise AssertionError(f"{query!r}: served {got_ids}, direct {want_ids}")
            rank = {cid: -r for r, cid in enumerate(got_ids)}
            if not _order_kept([rank[c] for c in want_ids],
                               [h["combined_score"] for h in want["results"]], SERVE_TIE):
                raise AssertionError(f"{query!r}: served order {got_ids}, direct {want_ids}")
    finally:
        for c in clients.values():
            c.close()
        t1 = time.perf_counter()
        server.shutdown()
        queue.shutdown(wait=True)
        engine.persist_indexes()
        watchdog.stop_watchdog()
        engine.close()
        server.server_close()
        shutdown_s = time.perf_counter() - t1
    phase = _launches()
    chat_launches = {k: after_chat[k] - after_ingest[k] for k in phase}
    for name in SERVE_LAUNCHES[False]:
        if chat_launches[name] <= 0:
            raise AssertionError(f"the chat requests did not launch {name}: {chat_launches}")
    for name in ("B1", "B2", "B3", "B4", "B5"):
        if phase[name] <= 0:
            raise AssertionError(f"the serve http phase never launched {name}: {phase}")
    for name in NEVER_LAUNCHED[False]:
        if phase[name] != 0:
            raise AssertionError(f"the serve http phase launched {name}: {phase}")
    emit({"phase": "serve http", "card": smi, "chat_requests": SERVE_CHATS,
          "threads": SERVE_THREADS, "chat_wall_s": chat_s,
          "chat_p50_ms": float(np.percentile(walls, 50)),
          "chat_p99_ms": float(np.percentile(walls, 99)), "chat_ms": walls,
          "batch_sizes": batch_sizes, "pdf_ingest_s": pdf_s, "video_job_s": video_s,
          "video_frames": len(stack), "video_frames_kept": len(kept),
          "warmup_dispatches": warm, "warmup_s": warm_s, "shutdown_s": shutdown_s,
          "stage_ms": {k: {q: v[q] for q in ("count", "p50", "p95", "max")}
                       for k, v in stages.items()},
          "launches_chat": chat_launches,
          "launches_ingest": {k: after_ingest[k] - after_warm[k] for k in phase},
          "launches_phase": phase})
    _hold_x3(stack, rng)
    shutil.rmtree(tmp, ignore_errors=True)
    return phase


# ---------------------------------------------------------------------------
# the ASR rung: Whisper-base on the card behind a served YouTube job
# ---------------------------------------------------------------------------

ASR_AUDIO_S = 75.0  # 3 windows: one bucket-4 dispatch with one padded window
ASR_FILL = {"text": 1 << 14, "image": 1 << 12}  # seeded rows of two tenants
ASR_TOKENS = 224  # the runtime's default decode length
# card vs the port on the CPU, both f32, on the same inputs (one window)
ASR_MEL_TOL, ASR_ENC_TOL, ASR_MATRIX_TOL = 1e-4, 2e-4, 2e-4
ASR_GAP_TOL = 1e-4  # a greedy token may differ only where the CPU's top-2 gap is below
# the card's bf16 runtime vs its f32: 1 - cosine of teacher-forced logit rows,
# about 4.6x the largest drift an H100 (700 W) gave on these weights, 2.2e-5
ASR_BF16_DRIFT_TOL = 1e-4
ASR_PROFILE_STEPS = 32  # the profiled decode window (bucket 4)


def _wall_ms(fn, repeats: int = 3) -> list:
    """Wall times (ms) of ``fn`` with the card synchronized, after one warm-up
    call: host time included, as the runtime's callers wait for it."""

    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _profile_ms(fn, steps: int) -> dict:
    """One profiled call of ``fn`` (after a warm one): its wall time, the
    device's busy time (the sum of its kernels' device times), the idle
    share, and the kernels a step."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, kernels_run = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            busy_ms += evt.self_device_time_total / 1e3
            kernels_run += evt.count
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "kernels_a_step": kernels_run / steps}


def _write_whisper_base(root: str, seed: int) -> str:
    """Seeded whisper-base weights in the converted layout and a synthetic
    byte-level vocab of the 50,257 base tokens; returns the WEIGHTS_DIR."""

    import dataclasses

    from mmrag_tpu_torch.models import convert, whisper
    from mmrag_tpu_torch.models.tokenizer import _bytes_to_unicode

    cfg = whisper.WHISPER_BASE
    wdir = os.path.join(root, "openai__whisper-base")
    convert.save_params(whisper.init_whisper_params(seed, cfg), wdir, "model",
                        meta={"arch": "whisper", "config": dataclasses.asdict(cfg)})
    b2u = _bytes_to_unicode()
    vocab = {"".join(b2u[b] for b in f" tok{i}".encode()): i for i in range(cfg.eot_id)}
    with open(os.path.join(wdir, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump(vocab, fh)
    return root


def _write_wav(path: str, rng, seconds: float) -> str:
    import wave

    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    sig = 0.2 * np.sin(2 * np.pi * 220 * t * (1 + 0.5 * np.sin(2 * np.pi * t / 7)))
    sig += 0.05 * rng.standard_normal(n)
    with wave.open(path, "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(16000)
        fh.writeframes((np.clip(sig, -1, 1) * 32767).astype(np.int16).tobytes())
    return path


def _hold_asr_on_cpu(wdir: str, window: np.ndarray, prefix: tuple) -> dict:
    """X4, the encoder, X5 and X6 on the card against the port on the CPU,
    both f32, each stage on the CPU stage's inputs (one window); then the
    card's bf16 forms against its f32 on teacher-forced logits."""

    import torch

    from mmrag_tpu_torch.models import align, convert, whisper

    cfg = whisper.WHISPER_BASE
    tree = convert.load_params(wdir, "model")
    dev = torch.device("cuda")
    on = {d: convert.params_from_jax(tree, "whisper", cfg, device=d, dtype=torch.float32)
          for d in ("cpu", "cuda")}
    bf16 = convert.params_from_jax(tree, "whisper", cfg, device=dev, dtype=torch.bfloat16)
    audio = torch.from_numpy(window[None])
    with torch.inference_mode():
        mel = whisper.log_mel_spectrogram(audio, cfg.num_mel_bins)
        mel_err = float((whisper.log_mel_spectrogram(audio.to(dev)).cpu() - mel).abs().max())
        enc = whisper.whisper_encode(on["cpu"], mel, cfg)
        enc_err = float((whisper.whisper_encode(on["cuda"], mel.to(dev), cfg).cpu()
                         - enc).abs().max())
        tokens, _ = whisper.whisper_greedy_decode(on["cpu"], enc, cfg, forced_prefix=prefix,
                                                  max_len=ASR_TOKENS)
        card, _ = whisper.whisper_greedy_decode(on["cuda"], enc.to(dev), cfg,
                                                forced_prefix=prefix, max_len=ASR_TOKENS)
        diff = np.nonzero(card.cpu().numpy()[0] != tokens.numpy()[0])[0]
        first = int(diff[0]) if diff.size else None
        gap = None
        if first is not None:  # the step before `first` chose it: its CPU top-2 gap
            logits = whisper.whisper_decode_logits(on["cpu"], tokens[:, :first], enc, cfg)
            top2 = torch.topk(logits[0, -1], 2).values
            gap = float(top2[0] - top2[1])
            if gap >= ASR_GAP_TOL:
                raise AssertionError(f"greedy tokens differ at step {first}, where the CPU's "
                                     f"top-2 logit gap is {gap}")
        _, cross = align.decoder_cross_attention(on["cpu"], tokens, enc, cfg)
        matrix = align.alignment_matrix_device(cross[:, 0])
        _, cross_card = align.decoder_cross_attention(on["cuda"], tokens.to(dev), enc.to(dev),
                                                      cfg)
        matrix_err = float((align.alignment_matrix_device(cross_card[:, 0]).cpu()
                            - matrix).abs().max())
        # bf16 runtime vs f32 on the card: its own encoder and decoder forms
        mel_d = mel.to(dev)
        tf = {}
        for name, params, dt in (("f32", on["cuda"], torch.float32),
                                 ("bf16", bf16, torch.bfloat16)):
            enc_d = whisper.whisper_encode(params, mel_d, cfg, dt)
            tf[name] = whisper.whisper_decode_logits(params, tokens.to(dev), enc_d, cfg, dt)[0]
        cos = torch.nn.functional.cosine_similarity(tf["bf16"], tf["f32"], dim=-1)
        drift = float((1 - cos).max())
    out = {"phase": "serve asr cpu", "mel_max_abs_err": mel_err, "enc_max_abs_err": enc_err,
           "greedy_steps": ASR_TOKENS, "greedy_equal": first is None,
           "first_differing_step": first, "cpu_top2_gap_there": gap,
           "matrix_max_abs_err": matrix_err, "bf16_logit_cosine_drift_max": drift,
           "bf16_logit_cosine_drift_mean": float((1 - cos).mean()),
           "text_tokens": int((tokens < cfg.eot_id).sum())}
    emit(out)
    for name, err, tol in (("log-mel", mel_err, ASR_MEL_TOL), ("encoder", enc_err, ASR_ENC_TOL),
                           ("alignment matrix", matrix_err, ASR_MATRIX_TOL),
                           ("bf16 logit drift", drift, ASR_BF16_DRIFT_TOL)):
        if not err <= tol:
            raise AssertionError(f"ASR {name}: card {err} from the CPU's, over {tol}")
    return out


def serve_asr_pass(seed: int, runtime, smi: str) -> dict:
    """The ASR rung on the card: seeded whisper-base weights (written here
    by the port), a served YouTube job whose captions fail and whose download
    and audio stages return a seeded 75 s wav, so ``transcribe_audio`` runs
    the port's Whisper (auto language detection, timestamps, bf16); checks
    the job's source, segments (equal to a direct ``transcribe_wav``),
    tenant isolation, launches (no B1-B12 during the transcription), then
    the aligned path, the card against the CPU, and times each stage.
    Returns the phase's launches."""

    import threading

    import torch

    from mmrag_tpu_torch.cache import clear_all_caches
    from mmrag_tpu_torch.ingest import asr
    from mmrag_tpu_torch.ingest import youtube as yt
    from mmrag_tpu_torch.models import whisper
    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.serving import tasks
    from mmrag_tpu_torch.serving.http import make_server
    from mmrag_tpu_torch.serving.jobs import LocalJobQueue
    from mmrag_tpu_torch.settings import load_settings
    from mmrag_tpu_torch.storage.records import VectorRow

    rng = np.random.default_rng(seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_asr_")
    phase_t0 = t0 = time.perf_counter()
    weights = _write_whisper_base(os.path.join(tmp, "weights"), seed)
    wav = _write_wav(os.path.join(tmp, "audio.wav"), rng, ASR_AUDIO_S)
    write_s = time.perf_counter() - t0
    env = _engine_env(tmp, INGEST_CACHE_DIR=os.path.join(tmp, "cache"),
                      MEDIA_DIR=os.path.join(tmp, "media"), API_KEYS=json.dumps(SERVE_KEYS),
                      RATE_LIMIT_PER_MIN="100000", YT_LAZY_FRAMES="1", WEIGHTS_DIR=weights)
    del env["TPU_MICROBATCH_WINDOW_MS"]  # the default serving settings hold
    cfg = load_settings(env)
    if (cfg.models.asr, cfg.models.asr_language, cfg.models.asr_timestamps,
            cfg.tpu.compute_dtype) != ("openai/whisper-base", "auto", True, "bfloat16"):
        raise AssertionError(f"not the default ASR settings: {cfg.models}")
    clear_all_caches()
    asr.reset_asr_runtime()
    engine = RagEngine(cfg, runtime)
    tenants = list(SERVE_KEYS.values())
    for index, total, dim in ((engine.text_index, ASR_FILL["text"], runtime.text_dim),
                              (engine.image_index, ASR_FILL["image"], runtime.clip_dim)):
        vecs = rng.standard_normal((total, dim), dtype=np.float32)
        index.upsert([VectorRow(chunk_id=f"fill-{dim}-{i}", user_id=tenants[i % 2],
                                document_id=f"fill-doc{i % 97}", modality="text",
                                embedding=vecs[i]) for i in range(total)])
    torch.cuda.synchronize()

    kernels.reset_launches()  # this phase of the main path starts here
    queue = LocalJobQueue(os.path.join(tmp, "jobs.db"), workers=1)
    server = make_server("127.0.0.1", 0, cfg=cfg, engine=engine, queue=queue)
    port = server.server_address[1]
    video_id = "asrSm0keV1d"
    ladders, asr_launches = [], []

    def info_fn(url, cfg_):  # the metadata stage (network) replaced
        return {"video_id": video_id, "title": "Warehouse lifting, narrated", "duration": 75}

    def ladder_fn(url, work_dir, cfg_, **kwargs):
        def no_captions(vid):
            raise yt.YouTubeIngestError("no captions for this video")

        before = _launches()
        out = yt.transcript_or_fallback(
            url, work_dir, cfg_, transcript_fn=no_captions,
            download_fn=lambda u, d, c: os.path.join(work_dir, "video.mp4"),
            audio_fn=lambda path, c: wav, **kwargs)  # the ASR stage is the default
        torch.cuda.synchronize()
        after = _launches()
        asr_launches.append({k: after[k] - before[k] for k in after})
        ladders.append(out)
        return out

    server.ctx.queue.register("ingest_youtube", lambda progress, user_id, url:
                              tasks.ingest_youtube_task(progress, user_id=user_id, url=url,
                                                        engine=engine, kv=server.ctx.kv,
                                                        info_fn=info_fn, ladder_fn=ladder_fn))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    clients = {t: _Client(port, k) for k, t in SERVE_KEYS.items()}
    try:
        t1 = time.perf_counter()
        status, job = clients["tenant-a"].call("POST", "/ingest/youtube",
                                               {"url": f"https://youtu.be/{video_id}"})
        if status != 202:
            raise AssertionError(f"YouTube enqueue failed: {status} {job}")
        deadline = time.monotonic() + 300
        while True:
            status, st = clients["tenant-a"].call("GET", f"/yt_status/{job['job_id']}")
            if st["state"] in ("SUCCESS", "FAILURE") or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        job_s = time.perf_counter() - t1
        if st["state"] != "SUCCESS" or st.get("source") != "asr":
            raise AssertionError(f"the ASR job did not succeed from ASR: {st}")
        segments = ladders[0]["segments"]
        if st["text_nodes"] != len(segments) or not segments:
            raise AssertionError(f"{len(segments)} segments, {st['text_nodes']} indexed: {st}")
        hits = {}
        for tenant in tenants:  # the first segment's own text as the query
            status, payload = clients[tenant].call("POST", "/chat_pro",
                                                   {"query": segments[0].text})
            if status != 200:
                raise AssertionError(f"/chat_pro for {tenant}: {status} {payload}")
            hits[tenant] = [h["document_id"] for h in payload["results"]]
            if any(h["user_id"] != tenant for h in payload["results"]):
                raise AssertionError(f"{tenant} was served another tenant's hit: {payload}")
        if video_id not in hits["tenant-a"] or video_id in hits["tenant-b"]:
            raise AssertionError(f"the transcript is not tenant-a's alone: {hits}")
    finally:
        for c in clients.values():
            c.close()
        server.shutdown()
        queue.shutdown(wait=True)
        engine.close()
        server.server_close()
    phase = _launches()
    during = asr_launches[0]
    if any(during.values()):
        raise AssertionError(f"the transcription launched a kernel: {during}")
    for name in ("B1", "B2"):  # the segments' embeds, then the chats
        if phase[name] <= 0:
            raise AssertionError(f"the serve asr phase never launched {name}: {phase}")
    for name in NEVER_LAUNCHED[False]:
        if phase[name] != 0:
            raise AssertionError(f"the serve asr phase launched {name}: {phase}")

    # the job's segments are a direct transcription's (a fresh runtime)
    audio = asr.read_wav_mono16k(wav)
    direct = asr.WhisperRuntime(cfg)
    if direct.transcribe_wav(wav) != segments:
        raise AssertionError("the job's segments differ from a direct transcribe_wav")
    prefix = direct._resolve_prefix(direct._first_window(audio))
    mcfg = direct._model_cfg
    chunk = direct._window_samples()
    windows = -(-len(audio) // chunk)
    batch = np.zeros((asr._bucket(windows), chunk), np.float32)
    for j in range(windows):
        part = audio[j * chunk:(j + 1) * chunk]
        batch[j, : len(part)] = part
    x = torch.from_numpy(batch).cuda()
    dt = direct.compute_dtype
    with torch.inference_mode():
        mel = whisper.log_mel_spectrogram(x)
        enc = whisper.whisper_encode(direct._params, mel, mcfg, dt)
        t = {
            "mel_ms": _wall_ms(lambda: whisper.log_mel_spectrogram(x)),
            "encode_ms": _wall_ms(lambda: whisper.whisper_encode(direct._params, mel, mcfg, dt)),
            "decode_ms": _wall_ms(lambda: whisper.whisper_greedy_decode(
                direct._params, enc, mcfg, forced_prefix=prefix, max_len=ASR_TOKENS,
                compute_dtype=dt)),
            "detect_ms": _wall_ms(lambda: direct._detect_fn(batch[:1])),
        }
        bench = torch.from_numpy(0.1 * rng.standard_normal((8, whisper.CHUNK_SAMPLES),
                                                           dtype=np.float32)).cuda()

        def bench_step():  # bench.py::bench_asr: batch 8, 32 tokens, bf16
            enc8 = whisper.whisper_encode(direct._params, whisper.log_mel_spectrogram(bench),
                                          mcfg, dt)
            return whisper.whisper_greedy_decode(direct._params, enc8, mcfg, max_len=32,
                                                 compute_dtype=dt)

        t["bench_asr_ms"] = _wall_ms(bench_step)
        profiled = _profile_ms(lambda: whisper.whisper_greedy_decode(
            direct._params, enc, mcfg, forced_prefix=prefix, max_len=ASR_PROFILE_STEPS,
            compute_dtype=dt), ASR_PROFILE_STEPS)
    t["transcribe_ms"] = _wall_ms(lambda: direct.transcribe_array(audio), repeats=2)

    # the aligned path (MODEL_ASR_WORD_ALIGN=1) on the same wav, through the
    # ladder's transcribe_wav, then timed warm
    aligned_rt = asr.WhisperRuntime(load_settings(dict(env, MODEL_ASR_WORD_ALIGN="1")))
    words = 0
    window_s = chunk / 16000
    for seg in aligned_rt.transcribe_wav(wav):
        idx = int(seg.start // window_s)
        lo, hi = idx * window_s, min((idx + 1) * window_s, ASR_AUDIO_S)
        starts = [start for _, start, _ in seg.words]
        if any(not (lo <= start <= end <= hi) for _, start, end in seg.words):
            raise AssertionError(f"a word outside its window [{lo}, {hi}]: {seg}")
        if any(b < a for a, b in zip(starts, starts[1:])):
            raise AssertionError(f"word starts decrease within a segment: {seg}")
        words += len(seg.words)
    if not words:
        raise AssertionError("MODEL_ASR_WORD_ALIGN=1: the ladder's segments carry no word")
    t0 = time.perf_counter()
    aligned_rt.transcribe_wav_aligned(wav)
    torch.cuda.synchronize()
    t["aligned_ms"] = [(time.perf_counter() - t0) * 1e3]

    t0 = time.perf_counter()
    held = _hold_asr_on_cpu(os.path.join(weights, "openai__whisper-base"),
                            batch[0], prefix)
    hold_s = time.perf_counter() - t0
    dispatch = float(np.median(t["decode_ms"]))
    emit({"phase": "serve asr", "card": smi, "audio_s": ASR_AUDIO_S, "windows": windows,
          "bucket": len(batch), "max_tokens": ASR_TOKENS, "prefix": list(prefix),
          "segments": len(segments), "job_s": job_s, "weights_write_s": write_s,
          **t, "decode_step_ms": dispatch / ASR_TOKENS,
          "rtf_default": ASR_AUDIO_S / (float(np.median(t["transcribe_ms"])) / 1e3),
          "rtf_bench_asr": 8 * 30.0 / (float(np.median(t["bench_asr_ms"])) / 1e3),
          "aligned_ms_a_window": t["aligned_ms"][0] / windows, "aligned_words": words,
          "decode_profile": {"steps": ASR_PROFILE_STEPS, **profiled},
          "cpu_hold_s": hold_s, "phase_s": time.perf_counter() - phase_t0,
          "launches_transcription": during, "launches_phase": phase,
          "greedy_equal_cpu": held["greedy_equal"]})
    asr.reset_asr_runtime()
    shutil.rmtree(tmp, ignore_errors=True)
    return phase


class TopicGeometry:
    """Seeded fill rows with the structure that embedding corpora have and
    that the ivf and pq layouts rely on (isotropic rows fail both data gates:
    the structure gate discards the layout and the pq quality gate demotes
    the index to int8). Each of the ``m`` subvectors draws from a pool of 16
    patterns; a document's center shares its first ``m/2`` patterns with the
    other centers of its topic (256 topics) and draws the rest on its own; a
    document's chunks are a cloud around its center with per-coordinate noise
    0.25 (the ``_clustered`` recipe of tests/test_pq.py around each center),
    in contiguous rows, as ingest appends them. Documents are ``CLOUD`` (16)
    chunks each, aligned to the 128-row buckets, or, with ``doc_rows=(lo,
    hi)``, of a length drawn from ``[lo, hi]`` each, so they straddle bucket
    edges. A document belongs to one tenant (of three) and one document id
    (of 97)."""

    CLOUD = 16

    def __init__(self, rng, n: int, d: int, m: int = 16, topics: int = 256, pool: int = 16,
                 noise: float = 0.25, doc_rows=None):
        ds = d // m
        pats = rng.standard_normal((m, pool, ds)).astype(np.float32)
        if doc_rows is None:
            starts = np.arange(0, n, self.CLOUD)
        else:
            lens = rng.integers(doc_rows[0], doc_rows[1] + 1, n // doc_rows[0] + 1)
            starts = np.concatenate([[0], np.cumsum(lens)])
            starts = starts[starts < n]
        self.doc_of = np.searchsorted(starts, np.arange(n), side="right") - 1
        n_centers = len(starts)
        topic_codes = rng.integers(0, pool, (topics, m // 2))
        own = rng.integers(0, pool, (n_centers, m - m // 2))
        codes = np.concatenate([topic_codes[np.arange(n_centers) % topics], own], axis=1)
        self.centers = np.concatenate([pats[j][codes[:, j]] for j in range(m)], axis=1)
        self.rng, self.noise = rng, noise

    def rows(self, lo: int, hi: int) -> np.ndarray:
        c = self.centers[self.doc_of[lo:hi]]
        x = c + self.noise * self.rng.standard_normal(c.shape, dtype=np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    def tenant(self, i: int) -> str:
        return f"t{self.doc_of[i] % 3}"

    def doc(self, i: int) -> str:
        return f"doc{self.doc_of[i] % 97}"


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


def _recall(hits, exact, index, k: int = 10) -> float:
    got = [{index._chunk_to_row[c] for c, _ in h[:k]} for h in hits]
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
    pass_launches = _launches()  # the whole pass, read just after it
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
    cfg = load_settings(_engine_env(tmp, TPU_TOPK_BACKEND="ivf", TPU_INDEX_DTYPE="pq",
                                    TPU_INDEX_JOURNAL="0"))
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
    pass_launches = _launches()
    serve = served["serve_launches"]
    if serve["B10"] <= 0 or serve["B11"] <= 0:
        raise AssertionError(f"IVF_PQ serving did not launch B10 and B11: {serve}")
    if any(pass_launches[k] for k in ("B4", "B8", "B9", "B12")):
        raise AssertionError(f"the IVF_PQ pass launched B4, B8, B9 or B12: {pass_launches}")

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


# ---------------------------------------------------------------------------
# the mesh pass: the row-sharded index and the data-parallel encoders on one
# card. A mesh over one card runs its shards one after another on the card's
# stream: it measures the shard-and-merge path, not a multi-GPU speed.
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_DP = 2
# each layout: (dtype, backend), the kernels its searches launch, its recall
# floor (PERF.md section 2: the JAX package's; the dense layouts are held to
# the single-device index's ids instead), and its rows
MESH_LAYOUTS = {
    "dense bf16": (("bfloat16", "auto"), ("B4",), None, 1 << 20),
    "int8": (("int8", "auto"), (), None, 1 << 20),
    "pq": (("pq", "auto"), ("B10", "B11"), 0.95, 1 << 20),
    "ivf bf16": (("bfloat16", "ivf"), ("B8",), 0.9, 1 << 20),
    "ivf int8": (("int8", "ivf"), ("B9",), 0.9, 1 << 20),
    "ivf_pq": (("pq", "ivf"), ("B11",), 0.9, 1 << 20),
}
MESH_TIE = 1e-4  # scores this close may swap places between the two indexes


def _mesh(n: int, device: str = "cuda:0"):
    from mmrag_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(devices=[device] * n)


def _search_ms(index, queries, users, repeats: int = 5, k: int = 10) -> float:
    """Median host ms of one ``search_batch_multi`` (dispatch + readback)."""

    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.search_batch_multi(queries, users, k)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _hits_held(got, want, exact_ids: bool) -> int:
    """The sharded index's hits against the single-device index's on the
    same rows: a row both return has the same score (within ``MESH_TIE``);
    with ``exact_ids`` (dense and flat pq layouts, whose candidate sets do
    not depend on the layout) the same ids in the same order wherever the
    scores are apart by more than ``MESH_TIE``. Returns the number of
    queries whose id lists differ."""

    differ = 0
    for g, w in zip(got, want):
        gs, ws = dict(g), dict(w)
        for cid in set(gs) & set(ws):
            if abs(gs[cid] - ws[cid]) > MESH_TIE:
                raise AssertionError(f"mesh: row {cid} scored {gs[cid]} sharded, {ws[cid]} "
                                     "on one device")
        if [c for c, _ in g] != [c for c, _ in w]:
            differ += 1
            if exact_ids:
                wsc = np.asarray([s for _, s in w])
                for r, ((gc, _), (wc, s)) in enumerate(zip(g, w)):
                    apart = np.all(np.abs(np.delete(wsc, r) - s) > MESH_TIE)
                    if apart and gc != wc:
                        raise AssertionError(f"mesh: rank {r} is {gc} sharded, {wc} on one "
                                             "device, scores apart")
    return differ


def mesh_index_pass(kind: str, seed: int, smi: str) -> dict:
    """One index layout at its rows x 384, twice over the same rows: on one
    device and row-sharded over ``MESH_SHARDS`` shards of the card. Holds the
    sharded hits against the single-device ones and recall@10 against the
    exact search, checks that every kernel of the layout launched once per
    shard (4x the single-device count) and prints ms per search at q 1 and
    q 16 for both. Returns the pass's launch counts."""

    import torch

    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.parallel.sharded_ivf import ShardedIVFData, sharded_ivf_kind
    from mmrag_tpu_torch.storage.records import VectorRow

    (dtype, backend), expect, floor, n = MESH_LAYOUTS[kind]
    d = 384
    rng = np.random.default_rng(seed)
    geo = TopicGeometry(rng, n, d)
    host = np.empty((n, d), np.float32)
    kernels.reset_launches()  # this pass starts here
    single = VectorIndex(dim=d, dtype=dtype, backend=backend)
    sharded = VectorIndex(dim=d, dtype=dtype, backend=backend, mesh=_mesh(MESH_SHARDS))
    fill_s = {"single": 0.0, "sharded": 0.0}
    for a in range(0, n, 131072):
        b = min(a + 131072, n)
        host[a:b] = vecs = geo.rows(a, b)
        rows = [VectorRow(chunk_id=f"r{a + i}", user_id=geo.tenant(a + i),
                          document_id=geo.doc(a + i), modality="text", embedding=vecs[i])
                for i in range(b - a)]
        for name, index in (("single", single), ("sharded", sharded)):
            t0 = time.perf_counter()
            index.upsert(rows)
            torch.cuda.synchronize()
            fill_s[name] += time.perf_counter() - t0
    build_s = {}
    for name, index in (("single", single), ("sharded", sharded)):
        index.ivf_build_async = False
        t0 = time.perf_counter()
        if backend == "ivf":
            index.build_ivf()
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        if dtype == "pq" and not index.is_pq:
            raise AssertionError(f"mesh {kind}: the {name} pq index was demoted")
        if backend == "ivf" and index._ivf is None:
            raise AssertionError(f"mesh {kind}: the {name} ivf layout was not installed")
    if backend == "ivf" and not (isinstance(sharded._ivf, ShardedIVFData)
                                 and sharded._ivf.n_shards == MESH_SHARDS):
        raise AssertionError(f"mesh {kind}: the sharded layout is not per shard")

    sel = rng.choice(n, 16, replace=False)
    queries = _near_queries(rng, host, sel)
    users = [geo.tenant(i) for i in sel]
    docs = [geo.doc(i) if j == 5 else None for j, i in enumerate(sel)]
    for index in (single, sharded):  # warm
        index.search_batch_multi(queries, users, 10, docs)
    counts = {}
    for name, index in (("single", single), ("sharded", sharded)):
        before = dict(kernels.LAUNCHES)
        index.search_batch_multi(queries, users, 10, docs)
        index.search_batch_multi(queries[:1], users[:1], 10)
        torch.cuda.synchronize()
        counts[name] = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    want = {k: MESH_SHARDS * v for k, v in counts["single"].items()}
    if kind == "ivf_pq":  # B11 scores the probe and, where a layout spills, the spill
        per = 1 + bool(sharded._ivf.spill_size)
        want["B11"] = MESH_SHARDS * 2 * per
    if counts["sharded"] != want or not all(counts["single"][k] > 0 for k in expect):
        raise AssertionError(f"mesh {kind}: launches {counts}, expected {want} sharded")
    ms = {name: {"q1": _search_ms(index, queries[:1], users[:1]),
                 "q16": _search_ms(index, queries, users)}
          for name, index in (("single", single), ("sharded", sharded))}
    want_hits = single.search_batch_multi(queries, users, 10, docs)
    got_hits = sharded.search_batch_multi(queries, users, 10, docs)
    differ = _hits_held(got_hits, want_hits, exact_ids=backend != "ivf")
    for h, user, doc in zip(got_hits, users, docs):
        if not h:
            raise AssertionError(f"mesh {kind}: empty result for {user}")
        for cid, _ in h:
            row = sharded._chunk_to_row[cid]
            if geo.tenant(row) != user or (doc is not None and geo.doc(row) != doc):
                raise AssertionError(f"mesh {kind}: {cid} served to {user} / {doc}")
    rows_dev = torch.from_numpy(host).cuda()
    exact = _exact_ids(rows_dev, sharded, queries, users, docs)
    recall = {"single": _recall(want_hits, exact, single),
              "sharded": _recall(got_hits, exact, sharded)}
    del rows_dev
    layout = sharded._ivf
    emit({"phase": f"mesh index {kind}", "card": smi, "rows": n, "shards": MESH_SHARDS,
          "capacity": sharded._capacity, "fill_s": fill_s, "build_s": build_s,
          "layout": sharded_ivf_kind(layout) if layout is not None else "flat",
          "bucket": {"single": single._ivf.bucket_size, "sharded": layout.bucket_size}
          if layout is not None else None,
          "spill": {"single": int(single._ivf.spill.shape[0]),
                    "sharded_per_shard": layout.spill_size} if layout is not None else None,
          "search_ms": ms, "launches_per_search_pair": counts,
          "queries_with_other_ids": differ, "recall_at_10": recall, "recall_floor": floor})
    if floor is not None and min(recall.values()) < floor:
        raise AssertionError(f"mesh {kind}: recall@10 {recall} below the JAX floor {floor}")
    pass_launches = _launches()
    del single, sharded, host
    torch.cuda.empty_cache()
    return pass_launches


def _dp_launch_check(tag: str, single_fn, dp_fn) -> dict:
    """The same call on the single-device runtime and on the data-parallel
    one: every kernel the single call launches, the data-parallel call
    launches ``MESH_DP`` times as often (once per shard), and none other."""

    import torch

    from mmrag_tpu_torch.ops import kernels

    counts = {}
    out = {}
    for name, fn in (("single", single_fn), ("dp", dp_fn)):
        torch.cuda.synchronize()
        before = _launches()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        counts[name] = {k: v - before[k] for k, v in _launches().items()}
        counts[name + "_s"] = time.perf_counter() - t0
    for k in (*kernels.LAUNCHES, *kernels.KERNEL_LAUNCHES):
        if counts["dp"][k] != MESH_DP * counts["single"][k]:
            raise AssertionError(f"dp {tag}: {k} launched {counts['dp'][k]} times, "
                                 f"expected {MESH_DP} x {counts['single'][k]}")
    return {"single": {k: v for k, v in counts["single"].items() if v},
            "dp": {k: v for k, v in counts["dp"].items() if v},
            "single_s": counts["single_s"], "dp_s": counts["dp_s"], "out": out}


def _answer_held(got, want, tie: dict) -> bool:
    """A data-parallel engine's answer against the single-device one's: each
    hit both return has the same retrieval and rerank scores within ``tie``
    (the per-row drift of the split batches), and the final 4 are the same
    ids in the same order unless the single-device answer holds two scores
    closer than ``tie`` (a near-tie the fusion's z-scores may turn either
    way)."""

    finals = set(_final4(got)) | set(_final4(want))
    near = False
    for key in ("text", "images"):
        for field, tol in tie.items():
            ws = {h["chunk_id"]: h.get(field) for h in want[key] if h.get(field) is not None}
            gs = {h["chunk_id"]: h.get(field) for h in got[key] if h.get(field) is not None}
            if any(abs(ws[c] - gs[c]) > tol for c in set(ws) & set(gs)):
                raise AssertionError(f"mesh: {key} {field} drift above {tol}: {gs} vs {ws}")
            # a near-tie that involves a final-4 hit of either answer
            near |= any(abs(ws[a] - ws[b]) <= tol for a in ws.keys() & finals
                        for b in ws if b != a)
    return near or _final4(got) == _final4(want)


def mesh_encoder_pass(seed: int, bf16_runtime, smi: str) -> dict:
    """Data-parallel ``EncoderRuntime`` and ``RagEngine`` on a ``MESH_DP``
    -shard mesh of the card at full width (MiniLM-L6, the cross-encoder,
    CLIP ViT-B/32), bf16 and int8: each kernel launches once per shard,
    the embeddings and rerank logits hold against the single-device
    runtime's, and ``retrieve_batch`` of 16 gives its final 4; then
    ``dp_clip_image_embed`` on a 256-pixel canvas holds X2 and the tower on
    the card against the port on the CPU. Returns the pass's launch counts."""

    import torch

    from mmrag_tpu_torch.cache import clear_all_caches
    from mmrag_tpu_torch.models import clip
    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.ops import images as image_ops
    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.parallel.inference import dp_clip_image_embed
    from mmrag_tpu_torch.rag import retrieve as rv
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings

    kernels.reset_launches()  # this pass starts here
    depth = {"text_chunks": 128, "images": 32}
    result = {}
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        engines = {}
        for name in ("single", "dp"):
            cfg = load_settings(_engine_env(os.path.join(tmp, name), TPU_INDEX_JOURNAL="0",
                                            TPU_ENCODER_QUANT="int8" if quant else ""))
            if name == "dp":
                runtime = EncoderRuntime(cfg, mesh=_mesh(MESH_DP))
            else:
                runtime = bf16_runtime if not quant else EncoderRuntime(cfg)
            runtime._ensure_minilm(), runtime._ensure_clip(), runtime._ensure_cross()
            engines[name] = (RagEngine(cfg, runtime), cfg)
        single_rt, dp_rt = engines["single"][0].runtime, engines["dp"][0].runtime
        rng = np.random.default_rng(seed)
        texts = [n["text"] for n in _chunks(rng, 16, "probe")]
        imgs = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8) for _ in range(8)]
        checks = {
            "text": _dp_launch_check(f"{tag} text", lambda: single_rt.embed_text_batch(texts),
                                     lambda: dp_rt.embed_text_batch(texts)),
            "images": _dp_launch_check(f"{tag} images",
                                       lambda: single_rt.embed_images_batch(imgs),
                                       lambda: dp_rt.embed_images_batch(imgs)),
            "queries": _dp_launch_check(f"{tag} queries",
                                        lambda: single_rt.embed_queries_for_images(texts),
                                        lambda: dp_rt.embed_queries_for_images(texts)),
            "rerank": _dp_launch_check(
                f"{tag} rerank", lambda: single_rt.rerank_pairs([TOPICS[0]] * 8, texts[:8]),
                lambda: dp_rt.rerank_pairs([TOPICS[0]] * 8, texts[:8])),
        }
        drift = {k: _drift(c["out"]["single"], c["out"]["dp"])
                 for k, c in checks.items() if k != "rerank"}
        rerank_err = float(np.abs(checks["rerank"]["out"]["single"]
                                  - checks["rerank"]["out"]["dp"]).max())
        finals = {}
        for name, (engine, cfg) in engines.items():
            clear_all_caches()  # each engine answers from its own search
            _ingest(engine, engine.runtime, cfg, np.random.default_rng(seed + 1), depth,
                    f"mesh {tag} {name}", ("B6", "B7") if quant else ("B1", "B3"))
            clear_all_caches()
            served = _serve(rv, engine, cfg, f"mesh {tag} {name}")
            finals[name] = served
        answers = {}
        for name, (engine, _) in engines.items():
            clear_all_caches()  # the dp engine must not be served the other's answers
            answers[name] = rv.retrieve_batch(finals["single"]["items"], engine)
        tie = {"score": 2e-3 if quant else 1e-3,
               "rerank_score": RERANK_TOL_INT8_BF16 if quant else RERANK_TOL_BF16}
        same = [_answer_held(got, want, tie)
                for got, want in zip(answers["dp"], answers["single"])]
        result[tag] = {
            "launches": {k: {"single": c["single"], "dp": c["dp"]} for k, c in checks.items()},
            "seconds": {k: {"single": c["single_s"], "dp": c["dp_s"]} for k, c in checks.items()},
            "cosine_drift_dp_vs_single": drift, "rerank_max_abs_err_dp_vs_single": rerank_err,
            "final4_equal": sum(_final4(a) == _final4(b)
                                for a, b in zip(answers["dp"], answers["single"])),
            "queries": len(same),
            "batch_ms": {k: v["batch_ms"] for k, v in finals.items()}}
        emit({"phase": f"mesh encoders {tag}", "card": smi, "shards": MESH_DP, **result[tag]})
        if max(drift.values()) > 1e-3 or rerank_err > (RERANK_TOL_INT8_BF16 if quant
                                                         else RERANK_TOL_BF16):
            raise AssertionError(f"mesh {tag}: the dp runtime drifts from one device: "
                                 f"{drift}, rerank {rerank_err}")
        if not all(same):
            raise AssertionError(f"mesh {tag}: retrieve_batch's final 4 differ on {same}")
        for engine, _ in engines.values():
            engine.close()
        shutil.rmtree(tmp, ignore_errors=True)

    # dp_clip_image_embed at a 256 canvas: X2 and the tower on the card
    # against the port on the CPU (f32), same seeded weights
    rng = np.random.default_rng(seed + 2)
    canvas = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    cpu = EncoderRuntime(bf16_runtime.cfg, device="cpu")
    canvas_dev = torch.from_numpy(canvas).cuda()
    px_card = image_ops.preprocess_batch(canvas_dev).cpu()
    px_cpu = image_ops.preprocess_batch(torch.from_numpy(canvas))
    x2_err = float((px_card - px_cpu).abs().max())
    x2_ms = time_ms(lambda: image_ops.preprocess_batch(canvas_dev))
    card = dp_clip_image_embed(_mesh(MESH_DP), clip.CLIP_VIT_B32)(
        bf16_runtime._ensure_clip(), canvas).float().cpu().numpy()
    ref = dp_clip_image_embed(_mesh(MESH_DP, "cpu"), clip.CLIP_VIT_B32)(
        cpu._ensure_clip(), canvas).numpy()
    clip_drift = _drift(card, ref)
    emit({"phase": "mesh dp_clip_image_embed", "card": smi, "canvas": 256, "images": 8,
          "x2_ms": x2_ms, "x2_max_abs_err_card_vs_cpu": x2_err,
          "cosine_drift_card_bf16_vs_cpu_f32": clip_drift})
    if x2_err > 1e-5 or clip_drift > 1e-3 or card.shape != (8, 512):
        raise AssertionError(f"dp_clip_image_embed off: X2 {x2_err}, drift {clip_drift}")
    return _launches()


def _wordpiece_vocab(rng) -> dict:
    """A seeded 30,522-piece BERT vocabulary in which no word of the smoke's
    text is a whole piece: each splits into a 2-4 letter head and ``##``
    tails of 2-4 letters, so every word goes through the longest-match
    search over its substrings, as a real vocabulary's rarer words do. Then
    every ASCII letter, digit and punctuation mark whole and as a
    continuation, and seeded 2-6 letter pieces that are none of the words."""

    import string

    words = set(_WORDS) | {w for t in TOPICS for w in t.split()} | {"query"}
    pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    for word in sorted(words):
        cut = int(rng.integers(2, 5))
        pieces.append(word[:cut])
        rest = word[cut:]
        while rest:
            step = int(rng.integers(2, 5))
            pieces.append(f"##{rest[:step]}")
            rest = rest[step:]
    chars = string.ascii_lowercase + string.digits
    pieces += list(chars) + [f"##{c}" for c in chars] + list(string.punctuation)
    pieces = [p for p in dict.fromkeys(pieces) if p not in words or len(p) == 1]
    seen = set(pieces) | words
    while len(pieces) < 30522:
        word = "".join(rng.choice(list(string.ascii_lowercase), int(rng.integers(2, 7))))
        piece = word if rng.random() < 0.5 else f"##{word}"
        if piece not in seen:
            seen.add(piece)
            pieces.append(piece)
    return {p: i for i, p in enumerate(pieces)}


def _ingest_chunks(rng, tok, n: int, tokens: int = 512) -> list:
    """``n`` chunks of the smoke's words, each filled to 3 tokens short of
    ``tokens`` pieces (``[CLS]`` and ``[SEP]`` make it the encoder's 512)
    and closed by a full stop."""

    cost = {w: len(tok._py_tokenize_ids(w)) for w in _WORDS}
    chunks = []
    for _ in range(n):
        words, used = [], 0
        while True:
            word = str(rng.choice(_WORDS))
            if used + cost[word] > tokens - 3:
                break
            words.append(word)
            used += cost[word]
        chunks.append(" ".join(words) + ".")
    return chunks


def native_pass(seed: int, smi: str) -> None:
    """The C++ WordPiece (``mmrag_tpu_torch.native``) against the tokenizer's
    pure-Python path: a served batch of 16 queries (``tokenize_ids`` each)
    and 256 ingest chunks of 510 tokens at most (``tokenize_matrix``), every
    word split into ``##`` pieces; ids equal, host ms of each (the host's
    clock: no device work)."""

    from mmrag_tpu_torch.models.tokenizer import WordPieceTokenizer

    rng = np.random.default_rng(seed)
    tok = WordPieceTokenizer(_wordpiece_vocab(rng))
    if tok._native is None:
        raise AssertionError("the native WordPiece was not engaged")
    queries = [f"{TOPICS[i % 4]} query {i}" for i in range(16)]
    chunks = _ingest_chunks(rng, tok, 256)

    def best(fn, repeats: int = 5) -> float:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    native_q = [tok.tokenize_ids(q) for q in queries]
    if native_q != [tok._py_tokenize_ids(q) for q in queries]:
        raise AssertionError("native query ids differ from the Python path")
    buf, lengths = tok.tokenize_matrix(chunks)
    py = [tok._py_tokenize_ids(c) for c in chunks]
    if [buf[i, :lengths[i]].tolist() for i in range(len(chunks))] != py:
        raise AssertionError("native chunk ids differ from the Python path")
    words = sum(len(c.split()) for c in chunks)
    if int(lengths.sum()) < 1.5 * words or float(lengths.mean()) < 490:
        raise AssertionError(f"chunks not split into pieces: {int(lengths.sum())} "
                             f"tokens for {words} words")
    emit({"phase": "native wordpiece", "card": smi, "vocab": len(tok.vocab),
          "served_batch": {"queries": 16, "tokens": sum(map(len, native_q)),
                           "native_ms": best(lambda: [tok.tokenize_ids(q) for q in queries]),
                           "python_ms": best(lambda: [tok._py_tokenize_ids(q)
                                                      for q in queries])},
          "ingest_chunks": {"chunks": 256, "words": words, "tokens": int(lengths.sum()),
                            "mean_tokens": float(lengths.mean()),
                            "native_ms": best(lambda: tok.tokenize_matrix(chunks)),
                            "python_ms": best(lambda: [tok._py_tokenize_ids(c)
                                                       for c in chunks], 3)}})


def mesh_pass(seed: int, bf16_runtime, smi: str) -> dict:
    """The mesh pass: every layout of ``MESH_LAYOUTS`` sharded and on one
    device, the data-parallel encoders, the native WordPiece. Returns the
    launch counts of each of its parts, each counted from 0."""

    emit({"phase": "mesh", "note": f"a mesh of {MESH_SHARDS} (index) and {MESH_DP} "
          "(encoders) shards over one card runs the shards one after another on its "
          "stream: it measures the shard-and-merge path, not a multi-GPU speed",
          "card": smi})
    passes = {}
    for i, kind in enumerate(MESH_LAYOUTS):
        passes[f"mesh index {kind}"] = mesh_index_pass(kind, seed + i, smi)
    passes["mesh encoders"] = mesh_encoder_pass(seed + 10, bf16_runtime, smi)
    native_pass(seed + 20, smi)
    return passes


# ---------------------------------------------------------------------------
# the train phase: fine-tuning the three towers at full width on the card
# ---------------------------------------------------------------------------

TRAIN_STEPS = 10  # a learning run's steps on its fixed batch; MiniLM saves at 5
TRAIN_SAVE_AT = 5
TRAIN_CPU_BATCH = 4  # the card-against-CPU step's batch (the CPU's time)
TRAIN_LOSS_TOL = 1e-5  # card vs CPU, relative (tests/test_torch_cuda.py's)
TRAIN_GRAD_TOL = 1e-4  # card vs CPU, of each leaf's max-abs
TRAIN_MESH_TOL = 1e-6  # (2, 2) mesh vs one device: loss relative, parameters
TRAIN_RESUME_TOL = 1e-6  # resumed vs uninterrupted losses (atomics in the backward)
TRAIN_SERVE_DRIFT = 1e-3  # the bf16 runtime on the exported tower, the bf16 contract
# tower: (batch, sequence) of the learning run
TRAIN_SHAPES = {"minilm": (32, 128), "cross": (16, 512), "clip": (32, 77)}


def _train_batch(kind: str, b: int, seed: int) -> tuple:
    """A seeded full-width batch in the step's argument order: MiniLM (q_ids,
    q_mask, p_ids, p_mask) at seq 128; the cross-encoder (ids, mask, token
    types, labels) at seq 512; CLIP (224 x 224 images, 77-token ids ending in
    EOT, mask). Rows are padded after a length drawn from the upper half."""

    rng = np.random.default_rng(seed)
    s = TRAIN_SHAPES[kind][1]

    def padded(eot=None):
        lengths = rng.integers(s // 2, s + 1, b)
        ids = rng.integers(1000, 29000, (b, s)).astype(np.int32)
        mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
        if eot is not None:
            ids[np.arange(b), lengths - 1] = eot
        return ids * mask, mask

    if kind == "minilm":
        return (*padded(), *padded())
    if kind == "cross":
        ids, mask = padded()
        tt = (np.arange(s)[None, :] >= s // 2).astype(np.int32) * mask
        return ids, mask, tt, rng.integers(0, 2, b).astype(np.float32)
    images = rng.standard_normal((b, 224, 224, 3)).astype(np.float32)
    return (images, *padded(eot=49407))


def _encoder_flops(tokens: int, seqs: int, s: int, h: int, inter: int, layers: int) -> float:
    """Forward FLOPs of the products of ``layers`` encoder layers: q|k|v, the
    output projection, the MLP, and the attention's two products."""

    return layers * (2.0 * tokens * (4 * h * h + 2 * h * inter) + 4.0 * seqs * s * s * h)


def _train_flops(kind: str, b: int) -> float:
    """A step's FLOPs: 3 x the forward's products (the backward computes two
    products for each of the forward's); elementwise work and the optimizer
    are not counted."""

    from mmrag_tpu_torch.models import bert, clip

    if kind in ("minilm", "cross"):
        c, s = bert.MINILM_L6, TRAIN_SHAPES[kind][1]
        fwd = _encoder_flops(b * s, b, s, c.hidden_size, c.intermediate_size, c.num_layers)
        fwd *= 2 if kind == "minilm" else 1  # queries and positives
    else:
        v, t, p = clip.CLIP_VIT_B32.vision, clip.CLIP_VIT_B32.text, clip.CLIP_VIT_B32.projection_dim
        sv, st = v.num_patches + 1, t.max_position
        fwd = (2.0 * b * v.num_patches * 3 * v.patch_size ** 2 * v.hidden_size
               + _encoder_flops(b * sv, b, sv, v.hidden_size, v.intermediate_size, v.num_layers)
               + _encoder_flops(b * st, b, st, t.hidden_size, t.intermediate_size, t.num_layers)
               + 2.0 * b * (v.hidden_size + t.hidden_size) * p)
    return 3.0 * fwd


def _tower(kind: str):
    """(state init, step maker, config, seed, converted-weights subdir)."""

    from mmrag_tpu_torch.models import bert, clip
    from mmrag_tpu_torch.models.runtime import _sanitize
    from mmrag_tpu_torch.parallel import training as ttr
    from mmrag_tpu_torch.settings import load_settings

    models = load_settings({}).models
    return {
        "minilm": (ttr.minilm_train_state_init, ttr.make_minilm_train_step, bert.MINILM_L6, 0,
                   _sanitize(models.text)),
        "cross": (ttr.cross_encoder_train_state_init, ttr.make_cross_encoder_train_step,
                  bert.MINILM_L6, 2, _sanitize(models.reranker)),
        "clip": (ttr.train_state_init, ttr.make_train_step, clip.CLIP_VIT_B32, 1,
                 _sanitize(models.clip)),
    }[kind]


def _train_weights(kind: str):
    """The tower's f32 weights for its state init: the converted ones (a
    tree on the CPU) when ``WEIGHTS_DIR`` holds them, else the runtime's
    seed."""

    from mmrag_tpu_torch.models import convert

    _, _, cfg, seed, sub = _tower(kind)
    wdir = os.path.join(os.environ.get("WEIGHTS_DIR", ""), sub)
    if os.environ.get("WEIGHTS_DIR") and convert.params_available(wdir, "model"):
        return convert.params_from_jax(convert.load_params(wdir, "model"), kind, cfg)
    return seed


def _train_init(kind: str, device: str, mesh=None):
    init, _, cfg, _, _ = _tower(kind)
    return init(_train_weights(kind), mesh, cfg, device=device)


def _grads(params) -> dict:
    """Each leaf's gradient by ``/``-joined path, split leaves joined."""

    from mmrag_tpu_torch.parallel import mesh as tmesh

    grads = tmesh.map_with_path(
        lambda _, t: tmesh.Sharded([g.grad for g in t.shards], t.dim, t.blocks)
        if isinstance(t, tmesh.Sharded) else t.grad, params)
    out = {}
    tmesh.map_with_path(lambda path, g: out.__setitem__("/".join(path), g),
                        tmesh.gather_params(grads))
    return out


def _grad_err(got, want) -> tuple:
    """The largest gradient difference of any leaf over that leaf's max-abs,
    and the leaf."""

    worst = (0.0, "")
    ref = _grads(want)
    for key, g in _grads(got).items():
        w = ref[key]
        err = float((g.to(w.device) - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, (err, key))
    return worst


def _train_run(kind: str, seed: int, smi: str, ckdir: str):
    """The learning run: ``TRAIN_STEPS`` steps on one fixed full-width batch
    on the card, timed (CUDA synchronized); the minimum of the last 3 losses
    must be below the first. MiniLM saves its state at ``TRAIN_SAVE_AT``.
    Then one step under ``torch.profiler`` (device busy time, idle share,
    kernels a step). Returns the trained params and the losses."""

    import torch

    from mmrag_tpu_torch.utils import checkpoint

    b, s = TRAIN_SHAPES[kind]
    batch = tuple(torch.from_numpy(a).cuda() for a in _train_batch(kind, b, seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt, tx = _train_init(kind, "cuda")
    step = _tower(kind)[1](None, _tower(kind)[2])
    losses, wall = [], []
    for i in range(1, TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, *batch)
        losses.append(loss.item())  # synchronizes
        wall.append((time.perf_counter() - t0) * 1e3)
        if kind == "minilm" and i == TRAIN_SAVE_AT:
            checkpoint.save_train_state(ckdir, i, {"params": params, "opt": opt.state_dict()})
    ms = float(np.median(wall[2:]))  # after two warm-up steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    # two more steps after the run: a warm one, then one under the profiler
    profiled = _profile_ms(lambda: step(params, opt, *batch)[2].item(), 1)
    flops = _train_flops(kind, b)
    emit({"phase": f"train {kind}", "card": smi, "batch": b, "seq": s, "lr": tx.learning_rate,
          "steps": TRAIN_STEPS, "losses": losses, "step_ms": wall, "step_ms_median": ms,
          "samples_per_s": b / (ms / 1e3), "peak_mem_mb": peak, "profiled_step": profiled,
          "flops_per_step": flops, "tflops": flops / (ms / 1e3) / 1e12,
          "f32_peak_share": flops / (ms / 1e3) / H100_F32_FLOPS,
          "flop_count": "3 x the forward's products (dense + attention); elementwise and "
                        "AdamW not counted"})
    if not all(np.isfinite(losses)) or not min(losses[-3:]) < losses[0]:
        raise AssertionError(f"train {kind}: the loss did not fall: {losses}")
    return params, losses, batch, ms


def _train_cpu_check(kind: str, seed: int, smi: str) -> dict:
    """One step of the tower on the card and on the CPU from the same weights
    and batch: the loss within ``TRAIN_LOSS_TOL`` relative, every gradient
    within ``TRAIN_GRAD_TOL`` of its leaf's max-abs."""

    out = {}
    batch = _train_batch(kind, TRAIN_CPU_BATCH, seed)
    for device in ("cuda", "cpu"):
        params, opt, _ = _train_init(kind, device)
        step = _tower(kind)[1](None, _tower(kind)[2])
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, *batch)
        out[device] = (params, loss.item(), time.perf_counter() - t0)
    rel = abs(out["cuda"][1] - out["cpu"][1]) / abs(out["cpu"][1])
    grad, leaf = _grad_err(out["cuda"][0], out["cpu"][0])
    emit({"phase": f"train cpu {kind}", "card": smi, "batch": TRAIN_CPU_BATCH,
          "loss_card": out["cuda"][1], "loss_cpu": out["cpu"][1], "loss_rel_err": rel,
          "grad_err_of_leaf_max": grad, "grad_err_leaf": leaf, "cpu_step_s": out["cpu"][2]})
    if not rel <= TRAIN_LOSS_TOL or not grad <= TRAIN_GRAD_TOL:
        raise AssertionError(f"train {kind}: card vs CPU loss {rel}, gradients {grad}")
    return out


def _train_mesh_check(seed: int, smi: str) -> None:
    """One CLIP step on a (data 2, model 2) mesh of the card against one
    device, from the same weights and batch: the loss within
    ``TRAIN_MESH_TOL`` relative, the gradients within ``TRAIN_GRAD_TOL`` of
    each leaf's max-abs, and the gathered parameters within
    ``TRAIN_MESH_TOL``, except where the one-device gradient is below 1e-6
    of its leaf's max-abs or 100 x Adam's eps: Adam's first step is
    ``lr * g / (|g| + eps)``, which there turns with the gradient's last
    bits (its sign, or its size next to eps), so up to 2 lr. Then a second
    mesh step, timed."""

    import torch

    from mmrag_tpu_torch.parallel import mesh as tmesh
    from mmrag_tpu_torch.parallel.training import param_leaves

    make, cfg = _tower("clip")[1:3]
    b = TRAIN_SHAPES["clip"][0]
    batch = tuple(torch.from_numpy(a).cuda() for a in _train_batch("clip", b, seed))
    one, opt, tx = _train_init("clip", "cuda")
    one, opt, want = make(None, cfg)(one, opt, *batch)
    del opt
    grid = tmesh.build_mesh(model_parallel=2, devices=["cuda:0"] * 4)
    params, opt, _ = _train_init("clip", None, grid)
    step = make(grid, cfg)
    params, opt, loss = step(params, opt, *batch)
    loss = loss.item()
    grad, leaf = _grad_err(params, one)
    # copies: a replicated leaf is the live tensor the timed step updates
    gathered = [t.detach().clone() for t in param_leaves(tmesh.gather_params(params))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, opt, *batch)[2].item()
    ms = (time.perf_counter() - t0) * 1e3
    lr = tx.learning_rate
    worst, apart = 0.0, 0
    for a, w in zip(gathered, param_leaves(one)):
        g = w.grad.abs()
        small = g < max(1e-6 * float(g.max()), 100 * tx.eps)
        err = (a - w.detach()).abs()
        worst = max(worst, float(err[~small].max()) if bool((~small).any()) else 0.0)
        apart += int((err[small] > TRAIN_MESH_TOL).sum())
        if bool((err[small] > 2 * lr + TRAIN_MESH_TOL).any()):
            raise AssertionError("train mesh: a small-gradient element moved beyond 2 lr")
    rel = abs(loss - want.item()) / abs(want.item())
    flops = _train_flops("clip", b)
    emit({"phase": "train mesh clip", "card": smi, "mesh": grid.shape, "batch": b,
          "loss_mesh": loss, "loss_one_device": want.item(), "loss_rel_err": rel,
          "grad_err_of_leaf_max": grad, "grad_err_leaf": leaf, "param_max_abs_err": worst,
          "small_grad_elements_apart": apart, "step_ms": ms, "samples_per_s": b / (ms / 1e3),
          "tflops": flops / (ms / 1e3) / 1e12,
          "f32_peak_share": flops / (ms / 1e3) / H100_F32_FLOPS})
    if not rel <= TRAIN_MESH_TOL or not grad <= TRAIN_GRAD_TOL or not worst <= TRAIN_MESH_TOL:
        raise AssertionError(f"train mesh: loss {rel}, gradients {grad}, parameters {worst}")


def _train_resume_check(losses, batch, ckdir: str, smi: str) -> None:
    """MiniLM restored from its step-``TRAIN_SAVE_AT`` checkpoint into a fresh
    state runs the remaining steps: the losses equal the uninterrupted run's
    within ``TRAIN_RESUME_TOL``."""

    from mmrag_tpu_torch.parallel.training import load_train_state
    from mmrag_tpu_torch.utils import checkpoint

    make, cfg = _tower("minilm")[1:3]
    params, opt, _ = _train_init("minilm", "cuda")
    t0 = time.perf_counter()
    state = checkpoint.restore_train_state(ckdir, {"params": params, "opt": opt.state_dict()})
    load_train_state(params, opt, state)
    restore_s = time.perf_counter() - t0
    step = make(None, cfg)
    resumed = [step(params, opt, *batch)[2].item() for _ in range(TRAIN_STEPS - TRAIN_SAVE_AT)]
    err = float(np.abs(np.subtract(resumed, losses[TRAIN_SAVE_AT:])).max())
    emit({"phase": "train resume minilm", "card": smi, "saved_at": TRAIN_SAVE_AT,
          "losses_resumed": resumed, "losses_uninterrupted": losses[TRAIN_SAVE_AT:],
          "max_abs_err": err, "restore_s": restore_s})
    if not err <= TRAIN_RESUME_TOL:
        raise AssertionError(f"train resume: {resumed} vs {losses[TRAIN_SAVE_AT:]}")


def _train_serve_check(trained: dict, seed: int, smi: str) -> dict:
    """The fine-tuned MiniLM and CLIP exported (``params_to_jax`` +
    ``save_params``) into a fresh ``WEIGHTS_DIR`` and served by a bf16
    ``EncoderRuntime``: 16 queries through B1 and B2, 16 images through B1
    and B3, each within ``TRAIN_SERVE_DRIFT`` (cosine) of the trained f32
    weights' xla forward on the card. Returns the launches."""

    import torch

    from mmrag_tpu_torch.models import bert, clip, convert
    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.images import CLIP_IMAGE_SIZE, preprocess_batch, stack_square_crops
    from mmrag_tpu_torch.settings import load_settings

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    for kind in ("minilm", "clip"):
        convert.save_params(convert.params_to_jax(trained[kind], kind),
                            os.path.join(tmp, "weights", _tower(kind)[4]), "model")
    runtime = EncoderRuntime(load_settings(_engine_env(tmp, WEIGHTS_DIR=os.path.join(
        tmp, "weights"))))
    runtime._ensure_minilm(), runtime._ensure_clip()
    rng = np.random.default_rng(seed)
    queries = [f"{TOPICS[i % 4]} question {i} about {_WORDS[i % len(_WORDS)]}" for i in range(16)]
    images = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8) for _ in range(16)]
    torch.cuda.synchronize()
    kernels.reset_launches()  # the served check starts here
    served = {"minilm": runtime.embed_text_batch(queries),
              "clip": runtime.embed_images_batch(images)}
    torch.cuda.synchronize()
    launches = _launches()
    with torch.no_grad():
        ids, mask = (torch.from_numpy(a).cuda() for a in runtime._bert_tok.encode(queries, 64))
        ref = {"minilm": bert.minilm_embed(trained["minilm"], ids, mask, bert.MINILM_L6,
                                           attention_impl="xla"),
               "clip": bert.l2_normalize(clip.clip_image_features(
                   trained["clip"], preprocess_batch(torch.from_numpy(stack_square_crops(
                       images, canvas=CLIP_IMAGE_SIZE)).cuda()), clip.CLIP_VIT_B32,
                   attention_impl="xla"))}
    drift = {k: _drift(served[k], ref[k].cpu().numpy()) for k in served}
    emit({"phase": "train serve", "card": smi, "runtime": "bfloat16", "queries": 16,
          "images": 16, "cosine_drift_vs_trained_f32_xla": drift,
          "launches": {k: v for k, v in launches.items() if v}})
    shutil.rmtree(tmp, ignore_errors=True)
    idle = [k for k in ("B1", "B2", "B3") if not launches[k]]
    if idle or max(drift.values()) > TRAIN_SERVE_DRIFT:
        raise AssertionError(f"train serve: {idle} not launched, drift {drift}")
    return launches


def train_pass(seed: int, smi: str) -> dict:
    """The train phase: MiniLM MNR (32 pairs at seq 128), the cross-encoder
    (16 pairs at seq 512) and CLIP (32 images at 224 against 77 tokens) fine-
    tuned at full width in f32, each learning on its fixed batch and held
    against the port on the CPU; one CLIP step on a (2, 2) mesh of the card
    against one device; MiniLM resumed from its checkpoint; no kernel of
    B1-B12 or the building kernels launched by any of it, as JAX's training
    reaches no ``pallas_call``. Then the fine-tuned MiniLM and CLIP served by
    a bf16 runtime. Returns the launches of the training and of the serving,
    each counted from 0."""

    import torch

    from mmrag_tpu_torch.ops import kernels

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()  # the training steps start here
    trained = {}
    for i, kind in enumerate(("minilm", "cross", "clip")):
        params, losses, batch, _ = _train_run(kind, seed + i, smi, tmp)
        if kind != "cross":
            trained[kind] = params
        if kind == "minilm":
            _train_resume_check(losses, batch, tmp, smi)
        del params, batch
        _train_cpu_check(kind, seed + 10 + i, smi)
    _train_mesh_check(seed + 20, smi)
    torch.cuda.synchronize()
    train_launches = _launches()
    shutil.rmtree(tmp, ignore_errors=True)
    if any(train_launches.values()):
        raise AssertionError(f"train: a kernel launched while training: {train_launches}")
    serve = _train_serve_check(trained, seed + 30, smi)
    emit({"phase": "train", "card": smi, "wall_s": time.perf_counter() - t0})
    return {"train": train_launches, "train serve": serve}


# ---------------------------------------------------------------------------
# the models/ tools: HF-layout checkpoints, the converters, the batteries
# ---------------------------------------------------------------------------

# model ids of the four families (mmrag_tpu_torch.models.probe.REAL_WEIGHT_FAMILIES)
MODELS_SEEDS = {"minilm": 100, "reranker": 101, "clip": 102, "whisper": 103}
CLIP_BOS_EOS = (49406, 49407)  # CLIP's BPE vocabulary: <|startoftext|>, <|endoftext|>
MODELS_DRIFT = 1e-3  # the bf16 runtime on the card vs the port on the CPU in f32
# the card's battery against the CPU's on the same seeded weights, where the
# gates decide nothing: the W8A8 cosine (bf16 stream, int8 codes that may flip
# at a code boundary: 1.2e-7 MiniLM, 5.3e-6 CLIP apart measured on an H100
# 80GB HBM3 at 700 W) and the PQ refined recall (k-means on another device;
# equal in that run; one hit of 160 is 0.00625, two are allowed)
MODELS_W8A8_TOL = 1e-4
MODELS_PQ_TOL = 0.0125


def _hf_linear(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(p["kernel"].T)
    if "bias" in p:
        sd[f"{name}.bias"] = p["bias"]


def _hf_ln(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]


def _hf_bert(tree: dict, prefix: str = "") -> dict:
    """An HF ``BertModel`` state dict (HF's key names and shapes) holding the
    weights of a JAX-layout BERT tree."""

    sd = {}
    emb = tree["embeddings"]
    sd[f"{prefix}embeddings.word_embeddings.weight"] = emb["word"]
    sd[f"{prefix}embeddings.position_embeddings.weight"] = emb["position"]
    sd[f"{prefix}embeddings.token_type_embeddings.weight"] = emb["token_type"]
    _hf_ln(sd, f"{prefix}embeddings.LayerNorm", emb["ln"])
    for i, layer in enumerate(tree["layers"]):
        b = f"{prefix}encoder.layer.{i}"
        for key, name in (("q", "attention.self.query"), ("k", "attention.self.key"),
                          ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                          ("ffn_in", "intermediate.dense"), ("ffn_out", "output.dense")):
            _hf_linear(sd, f"{b}.{name}", layer[key])
        _hf_ln(sd, f"{b}.attention.output.LayerNorm", layer["attn_ln"])
        _hf_ln(sd, f"{b}.output.LayerNorm", layer["ffn_ln"])
    return sd


def _hf_clip_layers(sd: dict, prefix: str, layers: list) -> None:
    for i, layer in enumerate(layers):
        b = f"{prefix}.layers.{i}"
        _hf_ln(sd, f"{b}.layer_norm1", layer["ln1"])
        _hf_ln(sd, f"{b}.layer_norm2", layer["ln2"])
        for key, name in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                          ("v", "self_attn.v_proj"), ("attn_out", "self_attn.out_proj"),
                          ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _hf_linear(sd, f"{b}.{name}", layer[key])


def _hf_clip(tree: dict, cfg) -> dict:
    """An HF ``CLIPModel`` state dict (the patch convolution (h, 3, p, p),
    HF's ``pre_layrnorm`` spelling, ``logit_scale``)."""

    v, t = tree["vision"], tree["text"]
    p = cfg.vision.patch_size
    sd = {
        "vision_model.embeddings.class_embedding": v["class_embedding"],
        "vision_model.embeddings.patch_embedding.weight": np.ascontiguousarray(
            v["patch_kernel"].T.reshape(cfg.vision.hidden_size, 3, p, p)),
        "vision_model.embeddings.position_embedding.weight": v["position_embedding"],
        "text_model.embeddings.token_embedding.weight": t["token_embedding"],
        "text_model.embeddings.position_embedding.weight": t["position_embedding"],
        "logit_scale": tree["logit_scale"],
    }
    _hf_ln(sd, "vision_model.pre_layrnorm", v["pre_ln"])
    _hf_ln(sd, "vision_model.post_layernorm", v["post_ln"])
    _hf_ln(sd, "text_model.final_layer_norm", t["final_ln"])
    _hf_clip_layers(sd, "vision_model.encoder", v["layers"])
    _hf_clip_layers(sd, "text_model.encoder", t["layers"])
    _hf_linear(sd, "visual_projection", tree["visual_projection"])
    _hf_linear(sd, "text_projection", tree["text_projection"])
    return sd


def _hf_whisper(tree: dict) -> dict:
    """An HF ``WhisperForConditionalGeneration`` state dict (``model.``
    prefix; the conv stems (out, in, 3); ``k_proj`` without a bias)."""

    sd = {}
    enc, dec = tree["encoder"], tree["decoder"]
    for name in ("conv1", "conv2"):
        k = enc[name]["kernel"]  # (3 * in, out), k-major
        sd[f"model.encoder.{name}.weight"] = np.ascontiguousarray(
            k.reshape(3, -1, k.shape[1]).transpose(2, 1, 0))
        sd[f"model.encoder.{name}.bias"] = enc[name]["bias"]
    sd["model.encoder.embed_positions.weight"] = enc["positions"]
    sd["model.decoder.embed_tokens.weight"] = dec["token_embedding"]
    sd["model.decoder.embed_positions.weight"] = dec["positions"]
    _hf_ln(sd, "model.encoder.layer_norm", enc["final_ln"])
    _hf_ln(sd, "model.decoder.layer_norm", dec["final_ln"])

    def attn(base, p):
        for key in ("q", "k", "v", "out"):
            _hf_linear(sd, f"{base}.{key}_proj", p[key])

    for i, layer in enumerate(enc["layers"]):
        b = f"model.encoder.layers.{i}"
        _hf_ln(sd, f"{b}.self_attn_layer_norm", layer["ln1"])
        attn(f"{b}.self_attn", layer["attn"])
        _hf_ln(sd, f"{b}.final_layer_norm", layer["ln2"])
        _hf_linear(sd, f"{b}.fc1", layer["fc1"])
        _hf_linear(sd, f"{b}.fc2", layer["fc2"])
    for i, layer in enumerate(dec["layers"]):
        b = f"model.decoder.layers.{i}"
        _hf_ln(sd, f"{b}.self_attn_layer_norm", layer["ln1"])
        attn(f"{b}.self_attn", layer["self_attn"])
        _hf_ln(sd, f"{b}.encoder_attn_layer_norm", layer["ln_cross"])
        attn(f"{b}.encoder_attn", layer["cross_attn"])
        _hf_ln(sd, f"{b}.final_layer_norm", layer["ln2"])
        _hf_linear(sd, f"{b}.fc1", layer["fc1"])
        _hf_linear(sd, f"{b}.fc2", layer["fc2"])
    return sd


def _hf_checkpoints() -> dict:
    """``{family: (state_dict, cfg, seeded tree)}``: full-width seeded
    weights (MiniLM-L6, the ms-marco cross-encoder, CLIP ViT-B/32,
    whisper-base) as HF state dicts with HF's key names and shapes."""

    from mmrag_tpu_torch.models import bert, clip, whisper

    minilm = bert.init_bert_params(MODELS_SEEDS["minilm"], bert.MINILM_L6)
    cross = bert.init_cross_encoder_params(MODELS_SEEDS["reranker"], bert.MINILM_L6)
    cross_sd = _hf_bert(cross["bert"], "bert.")
    _hf_linear(cross_sd, "bert.pooler.dense", cross["pooler"])
    _hf_linear(cross_sd, "classifier", cross["classifier"])
    ctree = clip.init_clip_params(MODELS_SEEDS["clip"], clip.CLIP_VIT_B32)
    wtree = whisper.init_whisper_params(MODELS_SEEDS["whisper"], whisper.WHISPER_BASE)
    return {
        "minilm": (_hf_bert(minilm), bert.MINILM_L6, minilm),
        "reranker": (cross_sd, bert.MINILM_L6, cross),
        "clip": (_hf_clip(ctree, clip.CLIP_VIT_B32), clip.CLIP_VIT_B32, ctree),
        "whisper": (_hf_whisper(wtree), whisper.WHISPER_BASE, wtree),
    }


def models_pass(seed: int, smi: str) -> dict:
    """The models phase: seeded full-width HF-layout checkpoints converted by
    the port's converters (each equal to the seeded tree it was made from)
    and written with ``save_params`` into a ``WEIGHTS_DIR``; the production
    ``EncoderRuntime`` booted from it on the card (bf16) against the port on
    the CPU in f32 on the same files; then each family's battery
    (``mmrag_tpu_torch.models.validate``) on the card with the port's CPU f32
    outputs as the reference, and on the CPU, the two held against each
    other. Returns the phase's launch counts."""

    import torch

    from mmrag_tpu_torch.cache import clear_all_caches
    from mmrag_tpu_torch.models import convert, validate
    from mmrag_tpu_torch.models.probe import REAL_WEIGHT_FAMILIES
    from mmrag_tpu_torch.models.runtime import EncoderRuntime, _sanitize
    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.settings import load_settings

    phase_t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_models_")
    weights = os.path.join(tmp, "weights")
    t0 = time.perf_counter()
    ckpts = _hf_checkpoints()
    converters = {"minilm": convert.convert_bert, "reranker": convert.convert_cross_encoder,
                  "clip": convert.convert_clip, "whisper": convert.convert_whisper}
    for fam, (sd, cfg, tree) in ckpts.items():
        conv = converters[fam](sd, cfg)
        got, want = convert.flatten_params(conv), convert.flatten_params(tree)
        if sorted(got) != sorted(want) or any(not np.array_equal(got[k], want[k]) for k in got):
            raise AssertionError(f"models: converting the {fam} checkpoint lost its weights")
        convert.save_params(conv, os.path.join(weights, _sanitize(REAL_WEIGHT_FAMILIES[fam])),
                            "model", meta={"arch": fam})
    convert_s = time.perf_counter() - t0

    clear_all_caches()
    kernels.reset_launches()  # this phase starts here
    env = _engine_env(tmp, WEIGHTS_DIR=weights)
    cfg = load_settings(env)
    card, cpu = EncoderRuntime(cfg), EncoderRuntime(cfg, device="cpu")
    word = card._ensure_minilm()["embeddings"]["word"]
    if not torch.equal(word.cpu(), torch.from_numpy(ckpts["minilm"][2]["embeddings"]["word"])):
        raise AssertionError("models: the runtime did not load the converted MiniLM")
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(_WORDS, size=int(rng.integers(8, 60)))) for _ in range(8)]
    images = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8) for _ in range(4)]
    drift = {}
    for name, a, b in (
        ("minilm", card.embed_text_batch(texts), cpu.embed_text_batch(texts)),
        ("clip_text", card.embed_queries_for_images(texts), cpu.embed_queries_for_images(texts)),
        ("clip_image", card.embed_images_batch(images), cpu.embed_images_batch(images)),
    ):
        drift[name] = float(1.0 - (a * b).sum(1).min())
    query = [TOPICS[0]] * 8
    ra, rb = card.rerank_pairs(query, texts), cpu.rerank_pairs(query, texts)
    runtime = {"card_dtype": str(card.compute_dtype).split(".")[-1], "embedding_drift": drift,
               "rerank_max_abs_err": float(np.abs(ra - rb).max()),
               "rerank_spread": float(np.ptp(rb)), "rerank_min_gap": _min_gap(rb),
               "rerank_order_kept": _order_kept(ra, rb, 2 * RERANK_TOL_BF16)}
    emit({"phase": "models runtime", "card": smi, "convert_and_save_s": convert_s, **runtime})
    if (max(drift.values()) > MODELS_DRIFT or not runtime["rerank_order_kept"]
            or runtime["rerank_max_abs_err"] > RERANK_TOL_BF16):
        raise AssertionError(f"models: the runtime on converted weights is off: {runtime}")
    if not runtime["rerank_spread"] > 20 * RERANK_TOL_F32:
        raise AssertionError(f"models: the rerank check is blind: {runtime}")
    del card, cpu
    clear_all_caches()

    reports = {}
    for fam, (sd, mcfg, _) in ckpts.items():
        bos_eos = CLIP_BOS_EOS if fam == "clip" else None
        t0 = time.perf_counter()
        want = validate.reference_outputs(fam, sd, mcfg, "cpu", bos_eos)
        battery = {"minilm": lambda dev: validate.minilm_battery(sd, mcfg, want, device=dev),
                   "reranker": lambda dev: validate.reranker_battery(sd, mcfg, want, device=dev),
                   "clip": lambda dev: validate.clip_battery(sd, mcfg, want, *CLIP_BOS_EOS,
                                                             device=dev),
                   "whisper": lambda dev: validate.whisper_battery(sd, mcfg, want,
                                                                   device=dev)}[fam]
        on_cpu = validate.public_report(battery("cpu"))
        cpu_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = validate.public_report(battery("cuda"))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        on_card.pop("config")
        on_cpu.pop("config")
        emit({"phase": f"models {fam}", "card": smi, "report": on_card, "cpu_report": on_cpu,
              "battery_card_s": card_s, "battery_cpu_s": cpu_s})
        if not on_card["parity_ok"]:
            raise AssertionError(f"models {fam}: the card's battery is off the CPU: {on_card}")
        if "w8a8_cosine_vs_f32" in on_card and abs(
                on_card["w8a8_cosine_vs_f32"] - on_cpu["w8a8_cosine_vs_f32"]) > MODELS_W8A8_TOL:
            raise AssertionError(f"models {fam}: W8A8 cosine card {on_card} vs cpu {on_cpu}")
        if "pq_refined_recall_at_10" in on_card and abs(
                on_card["pq_refined_recall_at_10"]
                - on_cpu["pq_refined_recall_at_10"]) > MODELS_PQ_TOL:
            raise AssertionError(f"models {fam}: PQ recall card {on_card} vs cpu {on_cpu}")
        reports[fam] = on_card
    launches = _launches()  # the whole phase, read just after it
    idle = [k for k in ("B1", "B2", "B3", "B5", "B6", "B7", "B10", "B11") if launches[k] <= 0]
    emit({"phase": "models", "card": smi, "launches": launches,
          "phase_s": time.perf_counter() - phase_t0})
    if idle:
        raise AssertionError(f"models: the phase never launched {idle}: {launches}")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# X1: TPU_TOPK_BACKEND=approx on VectorIndex, one device and the mesh
# ---------------------------------------------------------------------------

APPROX_ROWS = 1 << 20
APPROX_K = {"text": 50, "image": 12}  # the engine's k (mmrag_tpu/config.py:90)
APPROX_RECALL = 0.95  # cosine_topk's recall_target (JAX's default)
# the fills: TopicGeometry's doc_rows and the k searched. 16-chunk documents
# aligned to the buckets, then documents of 32-96 chunks (mean 64; a 10-page
# PDF is about 30 at the port's chunking) across bucket edges, where a query's
# top-50 may fill most of one bucket (the case the 48 rows a bucket are for)
APPROX_DOCS = {"16-chunk documents": (None, APPROX_K),
               "32-96-chunk documents": ((32, 96), {"text": APPROX_K["text"]})}


def _most_in_a_bucket(exact) -> int:
    """The most true top-k rows any query has in one 128-row bucket."""

    return max(int(np.bincount(np.fromiter(e, np.int64) // 128).max()) for e in exact if e)


def approx_pass(seed: int, smi: str) -> dict:
    """``VectorIndex(backend="approx")`` at 1,048,576 x 384 bf16, three
    tenants filled by ``_fill_topic``'s recipe (each document's chunks in
    contiguous rows: 16-chunk documents, then documents of 32-96 chunks), on
    one device and on a ``MESH_SHARDS``-shard mesh of the card: at each k
    of ``APPROX_DOCS`` (the engine's text 50 and image 12) 16 coalesced
    searches (one with a document filter) and 4 single ones, tenant and
    document isolation, recall@k against the exact top-k of the f32 rows at
    least 0.95 and every query's against the exact path (B4) on the same
    bf16 rows at least ``min(1, APPROX_TOP / k)``, K-bmax-top and
    K-bmax-topk-merge launched once a search a shard, neither K-bmax, B4 nor
    phases B and C; ms per
    search at q1 and q16 beside the exact ``auto`` path on the same rows.
    Returns the pass's launch counts."""

    import torch

    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.ops import kernels, pallas_topk
    from mmrag_tpu_torch.storage.records import VectorRow

    n, d = APPROX_ROWS, 384
    t = kernels.APPROX_TOP
    rng = np.random.default_rng(seed)
    calls = {"phases_bc": 0}
    real_rows = pallas_topk._topk_rows

    def counted(*args, **kw):  # phases B and C of the exact path
        calls["phases_bc"] += 1
        return real_rows(*args, **kw)

    kernels.reset_launches()  # this pass starts here
    results = {}
    for docs_name, (doc_rows, ks) in APPROX_DOCS.items():
        geo = TopicGeometry(rng, n, d, doc_rows=doc_rows)
        host = np.empty((n, d), np.float32)
        indexes = {"single": VectorIndex(dim=d, backend="approx"),
                   "sharded": VectorIndex(dim=d, backend="approx", mesh=_mesh(MESH_SHARDS))}
        t0 = time.perf_counter()
        for a in range(0, n, 131072):
            b = min(a + 131072, n)
            host[a:b] = vecs = geo.rows(a, b)
            rows = [VectorRow(chunk_id=f"r{a + i}", user_id=geo.tenant(a + i),
                              document_id=geo.doc(a + i), modality="text", embedding=vecs[i])
                    for i in range(b - a)]
            for index in indexes.values():
                index.upsert(rows)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        rows_dev = torch.from_numpy(host).cuda()
        found = {"fill_s": fill_s, "documents": int(geo.doc_of[-1]) + 1}
        pallas_topk._topk_rows = counted
        try:
            for name, index in indexes.items():
                shards = MESH_SHARDS if name == "sharded" else 1
                for kind, k in ks.items():
                    sel = rng.choice(n, 16, replace=False)
                    queries = _near_queries(rng, host, sel)
                    users = [geo.tenant(i) for i in sel]
                    docs = [geo.doc(i) if j == 5 else None for j, i in enumerate(sel)]
                    torch.cuda.synchronize()
                    before, bc = _launches(), calls["phases_bc"]
                    hits = index.search_batch_multi(queries, users, k, docs)
                    singles = [index.search(queries[j], users[j], k) for j in range(4)]
                    torch.cuda.synchronize()
                    used = {key: v - before[key] for key, v in _launches().items()}
                    if (used["K-bmax-top"] != 5 * shards
                            or used["K-bmax-topk-merge"] != 5 * shards or used["B4"]
                            or used["K-bmax"] or calls["phases_bc"] != bc):
                        raise AssertionError(f"approx {name} {kind}: searches launched {used}, "
                                             f"phases B+C ran {calls['phases_bc'] - bc} times")
                    for h, user, doc in list(zip(hits, users, docs)) + [
                            (h, users[j], None) for j, h in enumerate(singles)]:
                        if len(h) != k:
                            raise AssertionError(f"approx {name}: {len(h)} hits for {user}, "
                                                 f"k {k}")
                        for cid, _ in h:
                            row = index._chunk_to_row[cid]
                            if geo.tenant(row) != user or (doc is not None
                                                           and geo.doc(row) != doc):
                                raise AssertionError(f"approx {name}: {cid} served to "
                                                     f"{user}/{doc}")
                    for j, h in enumerate(singles):
                        if [c for c, _ in h] != [c for c, _ in hits[j]]:
                            raise AssertionError(f"approx {name}: single {j} differs from the "
                                                 "batch")
                    exact = _exact_ids(rows_dev, index, queries, users, docs, k)
                    recall = _recall(hits, exact, index, k)
                    ms = {"approx": {"q1": _search_ms(index, queries[:1], users[:1], k=k),
                                     "q16": _search_ms(index, queries, users, k=k)}}
                    index._topk = "auto"  # the exact path (B4) on the same rows
                    ms["exact"] = {"q1": _search_ms(index, queries[:1], users[:1], k=k),
                                   "q16": _search_ms(index, queries, users, k=k)}
                    b4 = index.search_batch_multi(queries, users, k, docs)
                    index._topk = "approx"
                    exact_recall = _recall(b4, exact, index, k)
                    # the guarantee is on the index's own (bf16) scores: each
                    # query against the exact path's answer on the same rows
                    b4_rows = [{index._chunk_to_row[c] for c, _ in h} for h in b4]
                    per = [_recall([h], [e], index, k) for h, e in zip(hits, b4_rows)]
                    found[f"{name} {kind}"] = {
                        "k": k, "recall_at_k": recall, "exact_path_recall_at_k": exact_recall,
                        "least_recall_vs_exact_path": min(per),
                        "most_top_k_rows_in_a_bucket": _most_in_a_bucket(b4_rows),
                        "search_ms": ms, "launches_searches": used}
                    if recall < APPROX_RECALL or min(per) < min(1.0, t / k):
                        raise AssertionError(f"approx {name} {kind} ({docs_name}): recall@{k} "
                                             f"{recall} (least against the exact path "
                                             f"{min(per)}), below {APPROX_RECALL} / "
                                             f"{min(1.0, t / k)}")
        finally:
            pallas_topk._topk_rows = real_rows
        results[docs_name] = found
        del indexes, rows_dev, host
        torch.cuda.empty_cache()
    launches = _launches()
    emit({"phase": "approx", "card": smi, "rows": n, "shards": MESH_SHARDS,
          "top_rows_a_bucket": t, **results, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# item 8d: the sharded search across two processes of one card
# ---------------------------------------------------------------------------

DCN_ROWS = 1 << 20
DCN_BLOCK = 131072
DCN_K = 50
DCN_SHARDS = 2  # each process's own mesh on cuda:0
DCN_SCORE_TOL = 1e-6  # same candidate product shapes on both sides: equal expected


def _dcn_rows(lo: int, hi: int, seed: int):
    """Rows [lo, hi) of the seeded bf16 unit corpus, made on the card block
    by block, so any process makes its own rows and only those."""

    import torch

    parts = []
    for b in range(lo // DCN_BLOCK, -(-hi // DCN_BLOCK)):
        gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + b)
        x = torch.randn((DCN_BLOCK, 384), generator=gen, device="cuda")
        parts.append((x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16))
    rows = torch.cat(parts)
    off = lo - (lo // DCN_BLOCK) * DCN_BLOCK
    return rows[off:off + hi - lo].contiguous()


def _dcn_inputs(seed: int):
    """The ``(n,)`` mask (tenant 0 of three, 16-row documents) and 16 unit
    queries, on the card."""

    import torch

    mask = ((torch.arange(DCN_ROWS, device="cuda") // 16) % 3) == 0
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((16, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return mask, torch.from_numpy(q).cuda()


def dcn_worker(rank: int, port: int, out: str, seed: int) -> None:
    """One of the two processes of the dcn phase: joins the gloo group
    through ``initialize_multihost``, makes its half of the corpus on the
    card, searches it on its own 2-shard mesh through ``sharded_topk_fn``
    (q1 and q16, k 50) and writes the results, times and B4 launches."""

    import torch

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.parallel.mesh import build_mesh, initialize_multihost, row_sharded
    from mmrag_tpu_torch.parallel.sharded_index import sharded_topk_fn

    if not initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu"):
        raise RuntimeError("initialize_multihost did not join")
    dist = torch.distributed
    if dist.get_backend() != "gloo" or dist.get_world_size() != 2:
        raise RuntimeError(f"{dist.get_backend()} group of {dist.get_world_size()}")
    half = DCN_ROWS // 2
    corpus = _dcn_rows(rank * half, (rank + 1) * half, seed)
    mask, queries = _dcn_inputs(seed)
    mesh = build_mesh(devices=["cuda:0"] * DCN_SHARDS)
    shards = (row_sharded(mesh, corpus), row_sharded(mesh, mask[rank * half:(rank + 1) * half]))
    fn = sharded_topk_fn(mesh, DCN_K, group=dist.group.WORLD)
    kernels.reset_launches()
    res = {}
    for q in (1, 16):
        for _ in range(2):
            fn(queries[:q], *shards)
        times = []
        for _ in range(5):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores, ids = fn(queries[:q], *shards)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res[f"q{q}_scores"], res[f"q{q}_ids"] = scores.cpu().numpy(), ids.cpu().numpy()
        res[f"q{q}_ms"] = np.float64(np.median(times))
    res["launches"] = np.array(json.dumps(_launches()))
    np.savez(out, **res)
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dcn_pass(seed: int, smi: str) -> dict:
    """Item 8d on one card: two fresh processes (``--dcn-worker``) join a
    gloo group through ``initialize_multihost`` (NCCL refuses two ranks on
    one device, so the merge's (q, 50) slices cross the host; the search
    stays on the card), each holding 524,288 of 1,048,576 x 384 bf16 rows;
    their ``sharded_topk_fn`` results at q1 and q16 must give this
    process's one-device search of the whole corpus (ids, and scores within
    ``DCN_SCORE_TOL``), and each worker must have launched B4. ms per search
    beside the one-process time: the path, not a multi-GPU speed. Returns
    the pass's launch counts (this process's and both workers')."""

    import torch

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.ops.topk import cosine_topk

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dcn_")
    port = _free_port()
    outs = [os.path.join(tmp, f"rank{r}.npz") for r in (0, 1)]
    here = os.path.abspath(__file__)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, here, "--dcn-worker", str(r), str(port), outs[r],
                               str(seed)], cwd=os.path.dirname(here), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    workers_s = time.perf_counter() - t0
    for p, (out, err) in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"dcn worker failed rc={p.returncode}: {err[-3000:]}")
    got = []
    for path in outs:
        with np.load(path) as data:
            got.append({k: data[k] for k in data.files})
    kernels.reset_launches()  # this process's part of the pass
    corpus = _dcn_rows(0, DCN_ROWS, seed)
    mask, queries = _dcn_inputs(seed)
    res = {"workers_s": workers_s}
    for q in (1, 16):
        ws, wi = cosine_topk(queries[:q], corpus, mask, DCN_K)
        ws, wi = ws.cpu().numpy(), wi.cpu().numpy()
        one_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cosine_topk(queries[:q], corpus, mask, DCN_K)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t1) * 1e3)
        for r, g in enumerate(got):
            err = float(np.abs(g[f"q{q}_scores"] - ws).max())
            if not np.array_equal(g[f"q{q}_ids"], wi) or err > DCN_SCORE_TOL:
                raise AssertionError(f"dcn q{q}: rank {r} differs from one process (score err "
                                     f"{err})")
        res[f"q{q}"] = {"two_process_ms": [float(g[f"q{q}_ms"]) for g in got],
                        "one_process_ms": float(np.median(one_ms)),
                        "max_abs_err": max(float(np.abs(g[f"q{q}_scores"] - ws).max())
                                           for g in got)}
    launches = _launches()
    workers = [json.loads(str(g["launches"])) for g in got]
    for r, w in enumerate(workers):
        if w["B4"] <= 0:
            raise AssertionError(f"dcn: worker {r} never launched B4: {w}")
        for key in launches:
            launches[key] += w[key]
    emit({"phase": "dcn", "card": smi, "rows": DCN_ROWS, "processes": 2,
          "shards_a_process": DCN_SHARDS, "group": "gloo", "k": DCN_K, **res,
          "worker_launches": workers})
    del corpus
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


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


# ---------------------------------------------------------------------------
# the flagship forward, the multi-device dry run and the encoder op profiler
# ---------------------------------------------------------------------------

GRAFT_DRIFT_TOL = 1e-3  # the bf16 contract (PERF.md section 2)
# the kernels each part of the dry run launches (its training step is plain
# torch, as JAX's reaches no pallas_call)
DRYRUN_LAUNCHES = {"engine": ("B1", "B2", "B4", "B5"), "pq": ("B10", "B11"),
                   "ivf float32": ("B8",), "ivf pq": ("B11",), "train": ()}
# the building kernels each op-profile target's step launches
PROFILE_KERNELS = {"minilm": ("K-gemm", "K-ln", "K-attn"),
                   "minilm512": ("K-gemm", "K-ln", "K-attn"),
                   "minilm_q8": ("K-gemm-i8", "K-quant", "K-ln", "K-attn"),
                   "minilm512_q8": ("K-gemm-i8", "K-quant", "K-ln", "K-attn"),
                   "clip": ("K-gemm", "K-ln", "K-attn"), "clip_text": ("K-attn",)}


def graft_pass(smi: str) -> dict:
    """``mmrag_tpu_torch.graft_entry``: ``entry()``'s forward on the card in
    bf16 against the same forward on the CPU in f32 over the same seeded
    params and images (cosine drift within the bf16 contract), B1 and B3
    (K-ln, K-gemm, K-attn) launched, its median ms over 10 calls (CUDA
    events); then ``dryrun_multichip(4)`` on four shards of the card, its
    seconds, its report and each part's kernels. Returns the launches."""

    import torch

    from mmrag_tpu_torch import graft_entry
    from mmrag_tpu_torch.ops import kernels

    kernels.reset_launches()  # this path starts here
    forward, (params, images) = graft_entry.entry()
    got = forward(params, images).float().cpu().numpy()
    once = _launches()
    for name in ("B1", "B3", "K-ln", "K-gemm", "K-attn"):
        if once[name] <= 0:
            raise AssertionError(f"entry()'s forward did not launch {name}: {once}")
    fwd_cpu, (params_cpu, images_cpu) = graft_entry.entry(device="cpu")
    want = fwd_cpu(params_cpu, images_cpu).numpy()
    del params_cpu
    drift = _drift(got, want)
    ms = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        forward(params, images)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    emit({"phase": "graft entry", "card": smi, "images": tuple(images.shape),
          "dtype": str(params["vision"]["patch_kernel"].dtype).split(".")[-1],
          "out_shape": got.shape, "cosine_drift_vs_cpu_f32": drift,
          "forward_ms_median": float(np.median(ms)), "forward_ms": ms,
          "launches_one_forward": {k: v for k, v in once.items() if v}})
    if not np.isfinite(got).all() or got.shape != (8, 512) or drift > GRAFT_DRIFT_TOL:
        raise AssertionError(f"entry()'s forward off: shape {got.shape}, drift {drift}")
    del params

    t0 = time.perf_counter()
    report = graft_entry.dryrun_multichip(4, devices=["cuda:0"] * 4)
    dry_s = time.perf_counter() - t0
    emit({"phase": "graft dryrun_multichip", "card": smi, "shards": 4, "seconds": dry_s,
          "report": report})
    for part, names in DRYRUN_LAUNCHES.items():
        got_part = report["launches"][part]
        if any(got_part.get(name, 0) <= 0 for name in names) or (not names and got_part):
            raise AssertionError(f"dry run part {part} launched {got_part}, expected {names}")
    return _launches()


def op_profile_pass(smi: str) -> dict:
    """``mmrag_tpu_torch.tools.op_profile`` on every target at JAX's shapes
    (bf16, 20 steps after a warm-up): device ms a step, the top 5 kernels a
    step, the hand-written kernels' share, and each target's building
    kernels present in its table. Returns the launches."""

    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.tools import op_profile

    kernels.reset_launches()
    for target in op_profile.TARGETS:
        t0 = time.perf_counter()
        res = op_profile.profile(target)
        names = {r["name"]: r for r in res["by_kernel"] if r["hand_written"]}
        emit({"phase": f"op_profile {target}", "card": smi, "seconds": time.perf_counter() - t0,
              "device_ms_per_step": res["total_us_per_step"] / 1e3,
              "hand_written_share": res["hand_written_share"],
              "top5": [{k: r[k] for k in ("name", "us_per_step", "share", "launches_per_step")}
                       for r in res["by_kernel"][:5]],
              "top5_shapes": [{k: r[k] for k in ("name", "op", "us_per_step",
                                                 "launches_per_step")}
                              for r in res["by_kernel_shape"][:5]]})
        missing = [k for k in PROFILE_KERNELS[target] if k not in names]
        if missing or not res["total_us_per_step"] > 0:
            raise AssertionError(f"op_profile {target}: no device time of {missing}: {res}")
    return _launches()


def r15_pass(depth: dict, seed: int, smi: str) -> None:
    """``--r15``: the int8 pass's coalesced search (its ``serve int8`` line's
    ``search_split_ms``) where the full run has it, after the served phases;
    before them; and after them without the index journal."""

    _, bf16_runtime = main_path(depth, seed)
    depth_q8 = dict(depth, text_rows=1 << 18, image_rows=1 << 16)
    emit({"phase": "r15", "variant": "int8 before serve http / serve asr"})
    main_path(depth_q8, seed, quant=True, bf16_runtime=bf16_runtime)
    serve_http_pass(seed + 11, bf16_runtime, smi)
    serve_asr_pass(seed + 13, bf16_runtime, smi)
    emit({"phase": "r15", "variant": "int8 after serve http / serve asr (the full run's)"})
    main_path(depth_q8, seed, quant=True, bf16_runtime=bf16_runtime)
    emit({"phase": "r15", "variant": "int8 after serve http / serve asr, journal off"})
    main_path(depth_q8, seed, quant=True, bf16_runtime=bf16_runtime, journal=False)


def main(argv) -> int:
    import torch

    if argv[:1] == ["--dcn-worker"]:  # one process of the dcn phase
        rank, port, out, seed = argv[1:5]
        dcn_worker(int(rank), int(port), out, int(seed))
        return 0
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

    from mmrag_tpu_torch import native

    t0 = time.perf_counter()
    # the native host runtime (g++) builds beside the CUDA sources (nvcc)
    native_build = threading.Thread(target=native.load)
    native_build.start()
    seconds = kernels.build_all()
    native_build.join()
    native.load()  # raises here if the native build failed
    build_s = time.perf_counter() - t0
    ptxas = {}
    for src in kernels.SOURCES:
        ptxas[src] = [line.strip() for line in kernels.build_log(src).splitlines()
                      if "registers" in line or "spill" in line]
    emit({"phase": "build", "wall_s": build_s, "per_source_s": seconds, "ptxas": ptxas,
          "native": os.path.relpath(native.library_path(), os.path.dirname(kernels.CSRC))})
    if "--r15" in argv:
        r15_pass({"text_chunks": 2048, "images": 256, "text_rows": 1 << 20,
                  "image_rows": 131072}, seed, smi)
        return 0
    bf16, f32 = torch.bfloat16, torch.float32
    results = []
    cases = [
        lambda: phase_b1((128, 512, 384, 12, False), bf16, 14),
        lambda: phase_b1((8, 512, 384, 12, False), bf16, 1),
        lambda: phase_b1((32, 64, 384, 12, False), bf16, 2),
        lambda: phase_b1((128, 56, 768, 12, True), bf16, 3),
        lambda: phase_b2(4096, 384, bf16, 4),
        lambda: phase_b2(65536, 384, f32, 56, delta=False, out_dtype=bf16),
        # the query towers' (8 x 64 tokens) and the coalesced call's (32 x 64)
        # add-LN, the rerank's post-LN at 8 x 512, CLIP vision's pre-LN
        lambda: phase_b2(512, 384, bf16, 60),
        lambda: phase_b2(512, 384, f32, 61, delta=False, out_dtype=bf16),
        lambda: phase_b2(2048, 384, bf16, 62),
        lambda: phase_b2(4096, 384, f32, 63, delta=False, out_dtype=bf16),
        lambda: phase_b2(7168, 768, bf16, 64, delta=False, pre_ln=True),
        lambda: phase_b3(7168, 768, 3072, bf16, 5),
        lambda: phase_b4(1 << 20, 384, 1, True, bf16, 6),
        lambda: phase_b4(1 << 20, 384, 16, True, bf16, 7),
        lambda: phase_b4(131072, 512, 16, False, bf16, 8),
        lambda: phase_kbmax(1 << 20, 384, 16, True, 38),
        lambda: phase_kbmax(131072, 512, 16, False, 39),
        lambda: phase_kbmax_top(1 << 20, 384, 16, True, 66),
        lambda: phase_kbmax_top(1 << 20, 384, 1, True, 70),
        lambda: phase_kbmax_top(131072, 512, 16, False, 67),
        lambda: phase_topk_merge(1 << 20, 384, 16, True, 71),
        lambda: phase_topk_merge(1 << 20, 384, 1, True, 72),
        lambda: phase_x1(1 << 20, 384, 16, True, 68),
        lambda: phase_x1(1 << 20, 384, 1, True, 69),
        # above the lists' capacity: one bucket a block, the merge in its scratch
        lambda: phase_x1(1 << 20, 384, 16, True, 74, k=100),
        lambda: phase_kgemm(7168, 768, 3072, "quick_gelu", False, 40),
        lambda: phase_kgemm(7168, 3072, 768, "none", True, 41),
        lambda: phase_kgemm(65536, 384, 1152, "none", False, 42),
        lambda: phase_kgemm_i8(65536, 384, 1152, "none", False, bf16, 43),
        lambda: phase_kgemm_i8(65536, 384, 384, "none", True, f32, 44),
        lambda: phase_kgemm_i8(65536, 384, 1536, "gelu_erf", False, f32, 45),
        lambda: phase_kgemm_i8(65536, 1536, 384, "none", True, f32, 46),
        lambda: phase_kgemm_i8(7168, 768, 3072, "quick_gelu", False, f32, 47),
        lambda: phase_kgemm_i8(7168, 3072, 768, "none", True, bf16, 48),
        lambda: phase_kquant(65536, 384, bf16, 49),
        lambda: phase_kquant(65536, 384, f32, 51),
        lambda: phase_kquant(65536, 1536, f32, 50),
        lambda: phase_kquant(7168, 768, bf16, 52, ln=True),
        lambda: phase_kquant(7168, 3072, f32, 53),
        lambda: phase_b5(16, 77, 512, 8, bf16, 15),
        lambda: phase_b6((128, 512, 384, 12, False), bf16, 16),
        lambda: phase_b6((8, 512, 384, 12, False), bf16, 17),
        lambda: phase_b6((32, 64, 384, 12, False), bf16, 18),
        lambda: phase_b6((128, 56, 768, 12, True), bf16, 19),
        lambda: phase_b7(7168, 768, 3072, True, "quick_gelu", bf16, 20),
        lambda: phase_b7(65536, 384, 1536, False, "gelu_tanh", bf16, 21),
        lambda: phase_b8(2048, 768, 384, 16, 64, bf16, 26),
        lambda: phase_b8(1024, 256, 512, 16, 64, bf16, 27),
        lambda: phase_b8(2048, 768, 384, 1, 64, bf16, 57),
        lambda: phase_b9(2048, 768, 384, 16, 64, 28),
        lambda: phase_b9(2048, 768, 384, 1, 64, 58),
        lambda: phase_b10(1 << 20, 16, 16, True, 29),
        lambda: phase_b10(1 << 20, 16, 16, False, 30),
        lambda: phase_b10(1 << 20, 16, 1, True, 54),
        lambda: phase_b10(1 << 20, 16, 1, False, 55),
        lambda: phase_b11(16, 16, 49152, False, 31),
        lambda: phase_b11(16, 16, 102912, False, 32),
        lambda: phase_b11(16, 16, 49152, True, 33),
        lambda: phase_b11(1, 16, 49152, False, 65),  # a single retrieve's IVF_PQ probe
        lambda: phase_b12(128, 512, 384, 12, bf16, 35),
        lambda: phase_b12(8, 512, 384, 12, bf16, 36),
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
        lambda: phase_b12(8, 512, 384, 12, f32, 37),
    ]
    for case in cases:
        res = case()
        emit(res)
        results.append(res)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # launches: every pass of the main path (each counted from 0), summed
    building = list(getattr(kernels, "KERNEL_LAUNCHES", {}))
    launches = {k: None for k in [*kernels.LAUNCHES, *building]}
    if not kernels_only:
        depth = {"text_chunks": 2048, "images": 256, "text_rows": 1 << 20,
                 "image_rows": 131072}
        passes = {}
        passes["bf16"], bf16_runtime = main_path(depth, seed, profile="--profile" in argv)
        passes["serve http"] = serve_http_pass(seed + 11, bf16_runtime, smi)
        passes["serve asr"] = serve_asr_pass(seed + 13, bf16_runtime, smi)
        depth_q8 = dict(depth, text_rows=1 << 18, image_rows=1 << 16)
        passes["int8"], _ = main_path(depth_q8, seed, quant=True, bf16_runtime=bf16_runtime,
                                      profile="--profile" in argv)
        for i, kind in enumerate(INDEX_PASSES):
            passes[f"index {kind}"] = index_pass(kind, 1 << 20, seed + 1 + i)
        passes["ivf_pq"] = ivf_pq_pass(depth, seed + 7, bf16_runtime)
        passes.update(mesh_pass(seed + 30, bf16_runtime, smi))
        passes.update(train_pass(seed + 40, smi))
        passes["models"] = models_pass(seed + 50, smi)
        passes["approx"] = approx_pass(seed + 51, smi)
        passes["dcn"] = dcn_pass(seed + 52, smi)
        passes["graft"] = graft_pass(smi)
        passes["op_profile"] = op_profile_pass(smi)
        launches = {k: sum(p[k] for p in passes.values()) for k in launches}
        if launches["B12"]:  # no path of either package reaches B12
            raise AssertionError(f"a pass launched B12: {passes}")
        idle = [k for k in building if launches[k] <= 0]
        if idle:  # every building kernel lies on the main path
            raise AssertionError(f"no pass launched {idle}: {launches}")
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
        "B12": ("_attn_kernel2d", "mmrag_tpu/ops/attention.py:144", "attention.cu", "128x512 h384"),
        # the building kernels, each alone at a main-path shape (what they
        # replace: the step of the TPU kernels that composes them)
        "K-gemm": ("gemm_bf16_kernel", "mmrag_tpu/ops/attention.py:371", "gemm.cu",
                   "65536x384->1152 none"),
        "K-gemm-i8": ("gemm_i8_kernel", "mmrag_tpu/ops/attention.py:440", "gemm_i8.cu",
                      "65536x384->1152 none"),
        "K-ln": ("add_ln_kernel", "mmrag_tpu/ops/layernorm.py:43", "layernorm.cu",
                 "65536x384 post-LN, bfloat16 out", "float32"),
        "K-quant": ("row_quant_kernel", "mmrag_tpu/ops/mlp.py:114", "layernorm.cu", "65536x384"),
        "K-attn": ("attention_mma_kernel", "mmrag_tpu/ops/attention.py:268", "attention.cu",
                   "16x77x512 causal+pad"),
        "K-bmax": ("bucket_max_tc_kernel", "mmrag_tpu/ops/pallas_topk.py:58", "bucket_max.cu",
                   "1048576x384 q16 per-query mask"),
        # K-bmax's top-k form and its merge: X1 (approx_max_k), no pallas_call
        "K-bmax-top": ("bucket_max_tc_kernel<TOP>", "mmrag_tpu/ops/topk.py:65", "bucket_max.cu",
                       "1048576x384 q16 per-query mask"),
        "K-bmax-topk-merge": ("topk_merge_kernel", "mmrag_tpu/ops/topk.py:65", "bucket_max.cu",
                              "1048576x384 q16 per-query mask"),
    }
    table = []
    row_of = {"K-ln": "B2", "K-attn": "B5"}  # K-ln alone is B2, K-attn alone B5
    for key, (kname, replaces, src, shape, *dt) in headline.items():
        dtype = dt[0] if dt else "bfloat16"
        r = next(r for r in results if r["kernel"] == row_of.get(key, key)
                 and r["shape"] == shape and r["dtype"] == dtype)
        table.append({
            "name": f"{key} {kname}", "route": "cuda",
            "source": f"mmrag_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches.get(key), "max_abs_err": r["max_abs_err"],
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
