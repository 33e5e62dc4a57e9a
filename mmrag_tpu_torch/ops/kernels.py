"""The port's hand-written CUDA kernels: build, load, and the building calls
the B1-B12 wrappers compose.

Sources live in ``mmrag_tpu_torch/csrc/*.cu``. Each is compiled on first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library with a plain C interface under ``mmrag_tpu_torch/_build/`` (one
``nvcc`` per source, all started together), and loaded with ``ctypes``.
Nothing is compiled or imported from CUDA when this module is imported, so
the CPU tests import it freely.

Building kernels (each has a plain PyTorch version with the same rounding
points, taken only for tensors on the CPU):

* :func:`gemm` — ``C = epi(A @ W + bias) [+ R]`` (``gemm.cu``)
* :func:`gemm_i8` — ``C = epi((Aq @ Wq) * row_scale * col_scale + bias) [+ R]``
  on the int8 tensor cores, ``Wq`` stored N x K (``gemm_i8.cu``)
* :func:`layer_norm` — ``LN(x [+ delta])`` (``layernorm.cu``)
* :func:`row_quant` — per-row symmetric int8 of ``x`` or ``LN(x)`` and the
  f32 row scale (``layernorm.cu``)
* :func:`attention` / :func:`attention_separate` — MHA over the fused q|k|v
  buffer, or over three (b*s, h) operands sharing one row stride, with a
  (b, s) key bias, context in the stream dtype or f32 (``attention.cu``)
* :func:`attention_full_bias` — MHA over (b, s, h) q, k, v (or strided views)
  with a (b, s, s) or shared (s, s) additive bias (``attention.cu``)
* :func:`bucket_max` — bucketed ``max(q @ c.T)`` over the rows a bool mask
  keeps (``bucket_max.cu``); :func:`bucket_topk`, its top-k form (X1): each
  persistent block's best k of the union of its buckets'
  :data:`APPROX_TOP` best rows, and :func:`topk_merge`, the blocks' lists to
  the top-k (``bucket_max.cu``; :func:`approx_topk` composes the two)
* :func:`probe_scores` / :func:`probe_scores_q` — the IVF probe over a bf16,
  f32 or int8 bucket tensor, predicate evaluated in place; the pairs are
  grouped by cluster on the card first, so each probed block is read once
  (``ivf_probe.cu``)
* :func:`adc_bucket_max` / :func:`adc_rescore` — product-quantized (ADC)
  scores from shared-memory lookup tables: bucketed maxima, or one query's
  candidate set (``adc.cu``)

On a CUDA tensor each call launches its kernel or raises; there is no
fallback. :data:`LAUNCHES` counts, on the card, one launch of each kernel
that replaces a TPU ``pallas_call``: for B2 one K-ln launch, for B4 one K-bmax
launch (a wrapper call on more than 32 queries makes several), for B5 and
B12 one K-attn launch, and for the composed blocks one block per wrapper call (B1 is
3 building launches, plus one K-ln for its pre- or post-LN; B3 is 3; B6 is 5,
plus a K-ln for its post-LN; B7 is 4, plus a K-ln for its post-LN); for B8
and B9 one K-probe call (a grouping launch, then the probe), for B10 one
K-adc bucket-max launch (a search of more queries than
:func:`adc_max_queries` allows makes several) and for B11 one K-adc rescore
launch. :data:`KERNEL_LAUNCHES` counts the launches of the
building kernels those blocks compose (K-gemm, K-gemm-i8, K-ln, K-quant,
K-attn, K-bmax), and of K-bmax's top-k form and its merge (``K-bmax-top``,
``K-bmax-topk-merge``: the approximate search X1, which replaces no
``pallas_call``); :func:`reset_launches` zeroes both.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from .quant import q8_dense, quantize_rows
from .topk import predicate_mask, topk_first

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("gemm", "gemm_i8", "layernorm", "attention", "bucket_max", "ivf_probe", "adc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

NEG = -1e30  # dead-row score (mask bias) and filler score
LOGIT_CAP = 80.0  # exp-overflow guard of the one-pass softmax

# B1-B12 launches on the card, as above (a call on CPU tensors adds nothing)
LAUNCHES: Dict[str, int] = {f"B{i}": 0 for i in range(1, 13)}
# launches of the building kernels the B wrappers compose (B8-B11 are their
# kernels alone), counted where the C entry launches them
_KERNEL_OF = {"mm_gemm": "K-gemm", "mm_gemm_i8": "K-gemm-i8", "mm_add_ln": "K-ln",
              "mm_row_quant": "K-quant", "mm_attention": "K-attn", "mm_bucket_max": "K-bmax",
              "mm_bucket_topk": "K-bmax-top", "mm_topk_merge": "K-bmax-topk-merge"}
KERNEL_LAUNCHES: Dict[str, int] = {name: 0 for name in _KERNEL_OF.values()}
# the served path launches from several threads (the batchers' runners, the
# HTTP handlers, the job workers): a plain += can lose counts
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for counts in (LAUNCHES, KERNEL_LAUNCHES):
            for key in counts:
                counts[key] = 0


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


_DT = {torch.float32: 0, torch.bfloat16: 1}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C entry -> (source, argument types)
_FUNCS = {
    "mm_gemm": ("gemm", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "mm_gemm_i8": ("gemm_i8", [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P]),
    "mm_add_ln": ("layernorm", [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _F, _P]),
    "mm_row_quant": ("layernorm", [_P, _I, _P, _P, _F, _P, _P, _I, _I, _P]),
    "mm_attention": ("attention", [_P, _P, _P, _I, _P, _I, ctypes.c_longlong, _P, _I, _I, _I,
                                   _I, _I, _I, _P]),
    "mm_bucket_max": ("bucket_max", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "mm_bucket_topk": ("bucket_max", [_P] * 5 + [_I] * 8 + [_P]),
    "mm_topk_merge": ("bucket_max", [_P] * 6 + [_I] * 6 + [_P]),
    "mm_ivf_probe": ("ivf_probe", [_P] * 12 + [_LL] + [_I] * 6 + [_P]),
    "mm_ivf_probe_q": ("ivf_probe", [_P] * 13 + [_LL] + [_I] * 5 + [_P]),
    "mm_ivf_probe_scratch": ("ivf_probe", [_I] * 3),
    "mm_adc_bucket_max": ("adc", [_P] * 4 + [_I] * 4 + [_P]),
    "mm_adc_rescore": ("adc", [_P] * 4 + [_I] * 4 + [_P]),
}
_RESTYPE = {"mm_ivf_probe_scratch": _LL}  # every other C entry returns its CUDA error


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _lib_path(name: str) -> str:
    digest = hashlib.sha256()
    for fname in (f"{name}.cu", "common.cuh"):
        with open(os.path.join(CSRC, fname), "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all() -> Dict[str, float]:
    """Compile every source that has no up-to-date library, one ``nvcc`` per
    source, all in parallel. Returns the seconds each build took (0 for a
    library already built). Raises with the compiler's output on failure."""

    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    started = {}
    seconds: Dict[str, float] = {}
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        log = open(out + ".log", "w")
        started[name] = time.perf_counter()
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", out + ".tmp", os.path.join(CSRC, f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        ), log, out)
    failed = []
    for name, (proc, log, out) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - started[name]
        if rc != 0:
            failed.append((name, open(out + ".log").read()))
        else:
            os.replace(out + ".tmp", out)
    if failed:
        raise RuntimeError(
            "kernel build failed:\n" + "\n".join(f"--- {n}\n{msg}" for n, msg in failed)
        )
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) for one source, '' when it was not built here."""

    path = _lib_path(name) + ".log"
    return open(path).read() if os.path.exists(path) else ""


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            for fn_name, (src, argtypes) in _FUNCS.items():
                if src == name:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = _RESTYPE.get(fn_name, ctypes.c_int)
            lib.mm_error_string.argtypes = [ctypes.c_int]
            lib.mm_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def _call(fn_name: str, *args) -> None:
    lib = _lib(_FUNCS[fn_name][0])
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.mm_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} ({msg})")
    kernel = _KERNEL_OF.get(fn_name)
    if kernel is not None:
        with _count_lock:
            KERNEL_LAUNCHES[kernel] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, what: str, device, dtypes=None, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, expected {device}")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{what} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


# ---------------------------------------------------------------------------
# K-gemm
# ---------------------------------------------------------------------------


def gemm_plain(a, w, bias, residual=None, epi: str = "none", out_dtype=None):
    """Plain form of :func:`gemm`: f32 products of the stream-dtype operands
    (exact for bf16), bias, activation and residual in f32, one final cast."""

    out_dtype = out_dtype or a.dtype
    y = a.float() @ w.float() + bias
    if epi == "quick_gelu":
        y = y * torch.sigmoid(1.702 * y)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


_EPI = {"none": 0, "quick_gelu": 1}


def gemm(a, w, bias, residual=None, epi: str = "none", out_dtype=None):
    """``epi(a @ w + bias) [+ residual]`` -> ``out_dtype`` (default a.dtype).

    ``a`` (M, K) and ``w`` (K, N) share the stream dtype; ``bias`` (N,) f32;
    ``residual`` (M, N) in the stream dtype."""

    if not _on_cuda(a):
        return gemm_plain(a, w, bias, residual, epi, out_dtype)
    out_dtype = out_dtype or a.dtype
    m, k = a.shape
    n = w.shape[1]
    dev = a.device
    _check(a, "a", dev, _DT)
    _check(w, "w", dev, (a.dtype,), (k, n))
    _check(bias, "bias", dev, (torch.float32,), (n,))
    if residual is not None:
        _check(residual, "residual", dev, (a.dtype,), (m, n))
    if a.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(f"bf16 gemm needs K and N multiples of 8, got K={k} N={n}")
    if a.dtype == torch.bfloat16 and (a.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("bf16 gemm needs 16-byte-aligned a and w (TMA)")
    if a.dtype == torch.float32 and out_dtype != torch.float32:
        raise ValueError("f32 gemm writes f32")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    _call("mm_gemm", _ptr(a), _ptr(w), _ptr(bias), _ptr(residual), _ptr(out), m, n, k,
          _DT[a.dtype], _DT[out_dtype], _EPI[epi], _stream(a))
    return out


# ---------------------------------------------------------------------------
# K-gemm-i8
# ---------------------------------------------------------------------------


def activation_plain(y, epi: str):
    """The f32 activations of the int8 epilogue (``_act_f32`` of
    ``mmrag_tpu/ops/mlp.py``)."""

    if epi == "none":
        return y
    if epi == "quick_gelu":
        return y * torch.sigmoid(1.702 * y)
    if epi == "gelu_tanh":
        return torch.nn.functional.gelu(y, approximate="tanh")
    if epi == "gelu_erf":
        return torch.nn.functional.gelu(y)
    raise ValueError(f"unknown activation {epi!r}")


def gemm_i8_plain(aq, a_scale, wq, w_scale, bias, residual=None, epi: str = "none",
                  out_dtype=torch.float32):
    """Plain form of :func:`gemm_i8`: ``ops/quant.py::q8_dense`` (the exact
    int8 sum, then ``((acc * a_scale) * w_scale) + bias`` in f32), the
    activation and the residual in f32, one final cast."""

    y = q8_dense(aq, a_scale[:, None], {"q": wq, "scale": w_scale, "bias": bias})
    y = activation_plain(y, epi)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


_EPI_I8 = {"none": 0, "quick_gelu": 1, "gelu_tanh": 2, "gelu_erf": 3}


def gemm_i8(aq, a_scale, wq, w_scale, bias, residual=None, epi: str = "none",
            out_dtype=torch.float32):
    """``epi(((aq @ wq) * a_scale) * w_scale + bias) [+ residual]`` on the
    int8 tensor cores (``wgmma`` s8) -> ``out_dtype`` (bf16 or f32).

    ``aq`` (M, K) int8 with ``a_scale`` (M,) f32; ``wq`` the (K, N) int8
    weight stored N x K (strides (1, K), the layout of
    ``ops/quant.py::quantize_weight``; any other raises, nothing is copied)
    with ``w_scale`` and ``bias`` (N,) f32; ``residual`` (M, N) bf16 or f32.
    K and N must be multiples of 16, ``aq`` and ``wq`` 16-byte aligned."""

    if not _on_cuda(aq):
        return gemm_i8_plain(aq, a_scale, wq, w_scale, bias, residual, epi, out_dtype)
    m, k = aq.shape
    n = wq.shape[1]
    dev = aq.device
    _check(aq, "aq", dev, (torch.int8,))
    _check(a_scale, "a_scale", dev, (torch.float32,), (m,))
    _check(w_scale, "w_scale", dev, (torch.float32,), (n,))
    _check(bias, "bias", dev, (torch.float32,), (n,))
    if residual is not None:
        _check(residual, "residual", dev, _DT, (m, n))
    if k % 16 or n % 16:
        raise ValueError(f"int8 gemm needs K and N multiples of 16, got K={k} N={n}")
    if wq.device != dev or wq.dtype != torch.int8 or tuple(wq.shape) != (k, n):
        raise ValueError(f"wq: {wq.dtype} {tuple(wq.shape)} on {wq.device}, "
                         f"expected int8 ({k}, {n}) on {dev}")
    if wq.stride() != (1, k):
        raise ValueError(f"wq must be stored N x K (strides (1, {k}), quantize_weight's "
                         f"layout), got strides {wq.stride()}")
    if aq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8 gemm needs 16-byte-aligned aq and wq (TMA)")
    if w_scale.data_ptr() % 8 or bias.data_ptr() % 8:
        raise ValueError("int8 gemm needs 8-byte-aligned w_scale and bias")
    if out_dtype not in _DT:
        raise ValueError(f"int8 gemm writes bf16 or f32, not {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    r_dt = _DT[residual.dtype] if residual is not None else 0
    _call("mm_gemm_i8", _ptr(aq), _ptr(a_scale), _ptr(wq), _ptr(w_scale), _ptr(bias),
          _ptr(residual), r_dt, _ptr(out), _DT[out_dtype], m, n, k, _EPI_I8[epi], _stream(aq))
    return out


# ---------------------------------------------------------------------------
# K-ln
# ---------------------------------------------------------------------------


def layer_norm_plain(x, delta, scale, bias, eps: float, out_dtype):
    """Plain form of :func:`layer_norm`: f32 statistics, eps inside rsqrt."""

    y = x.float()
    if delta is not None:
        y = y + delta.float()
    mean = y.mean(-1, keepdim=True)
    var = (y - mean).square().mean(-1, keepdim=True)
    return ((y - mean) * torch.rsqrt(var + eps) * scale + bias).to(out_dtype)


def layer_norm(x, delta, scale, bias, eps: float, out_dtype):
    """``LN(x [+ delta])`` per row of a (rows, h) tensor, h <= 1024."""

    if not _on_cuda(x):
        return layer_norm_plain(x, delta, scale, bias, eps, out_dtype)
    rows, h = x.shape
    dev = x.device
    _check(x, "x", dev, _DT)
    if delta is not None:
        _check(delta, "delta", dev, _DT, (rows, h))
    _check(scale, "scale", dev, (torch.float32,), (h,))
    _check(bias, "bias", dev, (torch.float32,), (h,))
    if h > 1024:
        raise ValueError(f"layer_norm supports h <= 1024, got {h}")
    out = torch.empty((rows, h), dtype=out_dtype, device=dev)
    d_dt = _DT[delta.dtype] if delta is not None else _DT[x.dtype]
    _call("mm_add_ln", _ptr(x), _DT[x.dtype], _ptr(delta), d_dt, _ptr(scale), _ptr(bias),
          _ptr(out), _DT[out_dtype], rows, h, float(eps), _stream(x))
    return out


# ---------------------------------------------------------------------------
# K-quant
# ---------------------------------------------------------------------------


def row_quant_plain(x, ln_scale=None, ln_bias=None, eps: float = 0.0):
    """Plain form of :func:`row_quant`: ``ops/quant.py::quantize_rows`` of
    ``x`` in f32, or of its f32 LayerNorm."""

    y = x.float()
    if ln_scale is not None:
        y = layer_norm_plain(y, None, ln_scale, ln_bias, eps, torch.float32)
    q, scale = quantize_rows(y)
    return q, scale[:, 0]


def row_quant(x, ln_scale=None, ln_bias=None, eps: float = 0.0):
    """Per-row symmetric int8 of a (rows, h) tensor, after an f32 LayerNorm
    when ``ln_scale``/``ln_bias`` are given: returns the (rows, h) int8 codes
    and the (rows,) f32 scales. h <= 3072."""

    if not _on_cuda(x):
        return row_quant_plain(x, ln_scale, ln_bias, eps)
    rows, h = x.shape
    dev = x.device
    _check(x, "x", dev, _DT)
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("row_quant takes both LayerNorm vectors or neither")
    if ln_scale is not None:
        _check(ln_scale, "ln_scale", dev, (torch.float32,), (h,))
        _check(ln_bias, "ln_bias", dev, (torch.float32,), (h,))
    if h > 3072:
        raise ValueError(f"row_quant supports h <= 3072, got {h}")
    q = torch.empty((rows, h), dtype=torch.int8, device=dev)
    scale = torch.empty((rows,), dtype=torch.float32, device=dev)
    _call("mm_row_quant", _ptr(x), _DT[x.dtype], _ptr(ln_scale), _ptr(ln_bias), float(eps),
          _ptr(q), _ptr(scale), rows, h, _stream(x))
    return q, scale


# ---------------------------------------------------------------------------
# K-attn
# ---------------------------------------------------------------------------


def _mha_plain(q, k, v, bias, num_heads: int, out_dtype):
    """The JAX ``_softmax_ctx`` numerics over (b, s, h) q, k, v and a bias
    broadcast to (b, heads, s, s): ``p = exp(min(q.k * hd^-0.5 + bias, 80))``
    cast to the stream dtype, ``ctx = (p @ v) / max(sum(p), 1e-30)`` in f32,
    then cast to ``out_dtype``."""

    b, s, h = q.shape
    hd = h // num_heads

    def heads(t):
        return t.float().reshape(b, s, num_heads, hd).transpose(1, 2)  # (b, nh, s, hd)

    scores = heads(q) @ heads(k).transpose(-1, -2) * (float(hd) ** -0.5) + bias
    p = torch.exp(torch.clamp(scores, max=LOGIT_CAP)).to(q.dtype).float()
    num = p @ heads(v)
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    ctx = num * (1.0 / den)
    return ctx.transpose(1, 2).reshape(b, s, h).to(out_dtype)


def attention_separate_plain(q, k, v, kbias, num_heads: int, seq: int, out_dtype=None):
    """Plain form of :func:`attention_separate`."""

    rows, h = q.shape
    b = rows // seq
    ctx = _mha_plain(q.reshape(b, seq, h), k.reshape(b, seq, h), v.reshape(b, seq, h),
                     kbias[:, None, None, :], num_heads, out_dtype or q.dtype)
    return ctx.reshape(rows, h)


def _thirds(qkv):
    if qkv.shape[1] % 3:
        raise ValueError(f"attention: the fused q|k|v buffer has {qkv.shape[1]} columns")
    h = qkv.shape[1] // 3
    return qkv[:, :h], qkv[:, h:2 * h], qkv[:, 2 * h:]


def attention_plain(qkv, kbias, num_heads: int, seq: int, out_dtype=None):
    """Plain form of :func:`attention`."""

    return attention_separate_plain(*_thirds(qkv), kbias, num_heads, seq, out_dtype)


def attention(qkv, kbias, num_heads: int, seq: int, out_dtype=None):
    """Multi-head attention over the fused ``(b*seq, 3h)`` q|k|v buffer with a
    ``(b, seq)`` f32 additive key bias; returns the ``(b*seq, h)`` context in
    ``out_dtype`` (default the stream dtype; f32 for B6). The buffer's thirds
    go to :func:`attention_separate` in place."""

    return attention_separate(*_thirds(qkv), kbias, num_heads, seq, out_dtype)


def _row_stride(q, k, v) -> int:
    """The row stride that ``q``, ``k`` and ``v`` share, after the checks of
    what the kernel needs: one dtype, shape and stride, a unit column stride
    and whole rows, and (for the tensor-core kernel's 16-byte ``cp.async``
    copies and ``ldmatrix`` rows) 16-byte-aligned bases and a row stride that
    is a multiple of 8 elements."""

    dev = q.device
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != dev or t.dtype != q.dtype or t.dtype not in _DT:
            raise ValueError(f"{what}: {t.dtype} on {t.device}, expected {q.dtype} on {dev}")
        if t.shape != q.shape:
            raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(q.shape)}")
        if t.stride() != q.stride():
            raise ValueError(f"{what} has strides {t.stride()}, q has {q.stride()}")
    h, rs = q.shape[-1], q.stride(-2)
    if q.stride(-1) != 1 or rs < h or (q.dim() == 3 and q.stride(0) != q.shape[1] * rs):
        raise ValueError(f"q, k, v need unit column stride and whole rows, got {q.stride()}")
    if rs % 8:
        raise ValueError(f"q, k, v row stride {rs} is not a multiple of 8 elements")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} is not 16-byte aligned")
    return rs


def _check_heads(h: int, num_heads: int) -> None:
    if h % num_heads or h // num_heads not in (32, 64):
        raise ValueError(f"attention: h {h}, heads {num_heads} (head dim 32 or 64)")


def attention_separate(q, k, v, kbias, num_heads: int, seq: int, out_dtype=None):
    """Multi-head attention over three ``(b*seq, h)`` operands that share one
    row stride (the thirds of a fused projection, or separate tensors) with a
    ``(b, seq)`` f32 additive key bias; returns the contiguous ``(b*seq, h)``
    context in ``out_dtype`` (default the stream dtype, or f32). One K-attn
    launch in its key-row mode."""

    if not _on_cuda(q):
        return attention_separate_plain(q, k, v, kbias, num_heads, seq, out_dtype)
    out_dtype = out_dtype or q.dtype
    rows, h = q.shape
    dev = q.device
    if rows % seq:
        raise ValueError(f"attention: rows {rows} not divisible by seq {seq}")
    _check_heads(h, num_heads)
    rs = _row_stride(q, k, v)
    b = rows // seq
    _check(kbias, "kbias", dev, (torch.float32,), (b, seq))
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"attention writes {q.dtype} or float32, not {out_dtype}")
    out = torch.empty((rows, h), dtype=out_dtype, device=dev)
    _call("mm_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), rs, _ptr(kbias), 0, 0,
          _ptr(out), _DT[out_dtype], b, seq, h, num_heads, _DT[q.dtype], _stream(q))
    return out


def attention_full_bias_plain(q, k, v, bias, num_heads: int):
    """Plain form of :func:`attention_full_bias`."""

    full = bias[:, None] if bias.dim() == 3 else bias
    return _mha_plain(q, k, v, full, num_heads, q.dtype)


def attention_full_bias(q, k, v, bias, num_heads: int):
    """Multi-head attention over (b, s, h) ``q``, ``k``, ``v`` with a full f32
    additive ``bias``, (b, s, s) or (s, s) shared by the batch; returns the
    contiguous (b, s, h) context in the stream dtype.

    ``q``, ``k`` and ``v`` may be strided views (the thirds of a fused
    (b, s, 3h) projection): their last dim must be contiguous and the three
    must share one row stride."""

    if not _on_cuda(q):
        return attention_full_bias_plain(q, k, v, bias, num_heads)
    b, s, h = q.shape
    dev = q.device
    _check_heads(h, num_heads)
    rs = _row_stride(q, k, v)
    if tuple(bias.shape) == (s, s):
        bstride = 0
    elif tuple(bias.shape) == (b, s, s):
        bstride = s * s
    else:
        raise ValueError(f"bias shape {tuple(bias.shape)}, expected ({s}, {s}) or ({b}, {s}, {s})")
    _check(bias, "bias", dev, (torch.float32,))
    out = torch.empty((b, s, h), dtype=q.dtype, device=dev)
    _call("mm_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), rs, _ptr(bias), 1, bstride,
          _ptr(out), _DT[q.dtype], b, s, h, num_heads, _DT[q.dtype], _stream(q))
    return out


# ---------------------------------------------------------------------------
# K-bmax
# ---------------------------------------------------------------------------

BUCKET = 128


def _mask_rows(mask):
    return mask[None, :] if mask.ndim == 1 else mask


def bucket_max_plain(queries, corpus, mask):
    """Plain form of :func:`bucket_max`: dense f32 scores, -1e30 where the
    mask is 0 and on rows past the corpus end, max over each 128-row bucket."""

    n = corpus.shape[0]
    scores = queries.float() @ corpus.float().T
    scores = torch.where(_mask_rows(mask).bool(), scores, NEG)
    nb = -(-n // BUCKET)
    pad = nb * BUCKET - n
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG)
    return scores.reshape(scores.shape[0], nb, BUCKET).amax(-1)


def _check_bucket_args(queries, corpus, mask):
    """What both K-bmax forms take; returns the mask as (1, n) or (qp, n)."""

    qp, d = queries.shape
    n = corpus.shape[0]
    dev = corpus.device
    if qp > 32:
        raise ValueError(f"bucket_max takes at most 32 queries, got {qp}")
    _check(corpus, "corpus", dev, _DT, (n, d))
    _check(queries, "queries", dev, (corpus.dtype,))
    mask = _mask_rows(mask)
    _check(mask, "mask", dev, (torch.bool, torch.uint8))
    if mask.shape not in ((1, n), (qp, n)):
        raise ValueError(f"mask shape {tuple(mask.shape)}, expected ({n},), (1, {n}) or ({qp}, {n})")
    if corpus.dtype == torch.bfloat16 and (d % 8 or d > 1024):
        raise ValueError(f"bf16 bucket_max needs d a multiple of 8, at most 1024, got {d}")
    if corpus.dtype == torch.bfloat16 and (corpus.data_ptr() % 16 or queries.data_ptr() % 16):
        raise ValueError("bf16 bucket_max needs 16-byte-aligned queries and corpus (cp.async)")
    return mask


def bucket_max(queries, corpus, mask):
    """``(qp, ceil(n/128))`` bucket maxima of ``queries @ corpus.T`` over the
    rows ``mask`` keeps (-1e30 where it is 0); ``mask`` is bool or uint8,
    ``(n,)`` or ``(1, n)`` shared, or ``(qp, n)`` per query. qp <= 32; a bf16
    corpus needs d a multiple of 8, at most 1024."""

    if not _on_cuda(corpus):
        return bucket_max_plain(queries, corpus, mask)
    mask = _check_bucket_args(queries, corpus, mask)
    qp, d = queries.shape
    n = corpus.shape[0]
    out = torch.empty((qp, -(-n // BUCKET)), dtype=torch.float32, device=corpus.device)
    _call("mm_bucket_max", _ptr(queries), _ptr(corpus), _ptr(mask), _ptr(out), qp, n, d,
          mask.shape[0], _DT[corpus.dtype], _stream(corpus))
    return out


# The rows each bucket gives X1's union (csrc/bucket_max.cu kTop). A query
# loses only the true top-k rows past the t-th of one bucket, so its recall
# is at least min(1, t / k) whatever the layout; 48 is the least t that
# holds 0.95 at the engine's k 50 even where one document's contiguous
# chunks fill a bucket. Measured (tools/approx_recall.py, 65,536 rows x 384,
# on the CPU): mean recall@50 with 16 rows a bucket 0.905 on documents of
# 8-24 chunks and 0.4625 on documents of 32-96, with 48 rows 1.0 and 0.9838
APPROX_TOP = 48
# The list entries a (block, query) keeps in K-bmax-top (csrc/bucket_max.cu
# kCap). k up to TOPK_CAP runs on the persistent grid; above it a block
# takes at most TOPK_CAP // APPROX_TOP buckets, so its union fits its list.
TOPK_CAP = 64
SENTINEL_ROW = 2**31 - 1  # a list's empty place: score -inf, this row
MERGE_SMEM = 204800  # bytes of level buffers K-bmax-topk-merge keeps in shared memory


def bucket_max_argmax_plain(queries, corpus, mask):
    """The union X1 selects from: dense f32 scores, -1e30 where the mask is
    0 and on rows past the corpus end, ``reshape(q, nb, 128)``, then the
    :data:`APPROX_TOP` largest of each bucket, on equal scores the lowest row
    first. Returns ``(values, rows)``, both ``(qp, nb, APPROX_TOP)`` (f32,
    int32 global row ids)."""

    n = corpus.shape[0]
    scores = queries.float() @ corpus.float().T
    scores = torch.where(_mask_rows(mask).bool(), scores, NEG)
    nb = -(-n // BUCKET)
    pad = nb * BUCKET - n
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG)
    top = topk_first(scores.reshape(scores.shape[0], nb, BUCKET), APPROX_TOP)
    base = torch.arange(nb, device=scores.device, dtype=torch.int32)[:, None] * BUCKET
    return top.values, top.indices.to(torch.int32) + base


def approx_topk_plain(queries, corpus, mask, k: int):
    """Plain form of :func:`approx_topk`: the top-k of the
    :func:`bucket_max_argmax_plain` union by (score descending, row
    ascending), one stable sort of its ``nb * APPROX_TOP`` candidates a
    query. ``(values (qp, k) f32, rows (qp, k) int32)``."""

    vals, ids = bucket_max_argmax_plain(queries, corpus, mask)
    top = topk_first(vals.reshape(vals.shape[0], -1), k)  # equal scores: bucket, then row order
    return top.values, torch.gather(ids.reshape(ids.shape[0], -1), 1, top.indices)


def topk_grid(nb: int, k: int, sms: int, dtype) -> int:
    """K-bmax-top's blocks: one a streaming multiprocessor for bf16 (two for
    the f32 form) up to ``nb``; above :data:`TOPK_CAP` as many as keep a
    block's union within its list."""

    if k > TOPK_CAP:
        return -(-nb // (TOPK_CAP // APPROX_TOP))
    return min(nb, sms if dtype == torch.bfloat16 else 2 * sms)


def _topk_lens(nb: int, k: int, grid: int):
    """(list entries, entries written) a (block, query) of K-bmax-top: the
    list holds ``min(k, TOPK_CAP)``; a block writes no more than its
    buckets can give."""

    ell = min(k, TOPK_CAP)
    return ell, min(ell, APPROX_TOP * -(-nb // grid))


def bucket_topk_plain(queries, corpus, mask, k: int, grid: int):
    """Plain form of :func:`bucket_topk` at ``grid`` blocks, the kernel's
    algorithm step by step: block ``g`` walks buckets ``g, g + grid, ...`` in
    ascending order and keeps, a query, a list of its best ``min(k,
    TOPK_CAP)`` candidates by (score descending, row ascending), sentinels
    (-inf, :data:`SENTINEL_ROW`) where it has fewer; of a bucket's
    :data:`APPROX_TOP` best only the scores above the list's last (tau) may
    enter (a row of equal score is the higher row and loses), placed by the
    kernel's rule: a candidate after the candidates before it and the listed
    rows of its score or more, a listed row after the candidates of a higher
    score. Returns ``(values, rows)`` ``(qp, grid', out_len)``, ``grid' =
    min(grid, nb)``. The tests' and the card's yardstick for the kernel;
    every grid gives the same top-k after :func:`topk_merge_plain`."""

    n = corpus.shape[0]
    nb = -(-n // BUCKET)
    grid = min(grid, nb)
    steps = -(-nb // grid)
    if k > TOPK_CAP and steps * APPROX_TOP > TOPK_CAP:
        raise ValueError(f"a block's {steps} buckets overflow its list of {TOPK_CAP} at k {k}")
    ell, out_len = _topk_lens(nb, k, grid)
    scores = queries.float() @ corpus.float().T
    scores = torch.where(_mask_rows(mask).bool(), scores, NEG)
    qp, dev = scores.shape[0], scores.device
    scores = torch.nn.functional.pad(scores, (0, steps * grid * BUCKET - n), value=NEG)
    scores = scores.reshape(qp, steps, grid, BUCKET)
    lv = torch.full((qp, grid, ell), float("-inf"), device=dev)
    lr = torch.full((qp, grid, ell), SENTINEL_ROW, dtype=torch.int32, device=dev)
    places = torch.arange(ell, device=dev)
    order = torch.arange(APPROX_TOP, device=dev)
    for t in range(steps):
        bucket = t * grid + torch.arange(grid, device=dev)
        top = topk_first(scores[:, t], APPROX_TOP)  # each bucket's best, by the key
        cv, cr = top.values, (top.indices + bucket[:, None] * BUCKET).to(torch.int32)
        passing = (cv > lv[..., -1:]) & (bucket < nb)[None, :, None]  # a prefix of cv
        cand_at = order + (lv[..., None, :] >= cv[..., :, None]).sum(-1)
        list_at = places + ((cv[..., None, :] > lv[..., :, None]) & passing[..., None, :]).sum(-1)
        cand_at = torch.where(passing, cand_at, ell).clamp(max=ell)  # place ell: dropped
        list_at = list_at.clamp(max=ell)
        nv = lv.new_full((qp, grid, ell + 1), float("-inf"))
        nr = lr.new_full((qp, grid, ell + 1), SENTINEL_ROW)
        nv.scatter_(-1, list_at, lv).scatter_(-1, cand_at, cv)
        nr.scatter_(-1, list_at, lr).scatter_(-1, cand_at, cr)
        lv, lr = nv[..., :ell], nr[..., :ell]
    return lv[..., :out_len].contiguous(), lr[..., :out_len].contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bucket_topk(queries, corpus, mask, k: int):
    """K-bmax's top-k form (K-bmax-top): persistent blocks walk the buckets
    (:func:`topk_grid`), each keeping a query's best ``min(k, TOPK_CAP)``
    of its buckets' :data:`APPROX_TOP`-row union by (score descending, row
    ascending); rows the mask drops and rows past n score -1e30. Returns
    each block's list, ``(values (qp, grid, out_len) f32, rows (qp, grid,
    out_len) int32)``, sentinels (-inf, :data:`SENTINEL_ROW`) past a block's
    candidates (on a CPU corpus, the plain form at one bucket a block). The
    arguments are :func:`bucket_max`'s, and ``k >= 1``."""

    n = corpus.shape[0]
    nb = -(-n // BUCKET)
    if k < 1 or n == 0:
        raise ValueError(f"bucket_topk needs k >= 1 and rows: k {k}, n {n}")
    if not _on_cuda(corpus):  # one bucket a block: each list is its bucket's best
        return bucket_topk_plain(queries, corpus, mask, k, nb)
    mask = _check_bucket_args(queries, corpus, mask)
    qp, d = queries.shape
    grid = topk_grid(nb, k, _sm_count(corpus.device.index or 0), corpus.dtype)
    ell, out_len = _topk_lens(nb, k, grid)
    vals = torch.empty((qp, grid, out_len), dtype=torch.float32, device=corpus.device)
    rows = torch.empty((qp, grid, out_len), dtype=torch.int32, device=corpus.device)
    _call("mm_bucket_topk", _ptr(queries), _ptr(corpus), _ptr(mask), _ptr(vals), _ptr(rows), qp,
          n, d, mask.shape[0], grid, ell, out_len, _DT[corpus.dtype], _stream(corpus))
    return vals, rows


def topk_merge_plain(vals, rows, k: int):
    """Plain form of :func:`topk_merge`: the top-k of every list's entries by
    (score descending, row ascending), a stable sort by row, then by score."""

    qp = vals.shape[0]
    by_row = torch.sort(rows.reshape(qp, -1), dim=-1, stable=True)
    top = topk_first(torch.gather(vals.reshape(qp, -1), 1, by_row.indices), k)
    return top.values, torch.gather(by_row.values, 1, top.indices)


def _merge_buffers(lists: int, m: int, k: int):
    """Entries of K-bmax-topk-merge's two level buffers (a query): A holds
    the input, then the even levels; B the odd ones; the last level writes
    the answer. Mirrors ``topk_merge_kernel``'s loop."""

    size_a, size_b, in_a = lists * m, 0, True
    while lists > 1:
        m, lists = min(k, 2 * m), (lists + 1) // 2
        if lists > 1:
            if in_a:
                size_b = max(size_b, lists * m)
            else:
                size_a = max(size_a, lists * m)
        in_a = not in_a
    return size_a, size_b


def topk_merge(vals, rows, k: int):
    """K-bmax-topk-merge: the ``(qp, L, m)`` sorted lists of
    :func:`bucket_topk` to their top-k by (score descending, row ascending),
    ``(values (qp, k) f32, rows (qp, k) int32)``: one block a query takes
    them through pairwise merge levels, in shared memory where they fit
    (:data:`MERGE_SMEM`), else in a global scratch. Needs ``L >= 2`` and
    ``L * m >= k``."""

    if not _on_cuda(vals):
        return topk_merge_plain(vals, rows, k)
    qp, lists, m = vals.shape
    dev = vals.device
    _check(vals, "vals", dev, (torch.float32,))
    _check(rows, "rows", dev, (torch.int32,), (qp, lists, m))
    if lists < 2 or k < 1 or lists * m < k:
        raise ValueError(f"topk_merge needs 2 or more lists of k >= 1 entries in all: "
                         f"{lists} lists of {m}, k {k}")
    size_a, size_b = _merge_buffers(lists, m, k)
    out_v = torch.empty((qp, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((qp, k), dtype=torch.int32, device=dev)
    gv = gr = None
    if 8 * (size_a + size_b) > MERGE_SMEM:
        gv = torch.empty((qp, size_a + size_b), dtype=torch.float32, device=dev)
        gr = torch.empty((qp, size_a + size_b), dtype=torch.int32, device=dev)
    _call("mm_topk_merge", _ptr(vals), _ptr(rows), _ptr(out_v), _ptr(out_r), _ptr(gv), _ptr(gr),
          qp, lists, m, k, size_a, size_b, _stream(vals))
    return out_v, out_r


def approx_topk(queries, corpus, mask, k: int):
    """X1's top-k, :func:`approx_topk_plain`'s answer: on the card
    :func:`bucket_topk`, then :func:`topk_merge` of the blocks' lists (one
    block: its list is the answer); the plain version on the CPU. The
    arguments are :func:`bucket_max`'s, ``0 <= k <= ceil(n / 128) *
    APPROX_TOP``."""

    if not _on_cuda(corpus):
        return approx_topk_plain(queries, corpus, mask, k)
    if k == 0:  # nothing to select: no launch
        empty = torch.empty((queries.shape[0], 0), device=corpus.device)
        return empty, empty.to(torch.int32)
    vals, rows = bucket_topk(queries, corpus, mask, k)
    if vals.shape[1] == 1:
        return vals[:, 0, :k], rows[:, 0, :k]
    return topk_merge(vals, rows, k)


# ---------------------------------------------------------------------------
# K-probe (B8, B9)
# ---------------------------------------------------------------------------


def _probe_valid(users_b, docs_b, live_b, probes, uids, dids):
    """The tenant / document / liveness predicate of every probed slot,
    (q, nprobe, B) bool."""

    return predicate_mask(users_b[probes][:, :, 0, :], docs_b[probes][:, :, 0, :],
                          live_b[probes][:, :, 0, :], uids[:, None, None], dids[:, None, None])


def probe_scores_plain(queries, buckets, bucket_ids, users_b, docs_b, live_b, probes,
                       uids, dids):
    """Plain form of :func:`probe_scores`: gathers the probed blocks, f32
    products of the bucket-dtype operands."""

    pl = probes.long()
    sub = buckets[pl]  # (q, nprobe, B, d)
    s = torch.einsum("qd,qpbd->qpb", queries.to(buckets.dtype).float(), sub.float())
    valid = _probe_valid(users_b, docs_b, live_b, pl, uids, dids)
    return torch.where(valid, s, NEG), bucket_ids[pl][:, :, 0, :]


def _check_probe(buckets, planes, probes, uids, dids, nq):
    dev = buckets.device
    c, b, _ = buckets.shape
    for t, what in planes:
        _check(t, what, dev, (torch.int32,), (c, 1, b))
    _check(probes, "probes", dev, (torch.int32,))
    if probes.ndim != 2 or probes.shape[0] != nq:
        raise ValueError(f"probes shape {tuple(probes.shape)}, expected ({nq}, nprobe)")
    _check(uids, "uids", dev, (torch.int32,), (nq,))
    _check(dids, "dids", dev, (torch.int32,), (nq,))


@functools.lru_cache(maxsize=256)
def _probe_scratch_bytes(c: int, nq: int, nprobe: int) -> int:
    return max(int(_lib("ivf_probe").mm_ivf_probe_scratch(c, nq, nprobe)), 16)


def _probe_scratch(c: int, nq: int, nprobe: int, dev) -> torch.Tensor:
    """The device buffer in which K-probe groups the (query, probe) pairs by
    cluster before it reads the probed blocks (sized by the source itself)."""

    return torch.empty((_probe_scratch_bytes(c, nq, nprobe),), dtype=torch.uint8, device=dev)


def probe_scores(queries, buckets, bucket_ids, users_b, docs_b, live_b, probes, uids, dids):
    """Masked IVF probe: for each query and each of its ``nprobe`` probed
    clusters, ``queries[q] . buckets[probes[q, i]]`` over the B slots where
    the slot is live, of tenant ``uids[q]`` and (``dids[q] < 0`` or) of
    document ``dids[q]``, else -1e30; the slots' row ids beside. Returns
    (q, nprobe, B) f32 scores and int32 ids.

    ``queries`` (q, d) in the buckets' dtype (bf16 or f32); ``buckets``
    (C, B, d); the planes (C, 1, B) int32; ``probes`` (q, nprobe) int32 in
    [0, C); ``uids``, ``dids`` (q,) int32."""

    if not _on_cuda(buckets):
        return probe_scores_plain(queries, buckets, bucket_ids, users_b, docs_b, live_b,
                                  probes, uids, dids)
    c, b, d = buckets.shape
    nq = queries.shape[0]
    dev = buckets.device
    _check(buckets, "buckets", dev, _DT)
    _check(queries, "queries", dev, (buckets.dtype,), (nq, d))
    _check_probe(buckets, ((bucket_ids, "bucket_ids"), (users_b, "users_b"),
                           (docs_b, "docs_b"), (live_b, "live_b")), probes, uids, dids, nq)
    nprobe = probes.shape[1]
    scores = torch.empty((nq, nprobe, b), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, nprobe, b), dtype=torch.int32, device=dev)
    scratch = _probe_scratch(c, nq, nprobe, dev)
    _call("mm_ivf_probe", _ptr(queries), _ptr(buckets), _ptr(bucket_ids), _ptr(users_b),
          _ptr(docs_b), _ptr(live_b), _ptr(probes), _ptr(uids), _ptr(dids), _ptr(scores),
          _ptr(ids), _ptr(scratch), scratch.numel(), nq, nprobe, c, b, d, _DT[buckets.dtype],
          _stream(buckets))
    return scores, ids


def probe_scores_q_plain(queries_q, buckets, scales_b, bucket_ids, users_b, docs_b, live_b,
                         probes, uids, dids):
    """Plain form of :func:`probe_scores_q`: the integer dot in f32 (exact),
    times the slot's scale."""

    pl = probes.long()
    raw = torch.einsum("qd,qpbd->qpb", queries_q.float(), buckets[pl].float())
    s = raw * scales_b[pl][:, :, 0, :]
    valid = _probe_valid(users_b, docs_b, live_b, pl, uids, dids)
    return torch.where(valid, s, float("-inf")), bucket_ids[pl][:, :, 0, :]


def probe_scores_q(queries_q, buckets, scales_b, bucket_ids, users_b, docs_b, live_b, probes,
                   uids, dids):
    """:func:`probe_scores` over int8 buckets: the exact integer dot of the
    quantized query values (int8) with each probed slot, times the slot's
    f32 scale; masked slots get -inf (the caller then multiplies by the
    positive query scale). ``scales_b`` (C, 1, B) f32."""

    if not _on_cuda(buckets):
        return probe_scores_q_plain(queries_q, buckets, scales_b, bucket_ids, users_b, docs_b,
                                    live_b, probes, uids, dids)
    c, b, d = buckets.shape
    nq = queries_q.shape[0]
    dev = buckets.device
    _check(buckets, "buckets", dev, (torch.int8,))
    _check(queries_q, "queries_q", dev, (torch.int8,), (nq, d))
    _check(scales_b, "scales_b", dev, (torch.float32,), (c, 1, b))
    _check_probe(buckets, ((bucket_ids, "bucket_ids"), (users_b, "users_b"),
                           (docs_b, "docs_b"), (live_b, "live_b")), probes, uids, dids, nq)
    nprobe = probes.shape[1]
    scores = torch.empty((nq, nprobe, b), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, nprobe, b), dtype=torch.int32, device=dev)
    scratch = _probe_scratch(c, nq, nprobe, dev)
    _call("mm_ivf_probe_q", _ptr(queries_q), _ptr(buckets), _ptr(scales_b), _ptr(bucket_ids),
          _ptr(users_b), _ptr(docs_b), _ptr(live_b), _ptr(probes), _ptr(uids), _ptr(dids),
          _ptr(scores), _ptr(ids), _ptr(scratch), scratch.numel(), nq, nprobe, c, b, d,
          _stream(buckets))
    return scores, ids


# ---------------------------------------------------------------------------
# K-adc (B10, B11)
# ---------------------------------------------------------------------------

ADC_K = 256  # table entries per subvector (8-bit codes)
ADC_SMEM = 196608  # shared-memory bytes the bucket-max kernel's tables may take


def adc_max_queries(m: int) -> int:
    """Queries one bucket-max launch takes: its (m, K, queries) bf16 tables
    must fit the shared-memory budget (16 at m 16: 128 KB)."""

    for qc in (16, 8, 4, 2, 1):
        if m * ADC_K * qc * 2 <= ADC_SMEM:
            return qc
    raise ValueError(f"ADC tables of m={m} do not fit in shared memory")


def _adc_scores_plain(tables, codes_t, q_of_codes):
    """Sum over j, in order, of ``tables[j][q, code_j + 128]`` in f32:
    ``codes_t`` (m, S) shared or (q, m, S) per query."""

    m, q, _ = tables.shape
    t = tables.float()
    rows = torch.arange(q, device=tables.device)[:, None]
    acc = 0.0  # the kernels' f32 accumulator starts at 0, as JAX's does
    for j in range(m):
        idx = (codes_t[..., j, :] if q_of_codes else codes_t[j]).long() + 128
        acc = acc + (t[j][rows, idx] if q_of_codes else t[j][:, idx])
    return acc


def adc_bucket_max_plain(tables, codes, bias):
    """Plain form of :func:`adc_bucket_max`."""

    n = codes.shape[0]
    scores = _adc_scores_plain(tables, codes.T, False) + bias
    nb = -(-n // BUCKET)
    pad = nb * BUCKET - n
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG)
    return scores.reshape(scores.shape[0], nb, BUCKET).amax(-1)


def adc_bucket_max(tables, codes, bias):
    """``(q, ceil(n/128))`` bucket maxima of the ADC scores
    ``sum_j tables[j][q, codes[r, j] + 128] + bias[., r]`` (j in order, f32
    sums of the bf16 entries); rows past ``n`` score -1e30.

    ``tables`` (m, q, K=256) bf16 with q <= :func:`adc_max_queries`; ``codes``
    (n, m) int8 (bias -128); ``bias`` (1, n) shared or (q, n) per query, f32."""

    if not _on_cuda(codes):
        return adc_bucket_max_plain(tables, codes, bias)
    m, q, kk = tables.shape
    n = codes.shape[0]
    dev = codes.device
    _check(tables, "tables", dev, (torch.bfloat16,))
    _check(codes, "codes", dev, (torch.int8,), (n, m))
    _check(bias, "bias", dev, (torch.float32,))
    if kk != ADC_K or q > adc_max_queries(m):
        raise ValueError(f"tables {tuple(tables.shape)}: K must be {ADC_K}, "
                         f"q at most {adc_max_queries(m)}")
    if bias.shape not in ((1, n), (q, n)):
        raise ValueError(f"bias shape {tuple(bias.shape)}, expected (1, {n}) or ({q}, {n})")
    out = torch.empty((q, -(-n // BUCKET)), dtype=torch.float32, device=dev)
    _call("mm_adc_bucket_max", _ptr(tables), _ptr(codes), _ptr(bias), _ptr(out), m, q, n,
          bias.shape[0], _stream(codes))
    return out


def adc_rescore_plain(tables, cand_codes, bias):
    """Plain form of :func:`adc_rescore`."""

    shared = cand_codes.shape[0] == 1
    codes_t = cand_codes[0] if shared else cand_codes
    return _adc_scores_plain(tables, codes_t, not shared) + bias


def adc_rescore(tables, cand_codes, bias):
    """ADC scores of each query's candidates, bias added: (q, S) f32.

    ``tables`` (m, q, K=256) bf16; ``cand_codes`` (q, m, S) int8, or (1, m, S)
    when every query scores the same candidates; ``bias`` (q, S) f32."""

    if not _on_cuda(cand_codes):
        return adc_rescore_plain(tables, cand_codes, bias)
    m, q, kk = tables.shape
    lead, m2, s = cand_codes.shape
    dev = cand_codes.device
    _check(tables, "tables", dev, (torch.bfloat16,))
    _check(cand_codes, "cand_codes", dev, (torch.int8,))
    _check(bias, "bias", dev, (torch.float32,), (q, s))
    if kk != ADC_K or m2 != m or lead not in (1, q):
        raise ValueError(f"tables {tuple(tables.shape)} vs codes {tuple(cand_codes.shape)}")
    out = torch.empty((q, s), dtype=torch.float32, device=dev)
    if s:
        _call("mm_adc_rescore", _ptr(tables), _ptr(cand_codes), _ptr(bias), _ptr(out), m, q, s,
              int(lead == 1), _stream(cand_codes))
    return out


# The building calls, dispatching on the tensor's device (the wrappers'
# path), and their plain versions on any device (the yardstick on the card).
DISPATCH = SimpleNamespace(
    gemm=gemm, gemm_i8=gemm_i8, layer_norm=layer_norm, row_quant=row_quant,
    attention=attention, attention_full_bias=attention_full_bias, bucket_max=bucket_max,
)
PLAIN = SimpleNamespace(
    gemm=gemm_plain, gemm_i8=gemm_i8_plain, layer_norm=layer_norm_plain,
    row_quant=row_quant_plain, attention=attention_plain,
    attention_full_bias=attention_full_bias_plain, bucket_max=bucket_max_plain,
)
