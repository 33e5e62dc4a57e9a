"""Batched perceptual hash (pHash) + Hamming dedup on the card.

Port of ``mmrag_tpu/ops/phash.py`` (ROADMAP Queue B X3, an XLA device op
there, no ``pallas_call``). Replaces the reference's per-frame
``imagehash.phash`` + O(n^2) Python dedup loop (``app/ingest/frames.py:87-95``)
with a batched pipeline: grayscale -> 32x32 antialiased Lanczos-3 resize (two
f32 products against per-axis weight matrices) -> 2-D DCT-II (two f32
products against the DCT basis) -> top-left 8x8 low-frequency block ->
median threshold -> 64-bit hash. The Hamming matrix is one f32 product; the
greedy keep-first dedup reads it back once and walks it on the host.

The same function as the JAX package's, step for step:

* ``jax.image.resize(..., "lanczos3", antialias=True)`` has no torch
  counterpart (``F.interpolate`` has no Lanczos filter), so
  :func:`resize_weights` builds JAX's own weight matrices
  (``jax/_src/image/scale.py::compute_weight_mat``) in f32 and caches them
  per (in, out); an axis whose size does not change is left alone, as JAX
  skips it;
* ``jnp.median`` of the 64 low-band values (an even count) is the midpoint
  of the 32nd and 33rd sorted values, where ``torch.median`` would return
  the lower one;
* every product is f32 (TF32 is off on the card, ``device.py``).

Bits follow the inputs' device: a CUDA tensor runs on the card, a CPU
tensor on the CPU.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

HASH_SIZE = 8
DCT_SIZE = 32  # hash_size * highfreq_factor
LANCZOS_RADIUS = 3.0

# ITU-R 601-2 luma transform — same as PIL Image.convert("L").
_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis: (D @ x) along axis 0 computes scipy
    ``dct(x, axis=0, norm=None)`` up to per-row scale; scale does not affect
    the median-threshold bits, so the orthonormal form is used."""

    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * math.sqrt(2.0 / n)
    d[0] *= 1.0 / math.sqrt(2.0)
    return d.astype(np.float32)


_DCT = _dct_matrix(DCT_SIZE)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """JAX's ``_fill_lanczos_kernel(3, x)`` in f32, zero past the radius."""

    f32 = np.float32
    radius = f32(LANCZOS_RADIUS)
    with np.errstate(divide="ignore", invalid="ignore"):
        y = radius * np.sin(f32(np.pi) * x) * np.sin(f32(np.pi) * x / radius)
        out = np.where(x > f32(1e-3), y / np.where(x != 0, f32(np.pi ** 2) * x * x, f32(1)),
                       f32(1))
    return np.where(x > radius, f32(0), out).astype(f32)


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to f32 (the f32 product is exact in f64):
    the fused multiply-add XLA emits for these expressions on the CPU."""

    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def weight_matrix(in_size: int, out_size: int, kernel) -> np.ndarray:
    """(in, out) f32 weights of JAX's antialiased resize along one axis
    (``jax/_src/image/scale.py::compute_weight_mat``, scale ``out / in``, no
    translation) for ``kernel`` (a numpy function of the distance ``x``), in
    JAX's f32 arithmetic as compiled (a fused multiply-add for the sample
    points): the kernel is widened by ``in / out`` when downsampling, sample
    points sit at ``(i + 0.5) * in / out - 0.5``,
    weights are normalized per output pixel and zeroed where the sample lies
    outside ``[-0.5, in - 0.5]``."""

    f32 = np.float32
    scale = f32(out_size / in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = fma32(np.arange(out_size, dtype=f32) + f32(0.5), inv_scale, f32(-0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = kernel(x.astype(f32)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) f32 weights of JAX's antialiased Lanczos-3 resize."""

    return weight_matrix(in_size, out_size, _lanczos3)


@functools.lru_cache(maxsize=64)
def _weights_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device)


@functools.lru_cache(maxsize=8)
def _consts_on(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.from_numpy(_LUMA).to(device), torch.from_numpy(_DCT).to(device)


@torch.inference_mode()
def phash_batch(images: torch.Tensor) -> torch.Tensor:
    """Compute 64-bit pHashes for a batch of images.

    Args:
      images: (b, h, w, 3) uint8 or float RGB tensor.
    Returns:
      (b, 64) float32 bit matrix (0.0 / 1.0) on the images' device — kept
      as floats so Hamming distances are products.
    """

    dev = images.device
    luma, dct = _consts_on(dev)
    gray = images.to(torch.float32) @ luma  # (b, h, w)
    h, w = gray.shape[1], gray.shape[2]
    small = gray
    if h != DCT_SIZE:  # an unchanged axis is the identity, as JAX skips it
        small = _weights_on(h, DCT_SIZE, dev).t() @ small
    if w != DCT_SIZE:
        small = small @ _weights_on(w, DCT_SIZE, dev)
    # 2-D DCT-II: rows then columns
    freq = dct @ small @ dct.t()
    low = freq[:, :HASH_SIZE, :HASH_SIZE].reshape(images.shape[0], HASH_SIZE * HASH_SIZE)
    return median_bits(low)


def median_bits(low: torch.Tensor) -> torch.Tensor:
    """(b, m) -> (b, m) f32 bits ``low > median(low)`` with ``jnp.median``'s
    median: for an even m the midpoint ``(a + b) * 0.5`` of the two middle
    sorted values in f32 (``torch.median`` returns the lower one, which sets
    another bit where the rounded midpoint equals the upper value)."""

    m = low.shape[1]
    srt = torch.sort(low, dim=1).values
    if m % 2:
        med = srt[:, m // 2 : m // 2 + 1]
    else:
        med = (srt[:, m // 2 - 1 : m // 2] + srt[:, m // 2 : m // 2 + 1]) * 0.5
    return (low > med).to(torch.float32)


@torch.inference_mode()
def hamming_matrix(bits: torch.Tensor) -> torch.Tensor:
    """(n, 64) bit matrix -> (n, n) pairwise Hamming distances via products
    (exact: sums of at most 64 ones in f32)."""

    ones = 1.0 - bits
    d = bits @ ones.t()
    return d + d.t()


def greedy_dedup_mask(distances: torch.Tensor, delta: float) -> torch.Tensor:
    """Keep-first greedy dedup (reference ``frames.py:87-95`` semantics).

    Frame i is kept iff its Hamming distance to every *kept* earlier frame
    exceeds ``delta``. Returns a (n,) bool mask on the distances' device.
    The walk is sequential, so the (n, n) matrix is read back once and
    walked on the host (the JAX package runs the same walk as a device
    ``fori_loop``); no per-frame synchronization."""

    dist = distances.cpu().numpy() <= float(delta)
    n = dist.shape[0]
    keep = np.zeros(n, dtype=bool)
    keep[:1] = True
    for i in range(1, n):
        keep[i] = not (keep[:i] & dist[i, :i]).any()
    return torch.from_numpy(keep).to(distances.device)


# frames per phash call: bounds the (chunk, h, w) f32 grayscale transients
# to ~0.5 GB at 1080p instead of growing with video length
_PHASH_CHUNK = 32


def dedup_frames(images, delta: int, max_keep: int,
                 device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline: phash -> Hamming -> greedy mask -> cap at max_keep.

    ``images`` is (n, h, w, 3) uint8 (numpy or a tensor); hashing runs on
    ``device`` (the card unless ``"cpu"`` is asked for) in chunks of
    ``_PHASH_CHUNK`` frames, so device transients stay bounded at any video
    length; the (n, 64) bit matrix is tiny, so the Hamming pass is one
    product. Returns (kept_indices (m,), bits (n, 64)) as NumPy. The cap
    mirrors the reference's ``max_frames`` truncation (``frames.py:108-109``).
    """

    dev = resolve_device(device)
    n = images.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 64), dtype=np.float32)
    bits_l = []
    for lo in range(0, n, _PHASH_CHUNK):
        chunk = images[lo : lo + _PHASH_CHUNK]
        if not isinstance(chunk, torch.Tensor):
            chunk = torch.from_numpy(np.ascontiguousarray(chunk))
        bits_l.append(phash_batch(chunk.to(dev)))
    bits = torch.cat(bits_l)
    mask = greedy_dedup_mask(hamming_matrix(bits), float(delta))
    kept = np.flatnonzero(mask.cpu().numpy())[:max_keep]
    return kept, bits.cpu().numpy()
