"""Image preprocessing for the CLIP vision tower.

Port of ``mmrag_tpu/ops/images.py``. The host does decode + centered-square
crop (a slice, no resampling) + resize to one static canvas; CLIP's
shortest-side-resize-then-center-crop is geometrically identical to cropping
the largest centered square and resizing it. Batches transfer as uint8.

On the device, :func:`preprocess_batch` (X2) resizes a canvas other than 224
as ``jax.image.resize(..., "cubic", antialias=True)`` does, then scales to
[0, 1] and normalizes with the CLIP mean/std. torch has no antialiased
Keys-cubic resize of JAX's weights, so :func:`cubic_weights` builds JAX's
own per-axis weight matrices (Keys' cubic, ``a = -0.5``) in f32, cached per
(in, out) size, and the resize is two f32 products (TF32 is off on the card,
``device.py``), as X3 builds its Lanczos-3 weights (``ops/phash.py``).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from .phash import fma32, weight_matrix

CLIP_IMAGE_SIZE = 224
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def center_square_crop(image: np.ndarray) -> np.ndarray:
    """Host-side largest centered square crop of an (h, w, 3) uint8 array."""

    h, w = image.shape[:2]
    side = min(h, w)
    top = (h - side) // 2
    left = (w - side) // 2
    return image[top : top + side, left : left + side]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """JAX's ``_fill_keys_cubic_kernel`` (Keys 1981, ``a = -0.5``) in f32,
    with the fused multiply-adds XLA compiles it to."""

    f32 = np.float32
    out = fma32(fma32(f32(1.5), x, f32(-2.5)) * x, x, f32(1.0))
    far = fma32(fma32(fma32(f32(-0.5), x, f32(2.5)), x, f32(-4.0)), x, f32(2.0))
    out = np.where(x >= f32(1.0), far, out)
    return np.where(x >= f32(2.0), f32(0.0), out)


def cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) f32 weights of JAX's antialiased cubic resize along one axis."""

    return weight_matrix(in_size, out_size, _keys_cubic)


@functools.lru_cache(maxsize=16)
def _cubic_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cubic_weights(in_size, out_size)).to(device)


def resize_cubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(b, h, w, c) f32 -> (b, height, width, c): the antialiased cubic
    resize as two f32 products with JAX's weights; an axis whose size does
    not change is left alone, as JAX skips it."""

    if x.shape[1] != height:
        x = torch.einsum("bhwc,hH->bHwc", x, _cubic_on(x.shape[1], height, x.device))
    if x.shape[2] != width:
        x = torch.einsum("bhwc,wW->bhWc", x, _cubic_on(x.shape[2], width, x.device))
    return x


def preprocess_batch(images: torch.Tensor) -> torch.Tensor:
    """(b, s, s, 3) uint8 square crops -> (b, 224, 224, 3) f32 normalized."""

    x = images.to(torch.float32)
    x = resize_cubic(x, CLIP_IMAGE_SIZE, CLIP_IMAGE_SIZE)
    x = x / 255.0
    mean = torch.as_tensor(CLIP_MEAN, device=images.device)
    std = torch.as_tensor(CLIP_STD, device=images.device)
    return (x - mean) / std


def stack_square_crops(images: Sequence[np.ndarray], canvas: int = 256) -> np.ndarray:
    """Host: crop each image to its centered square and resize it to one
    static canvas, so a batch has a single shape. Returns (b, canvas, canvas,
    3) uint8."""

    out = np.empty((len(images), canvas, canvas, 3), dtype=np.uint8)
    for i, img in enumerate(images):
        sq = center_square_crop(np.asarray(img))
        out[i] = _host_resize(sq, canvas)
    return out


def _host_resize(square: np.ndarray, size: int) -> np.ndarray:
    """cv2 area/cubic resize where cv2 is installed, else nearest-neighbour
    numpy indexing (the same fallback as the JAX package)."""

    side = square.shape[0]
    if side == size:
        return square
    try:
        import cv2

        interp = cv2.INTER_AREA if side > size else cv2.INTER_CUBIC
        return cv2.resize(square, (size, size), interpolation=interp)
    except ImportError:
        idx = (np.arange(size) * (side / size)).astype(np.int64).clip(0, side - 1)
        return square[idx][:, idx]
