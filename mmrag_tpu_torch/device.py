"""Device and working-dtype policy of the port.

Entry points (``EncoderRuntime``, ``RagEngine``, ``VectorIndex``) run on
``cuda`` unless the caller passes ``device="cpu"``; there is no silent CPU
fallback when CUDA is missing. Float32 products on the card are full f32:
TF32 is switched off for matmuls and for cuDNN.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; raises when CUDA is asked for and missing."""

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on the device's current stream, as the
    readback that follows would (nothing to wait for on the CPU). The
    ``*.wait`` spans wrap it, so a readback's wait is timed apart from the
    copy."""

    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def working_dtype(compute_dtype: str, device: torch.device) -> torch.dtype:
    """bf16 on CUDA when ``TPU_COMPUTE_DTYPE=bfloat16``, else f32 (the CPU
    always runs f32, as ``mmrag_tpu/models/runtime.py:157-162`` does)."""

    if compute_dtype == "bfloat16" and device.type == "cuda":
        return torch.bfloat16
    return torch.float32


def storage_dtype(name: Optional[str]) -> torch.dtype:
    """Index slab dtype by its setting name. ``pq`` keeps m-byte codes on the
    device and reports bf16, as the JAX package's pq index does."""

    if name in ("bfloat16", "pq"):
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    if name == "int8":
        return torch.int8
    raise NotImplementedError(
        f"index dtype {name!r} is not ported (bfloat16/float32/int8/pq)")


TOPK_BACKENDS = ("auto", "ivf", "approx")


def topk_backend(name: str) -> str:
    """Validate ``TPU_TOPK_BACKEND``: ``auto`` (the dense bucket-max kernel,
    or the pq scan), ``ivf`` (the partitioned layout) or ``approx`` (X1:
    K-bmax's top-k form and its merge, a recall contract in place of
    exactness; dense bf16 and f32 slabs only; faster than ``auto`` on the
    card at 1M rows, ``PERF.md``). ``xla`` and ``pallas`` raise, because on
    the card they would only move a search off its kernel."""

    if name in TOPK_BACKENDS:
        return name
    raise ValueError(
        f"TPU_TOPK_BACKEND={name!r} is not a backend of the port: auto, ivf or approx "
        "(every search on the card goes through its kernel)"
    )
