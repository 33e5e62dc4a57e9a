"""The plain products outside the kernels give f32 results, as JAX's do.

JAX computes every dense layer, the pooler, the classifier, the CLIP
projections and the patch embedding as ``jnp.dot(..., preferred_element_type
=jnp.float32)`` on stream-dtype operands, with the bias added in f32
(``mmrag_tpu/models/bert.py::_dense``, ``clip.py::_dense``, the patch
embedding of ``clip_image_features``). The port's ``_dense`` and
``matmul_f32`` must not round the product to bf16 first: with bf16 weights a
rerank logit near +-6 would move in steps of 1/32. Same bf16 operands on both
sides; f32 results within 1e-5 relative (products of bf16 values are exact in
f32, only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.models import bert as jbert
from mmrag_tpu.models import clip as jclip
from mmrag_tpu_torch.models import bert, clip

RTOL = 1e-5


def _operands(seed: int, rows: int, k: int, n: int, logit: float):
    """bf16-exact operands whose products land near +-``logit``."""

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * (logit / np.sqrt(k))
    b = rng.standard_normal(n).astype(np.float32) * 0.3
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    return x, w, b


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("jax_dense", [jbert._dense, jclip._dense], ids=["bert", "clip"])
@pytest.mark.parametrize("rows,k,n", [(8, 384, 1), (16, 384, 24), (5, 64, 3)])
def test_dense_bf16_gives_f32_like_jax(jax_dense, rows, k, n):
    x, w, b = _operands(rows + k + n, rows, k, n, 6.0)
    want = jax_dense({"kernel": jnp.asarray(w, jnp.bfloat16), "bias": jnp.asarray(b)},
                     jnp.asarray(x), jnp.bfloat16)
    got = bert._dense({"kernel": torch.from_numpy(w).bfloat16(), "bias": torch.from_numpy(b)},
                      torch.from_numpy(x), torch.bfloat16)
    wants = np.asarray(want)
    assert np.abs(wants).max() > 4.0  # logits where bf16 steps are 1/32
    # the result carries more than a bf16 value: not a multiple of 1/32 there
    big = np.abs(wants) > 4.0
    assert np.any(np.abs(got.numpy()[big] * 32 - np.round(got.numpy()[big] * 32)) > 1e-3)
    _close(got, wants)


def test_dense_without_bias_and_leading_dims():
    x, w, _ = _operands(3, 2 * 7, 64, 16, 6.0)
    x3 = x.reshape(2, 7, 64)
    want = jclip._dense({"kernel": jnp.asarray(w, jnp.bfloat16)}, jnp.asarray(x3), jnp.bfloat16)
    got = bert._dense({"kernel": torch.from_numpy(w).bfloat16()}, torch.from_numpy(x3),
                      torch.bfloat16)
    assert got.shape == (2, 7, 16)
    _close(got, np.asarray(want))


def test_patch_embedding_product_gives_f32_like_jax():
    """The CLIP patch embedding: (b, patches, 3*32*32) against the bf16
    patch kernel, f32 result (``clip.py`` ``clip_image_features``)."""

    rng = np.random.default_rng(11)
    pixels = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    patches = np.asarray(jclip.patchify(jnp.asarray(pixels), 32))
    assert np.array_equal(clip.patchify(torch.from_numpy(pixels), 32).numpy(), patches)
    _, w, _ = _operands(12, 1, patches.shape[-1], 48, 6.0)
    want = jnp.dot(jnp.asarray(patches, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    got = bert.matmul_f32(torch.from_numpy(patches).bfloat16(), torch.from_numpy(w).bfloat16())
    _close(got, np.asarray(want))


def test_cross_encoder_logit_not_rounded_to_bf16():
    """The classifier head of the cross-encoder (pooler, tanh, 1-logit
    classifier) on bf16 weights: the logit keeps its f32 value, as JAX's."""

    rng = np.random.default_rng(5)
    h = 64
    hidden = rng.standard_normal((6, 3, h)).astype(np.float32)
    pooler_w, pooler_b = (rng.standard_normal((h, h)) * 0.2).astype(np.float32), np.zeros(h, np.float32)
    cls_w = (rng.standard_normal((h, 1)) * 1.5).astype(np.float32)
    cls_b = np.array([0.37], np.float32)

    def jx(v):
        return jnp.asarray(v, jnp.bfloat16)

    jp = {"pooler": {"kernel": jx(pooler_w), "bias": jnp.asarray(pooler_b)},
          "classifier": {"kernel": jx(cls_w), "bias": jnp.asarray(cls_b)}}
    pooled = jnp.tanh(jbert._dense(jp["pooler"], jnp.asarray(hidden[:, 0]), jnp.bfloat16))
    want = np.asarray(jbert._dense(jp["classifier"], pooled, jnp.bfloat16)[:, 0])

    def tx(v):
        return torch.from_numpy(np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))).bfloat16()

    tp = {"pooler": {"kernel": tx(pooler_w), "bias": torch.from_numpy(pooler_b)},
          "classifier": {"kernel": tx(cls_w), "bias": torch.from_numpy(cls_b)}}
    t_pooled = torch.tanh(bert._dense(tp["pooler"], torch.from_numpy(hidden[:, 0]), torch.bfloat16))
    got = bert._dense(tp["classifier"], t_pooled, torch.bfloat16)[:, 0]
    assert np.abs(want).max() > 2.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
