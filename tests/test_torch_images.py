"""X2: the port's device preprocess (``ops/images.py::preprocess_batch``)
against the JAX package's for canvases other than 224: JAX's antialiased
Keys-cubic resize (``jax.image.resize(..., "cubic", antialias=True)``) as
two f32 products with JAX's weights, then the CLIP normalisation. Pixels
within 1e-5."""

import jax
import numpy as np
import pytest
import torch

from mmrag_tpu.ops.images import preprocess_batch as jpreprocess
from mmrag_tpu_torch.ops import images


@pytest.mark.parametrize("canvas", [180, 256, 320, 224, 64])
def test_preprocess_batch_matches_jax(canvas, rng):
    batch = rng.integers(0, 256, (3, canvas, canvas, 3), dtype=np.uint8)
    want = np.asarray(jpreprocess(batch))
    got = images.preprocess_batch(torch.from_numpy(batch))
    assert got.shape == (3, 224, 224, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [180, 256, 320, 64])
def test_cubic_weights_are_jaxs(size):
    """The per-axis weights against JAX's own ``compute_weight_mat`` as
    ``jax.image.resize`` compiles it (the fused multiply-adds of the sample
    points and the cubic, emulated in f64)."""

    from jax._src.image import scale

    want = np.asarray(jax.jit(lambda: scale.compute_weight_mat(
        size, 224, 224 / size, 0.0, scale._fill_keys_cubic_kernel, True))())
    got = images.cubic_weights(size, 224)
    assert got.dtype == np.float32 and got.shape == (size, 224)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=0), 1.0, atol=1e-5)


def test_an_unchanged_axis_is_left_alone(rng):
    """As JAX skips an axis whose size does not change, so does the port: a
    224 x 100 crop is resized along its width only."""

    x = torch.from_numpy(rng.integers(0, 256, (2, 224, 100, 3)).astype(np.float32))
    assert images.resize_cubic(x, 224, 100) is x
    got = images.resize_cubic(x, 224, 224) / 255.0
    want = np.asarray(jax.image.resize(x.numpy(), (2, 224, 224, 3), "cubic",
                                       antialias=True)) / 255.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
