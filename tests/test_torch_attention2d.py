"""B12, the multi-head attention over 2-D (b*s, h) q, k, v with a key row,
against the JAX package's ``fused_encoder_attention2d``.

The JAX wrapper runs its Pallas kernel ``_attn_kernel2d`` in interpret mode on
the CPU by itself; the port's wrapper runs on CPU tensors, the plain version
of its K-attn launch. f32, heads of 32. Real rows (query positions the mask
keeps) are compared at atol 2e-5, the tolerance of B1 and B5: the same
one-pass softmax, f32 sums taken in another order. A batch-padding row (every
key masked) is exactly 0 in the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.ops.attention import fused_encoder_attention2d as jax_attention2d
from mmrag_tpu_torch.ops import kernels
from mmrag_tpu_torch.ops.attention import (
    fused_encoder_attention2d, fused_encoder_attention2d_plain,
)

ATOL = 2e-5


def _qkv(rng, rows, h):
    return [rng.standard_normal((rows, h)).astype(np.float32) for _ in range(3)]


def _mask(b, s, lengths):
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)


def _both(q, k, v, nh, s, mask=None):
    want = np.asarray(jax_attention2d(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nh, s,
                                      None if mask is None else jnp.asarray(mask)))
    got = fused_encoder_attention2d(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), nh, s,
                                    None if mask is None else torch.from_numpy(mask))
    return got.numpy(), want


@pytest.mark.parametrize(
    "b,s,h,nh,form",
    [
        (3, 64, 64, 2, "mask"),
        (3, 64, 64, 2, "no mask"),
        (4, 48, 64, 2, "batch padding"),  # row 3: every key masked
        (17, 32, 64, 2, "mask"),  # b not a multiple of 16, the JAX tile at s <= 128
        (2, 77, 64, 2, "mask"),  # s 77: ragged against every tile
        (2, 50, 128, 4, "mask"),  # h 128 with 4 heads
    ],
)
def test_attention2d_matches_jax(b, s, h, nh, form):
    rng = np.random.default_rng(b * s + h)
    q, k, v = _qkv(rng, b * s, h)
    mask = None
    if form != "no mask":
        lengths = rng.integers(1, s + 1, b)
        lengths[0] = s
        if form == "batch padding":
            lengths[-1] = 0
        mask = _mask(b, s, lengths)
    got, want = _both(q, k, v, nh, s, mask)
    assert got.shape == (b * s, h) and got.dtype == np.float32
    real = np.ones(b * s, bool) if mask is None else mask.reshape(-1).astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=ATOL)
    if form == "batch padding":
        assert np.all(got[(b - 1) * s:] == 0.0)


def test_plain_twin_and_no_launch_on_the_cpu():
    """The wrapper on CPU tensors is its plain twin and counts no launch."""

    rng = np.random.default_rng(7)
    b, s, h, nh = 2, 40, 64, 2
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, b * s, h))
    mask = torch.from_numpy(_mask(b, s, [40, 13]))
    kernels.reset_launches()
    got = fused_encoder_attention2d(q, k, v, nh, s, mask)
    want = fused_encoder_attention2d_plain(q, k, v, nh, s, mask)
    assert kernels.LAUNCHES["B12"] == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("rows,h,nh,seq,match", [
    (100, 64, 2, 32, "not divisible by seq"),
    (64, 64, 3, 32, "not divisible by heads"),
])
def test_attention2d_rejects_bad_shapes(rows, h, nh, seq, match):
    """The JAX wrapper's ValueErrors, in both packages."""

    q = np.zeros((rows, h), np.float32)
    with pytest.raises(ValueError, match=match):
        jax_attention2d(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), nh, seq)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError, match=match):
        fused_encoder_attention2d(t, t, t, nh, seq)
    with pytest.raises(ValueError, match=match):
        fused_encoder_attention2d_plain(t, t, t, nh, seq)
