"""The port's pHash + Hamming dedup (``mmrag_tpu_torch/ops/phash.py``, ROADMAP
Queue B X3) against the JAX package's ``mmrag_tpu/ops/phash.py`` on the CPU.

Tolerances: the resize weights within 1e-5 of the ones
``jax.image.resize(..., "lanczos3", antialias=True)`` applies (read back by
resizing an identity); bits, Hamming distances and kept indices exactly
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.ops import phash as jp
from mmrag_tpu_torch.ops import phash as tp

WEIGHT_TOL = 1e-5


def _structured(rng, n, h=64, w=64):
    # random low-res blocks upsampled: pHash bits are stable under pixel
    # noise only when the spectrum has real structure
    blocks = rng.integers(0, 255, (n, 8, 8, 3)).astype(np.float32)
    return np.stack([np.kron(b, np.ones((h // 8, w // 8, 1), np.float32)) for b in blocks]
                    ).astype(np.uint8)


@pytest.mark.parametrize("size_in,size_out", [(720, 32), (1280, 32), (45, 32), (80, 32),
                                              (33, 32), (33, 33), (20, 32)],
                         ids=["720", "1280", "45", "80", "33down", "33same", "20up"])
def test_resize_weights_match_jax_lanczos3(size_in, size_out):
    want = np.asarray(jax.image.resize(jnp.eye(size_in, dtype=jnp.float32),
                                       (size_in, size_out), "lanczos3", antialias=True))
    got = tp.resize_weights(size_in, size_out)
    assert got.shape == (size_in, size_out) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=WEIGHT_TOL)


@pytest.mark.parametrize("shape", [(6, 72, 128), (4, 45, 80), (3, 33, 33), (3, 20, 20),
                                   (2, 32, 40)])
def test_phash_bits_equal_jax(rng, shape):
    b, h, w = shape
    imgs = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    want = np.asarray(jp.phash_batch(jnp.asarray(imgs)))
    got = tp.phash_batch(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == (b, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_phash_bits_equal_jax_on_structured_frames(rng):
    imgs = _structured(rng, 5, 720, 1280)
    want = np.asarray(jp.phash_batch(jnp.asarray(imgs)))
    np.testing.assert_array_equal(tp.phash_batch(torch.from_numpy(imgs)).numpy(), want)


def test_median_is_the_midpoint_of_the_even_count(rng):
    """The 64 low-band values have no single middle: ``jnp.median`` is the
    midpoint of the 32nd and 33rd sorted values, rounded in f32. Where those
    two are 1 + 2^-23 and 1 + 2^-22, the midpoint rounds to the upper one, so
    the upper value's bit is clear; ``torch.median`` (the lower value) would
    set it."""

    lo, hi = np.float32(1 + 2 ** -23), np.float32(1 + 2 ** -22)
    low = np.concatenate([rng.uniform(-5, 0.5, 31), [lo, hi], rng.uniform(2, 5, 31)])
    low = np.stack([rng.permutation(low), rng.normal(size=64)]).astype(np.float32)
    want = np.asarray(low > np.asarray(jnp.median(jnp.asarray(low), axis=1, keepdims=True)),
                      np.float32)
    got = tp.median_bits(torch.from_numpy(low)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].sum() == 31  # the rounded midpoint is the upper middle value
    lower = torch.median(torch.from_numpy(low), dim=1, keepdim=True).values
    assert (torch.from_numpy(low) > lower)[0].sum() == 32  # the lower median differs
    odd = torch.arange(7, dtype=torch.float32)[None]
    assert tp.median_bits(odd).sum() == 3


def test_identical_images_zero_distance(rng):
    img = _structured(rng, 1)[0]
    bits = tp.phash_batch(torch.from_numpy(np.stack([img, img])))
    assert bits.shape == (2, 64)
    assert tp.hamming_matrix(bits)[0, 1] == 0


def test_noise_robust_but_discriminative(rng):
    img = _structured(rng, 1)[0]
    noisy = np.clip(img.astype(np.int32) + rng.integers(-6, 6, img.shape), 0, 255).astype(np.uint8)
    different = np.transpose(img, (1, 0, 2))
    d = tp.hamming_matrix(tp.phash_batch(torch.from_numpy(np.stack([img, noisy, different]))))
    assert d[0, 1] <= 6 and d[0, 2] > 10


def test_hamming_matrix_exact(rng):
    bits = (rng.random((40, 64)) > 0.5).astype(np.float32)
    want = np.asarray(jp.hamming_matrix(jnp.asarray(bits)))
    got = tp.hamming_matrix(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (bits[:, None, :] != bits[None, :, :]).sum(-1))


@pytest.mark.parametrize("delta", [-1.0, 0.0, 6.0, 12.0])
def test_greedy_mask_matches_jax(rng, delta):
    n = 30
    dist = rng.integers(0, 20, (n, n)).astype(np.float32)
    dist = (dist + dist.T) / 2
    np.fill_diagonal(dist, 0)
    want = np.asarray(jp.greedy_dedup_mask(jnp.asarray(dist), jnp.float32(delta)))
    got = tp.greedy_dedup_mask(torch.from_numpy(dist), delta)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_dedup_frames_matches_jax(rng):
    """70 frames (three chunks of 32) of near-duplicate runs: the same kept
    indices and bits as the JAX package's pipeline."""

    bases = _structured(rng, 7, 48, 64)
    frames = []
    for i in range(70):
        base = bases[(i // 5) % 7].astype(np.int32)
        frames.append(np.clip(base + rng.integers(-4, 5, base.shape), 0, 255).astype(np.uint8))
    frames = np.stack(frames)
    for delta, cap in ((6, 100), (6, 3), (-1, 50)):
        want_kept, want_bits = jp.dedup_frames(frames, delta=delta, max_keep=cap)
        got_kept, got_bits = tp.dedup_frames(frames, delta=delta, max_keep=cap, device="cpu")
        np.testing.assert_array_equal(got_bits, want_bits)
        np.testing.assert_array_equal(got_kept, want_kept)
    assert 5 <= len(tp.dedup_frames(frames, 6, 100, device="cpu")[0]) < 70


def test_dedup_frames_pipeline(rng):
    img_a = _structured(rng, 1)[0]
    img_b = np.transpose(img_a, (1, 0, 2)).copy()
    frames = np.stack([img_a, img_a, img_b, img_a, img_b])
    kept, bits = tp.dedup_frames(frames, delta=6, max_keep=10, device="cpu")
    assert list(kept) == [0, 2]
    assert bits.shape == (5, 64)
    kept_capped, _ = tp.dedup_frames(frames, delta=-1, max_keep=3, device="cpu")
    assert len(kept_capped) == 3


def test_dedup_empty():
    kept, bits = tp.dedup_frames(np.zeros((0, 8, 8, 3), np.uint8), 6, 10, device="cpu")
    want_kept, want_bits = jp.dedup_frames(jnp.zeros((0, 8, 8, 3), dtype=jnp.uint8), 6, 10)
    assert kept.size == want_kept.size == 0 and bits.shape == want_bits.shape == (0, 64)
    assert tp.greedy_dedup_mask(torch.zeros(0, 0), 6.0).shape == (0,)


def test_dedup_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.dedup_frames(np.zeros((2, 8, 8, 3), np.uint8), 6, 10)

