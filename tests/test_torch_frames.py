"""The port's scene scoring and frame extraction (``mmrag_tpu_torch/ingest/
frames.py``) against the JAX package's ``mmrag_tpu/ingest/frames.py`` and
OpenCV, on the CPU.

Tolerances: HSV histograms and Bhattacharyya scores within 1e-6 of JAX's
compiled functions (the counts are exact integers on both sides and the bins
equal, the compiled reciprocal and fused multiply-adds included; only the L2
norm's sum order differs); scene scores within 2e-2 of OpenCV's (bin edges differ by a pixel
or two between the float HSV path and cv2's uint8 rounding, as
``tests/test_ingest_video.py`` allows); extracted frames identical to
JAX's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.ingest import frames as jf
from mmrag_tpu.settings import load_settings as jload
from mmrag_tpu_torch.ingest import frames as tf
from mmrag_tpu_torch.settings import load_settings as tload

HIST_TOL = 1e-6


def test_histograms_and_scores_match_jax(rng):
    frames = rng.integers(0, 255, (7, 64, 96, 3), dtype=np.uint8)
    frames[2] = frames[1]  # identical frame -> distance ~0
    frames[4, :, :, :] = 128  # grey: zero saturation, hue 0
    frames[5, ..., 0] = 255  # red channel saturated: the mx == r branch with mod 6
    want = np.asarray(jf._hsv_histograms(jnp.asarray(frames)))
    got = tf._hsv_histograms(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == (7, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=HIST_TOL)
    want_s = np.asarray(jf._bhattacharyya_scores(jnp.asarray(want)))
    got_s = tf._bhattacharyya_scores(torch.from_numpy(np.array(want))).numpy()
    np.testing.assert_allclose(got_s, want_s, atol=HIST_TOL)
    np.testing.assert_allclose(tf._scene_scores(frames, "cpu").numpy(),
                               np.asarray(jf._scene_scores(frames)), atol=HIST_TOL)


def test_channel_ties_bin_as_the_compiled_jax_function():
    """(83, 52, 52): g == b. The compiled JAX function fuses ``g - b`` into a
    multiply-add, gets -6e-9 and puts the hue at 180 (bin 7), where the
    source read op by op gives 0 (bin 0); the port bins it as the compiled
    function does."""

    import jax

    frames = np.zeros((1, 4, 4, 3), np.uint8)
    frames[...] = (83, 52, 52)
    want = np.asarray(jf._hsv_histograms(jnp.asarray(frames)))
    got = tf._hsv_histograms(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=HIST_TOL)
    assert got[0].argmax() // 64 == 7
    with jax.disable_jit():
        assert np.asarray(jf._hsv_histograms(jnp.asarray(frames)))[0].argmax() // 64 == 0


def test_counts_above_256_in_a_bin_stay_exact():
    """A 720p frame at stride 4 has 57,600 samples; a flat frame puts all of
    them in one bin, past where a bf16 count would round (256)."""

    frames = np.zeros((3, 720, 1280, 3), np.uint8)
    frames[1, :, :640] = (200, 30, 30)
    frames[2, :361] = (10, 200, 10)  # 91 of 180 sampled rows: 29,120 in one bin
    x = torch.from_numpy(frames)[:, ::4, ::4, :]
    want = np.asarray(jf._hsv_histograms(jnp.asarray(frames)))
    got = tf._hsv_histograms(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=HIST_TOL)
    # un-normalized: the flat frame's one bin holds every sample
    assert got[0].max() == 1.0 and (got[0] > 0).sum() == 1
    assert x.shape[1] * x.shape[2] == 57600
    # 91 green rows x 320 and 89 black rows x 320: a bf16 count of 29,120
    # would round to 29,184
    np.testing.assert_allclose(np.sort(got[2][got[2] > 0]),
                               np.array([28480, 29120]) / np.hypot(28480, 29120), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 33, 70])
def test_scene_scores_chunk_like_jax(rng, n):
    """Chunks of 32 frames: the scores across chunk seams equal JAX's."""

    frames = rng.integers(0, 255, (n, 24, 40, 3), dtype=np.uint8)
    got = tf._scene_scores(frames, "cpu")
    assert got.shape == (n,) and got[0] == 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(jf._scene_scores(frames)),
                               atol=HIST_TOL)


cv2 = pytest.importorskip("cv2")


def test_scene_scores_match_cv2_hsv_bhattacharyya(rng):
    frames = rng.integers(0, 255, (5, 64, 96, 3), dtype=np.uint8)
    frames[2] = frames[1]
    got = tf._scene_scores(frames, "cpu").numpy()
    hists = []
    for f in frames[:, ::4, ::4, :]:
        hsv = cv2.cvtColor(np.ascontiguousarray(f), cv2.COLOR_RGB2HSV)
        hist = cv2.calcHist([hsv], [0, 1, 2], None, [8, 8, 8], [0, 180, 0, 256, 0, 256])
        cv2.normalize(hist, hist)
        hists.append(hist)
    want = [1.0] + [cv2.compareHist(hists[i], hists[i + 1], cv2.HISTCMP_BHATTACHARYYA)
                    for i in range(len(hists) - 1)]
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert got[2] < 0.05 and got[0] == 1.0


@pytest.fixture()
def sample_video(tmp_path, rng):
    """3 scenes x 4 seconds @ 4fps, 64x64: textured so phash discriminates."""

    path = str(tmp_path / "sample.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 4, (64, 64))
    for _ in range(3):
        blocks = rng.integers(0, 255, (8, 8, 3)).astype(np.float32)
        scene = np.kron(blocks, np.ones((8, 8, 1))).astype(np.uint8)
        for _ in range(16):
            writer.write(cv2.cvtColor(scene, cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def _cfg(load, tmp_path, **extra):
    return load({"INGEST_CACHE_DIR": str(tmp_path / "cache"), "YT_FRAME_STRIDE_SEC": "1",
                 "YT_FRAME_EXTRACTOR": "opencv", **extra})


@pytest.mark.parametrize("extra", [{}, {"YT_MAX_FRAMES": "2", "YT_FRAME_DEDUP_DELTA": "-1"}],
                         ids=["dedup", "cap"])
def test_extract_scene_frames_matches_jax(sample_video, tmp_path, extra):
    want, want_arrays = jf.extract_scene_frames(
        "u1", "vid1", sample_video, _cfg(jload, tmp_path / "jax", **extra), return_arrays=True)
    got, got_arrays = tf.extract_scene_frames(
        "u1", "vid1", sample_video, _cfg(tload, tmp_path / "torch", **extra),
        return_arrays=True, device="cpu")
    assert [f.ts for f in got] == [f.ts for f in want]
    assert [os.path.basename(f.path) for f in got] == [os.path.basename(f.path) for f in want]
    for a, b in zip(got_arrays, want_arrays):
        np.testing.assert_array_equal(a, b)
    assert all(os.path.getsize(f.path) > 0 for f in got)
    if extra:
        assert len(got) == 2
    else:
        assert 2 <= len(got) <= 5 and got == sorted(got, key=lambda f: f.ts)
    assert all(isinstance(f, tf.ExtractedFrame) for f in got)


def test_decode_seek_matches_sequential(tmp_path):
    fps = 10
    path = str(tmp_path / "seek.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (64, 64))
    for i in range(fps * 12):
        blocks = np.full((8, 8, 3), (i // fps) * 20 + 8, np.float32)
        writer.write(np.kron(blocks, np.ones((8, 8, 1))).astype(np.uint8))
    writer.release()
    for stride in (2.0, 0.5):  # the seek branch (step 20) and the grab-walk (step 5)
        stack, stamps = tf._decode_sampled_frames(path, stride_sec=stride)
        want_stack, want_stamps = jf._decode_sampled_frames(path, stride_sec=stride)
        assert stamps == want_stamps == [i * stride for i in range(len(stamps))]
        np.testing.assert_array_equal(stack, want_stack)


def test_extract_frames_missing_video(tmp_path):
    with pytest.raises(tf.FrameExtractionError):
        tf.extract_scene_frames("u1", "bad", str(tmp_path / "none.mp4"),
                                _cfg(tload, tmp_path), device="cpu")
