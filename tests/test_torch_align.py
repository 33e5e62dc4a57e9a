"""The port's word aligner (``mmrag_tpu_torch/models/align.py`` and the
runtime's aligned path) against the JAX package's, on the CPU in f32, on
``tests/test_align.py``'s tiny standard-vocab geometry.

Tolerances: the teacher-forced logits and cross-attention probabilities
1e-5, the device alignment matrix (X6) 1e-5 (z-norm sums in another order);
DTW paths, median filter, word grouping and the runtime's word spans equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrag_tpu.ingest import asr as jasr
from mmrag_tpu.models import align as jalign
from mmrag_tpu.models import convert as jconvert
from mmrag_tpu.models import tokenizer as jtok
from mmrag_tpu.models import whisper as jwhisper
from mmrag_tpu.settings import load_settings as jload
from mmrag_tpu_torch.ingest import asr as tasr
from mmrag_tpu_torch.ingest import youtube as tyt
from mmrag_tpu_torch.models import align as talign
from mmrag_tpu_torch.models import convert as tconvert
from mmrag_tpu_torch.models import tokenizer as ttok
from mmrag_tpu_torch.models import whisper as twhisper
from mmrag_tpu_torch.settings import load_settings as tload
from tiny_torch import write_tiny_whisper, write_wav

TINY = twhisper.WhisperConfig(
    num_mel_bins=80, d_model=64, encoder_layers=2, encoder_heads=4,
    decoder_layers=2, decoder_heads=4, ffn_dim=128, vocab_size=51865,
    max_source_positions=75, max_target_positions=48,
)
JTINY = jwhisper.WhisperConfig(**dataclasses.asdict(TINY))


@pytest.fixture(scope="module")
def tiny_pair():
    jparams = jwhisper.init_whisper_params(jax.random.PRNGKey(3), JTINY)
    return jparams, tconvert.params_from_jax(jconvert.flatten_params(jparams), "whisper", TINY)


# ---------------------------------------------------------------------------
# The device capture and its reduction (X6)
# ---------------------------------------------------------------------------


def test_cross_attention_capture_matches_jax(tiny_pair):
    jparams, tparams = tiny_pair
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 150, 80)).astype(np.float32)
    ids = rng.integers(0, 200, (2, 9)).astype(np.int32)
    jenc = jwhisper.whisper_encode(jparams, jnp.asarray(mel), JTINY)
    want_logits, want_cross = jalign.decoder_cross_attention(jparams, jnp.asarray(ids), jenc,
                                                             JTINY)
    tenc = twhisper.whisper_encode(tparams, torch.from_numpy(mel), TINY)
    got_logits, got_cross = talign.decoder_cross_attention(tparams, torch.from_numpy(ids),
                                                           tenc, TINY)
    assert got_cross.shape == (TINY.decoder_layers, 2, TINY.decoder_heads, 9, 75)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-5)
    np.testing.assert_allclose(got_cross.numpy(), np.asarray(want_cross), atol=1e-5)
    # the capture's logits are the production decoder's
    np.testing.assert_allclose(
        got_logits.numpy(),
        twhisper.whisper_decode_logits(tparams, torch.from_numpy(ids), tenc, TINY).numpy(),
        rtol=1e-6, atol=1e-6)


def _device_matrix(cross):
    return talign.alignment_matrix_device(torch.from_numpy(cross)).numpy()


def _jax_matrix(cross):
    return np.asarray(jax.jit(jalign.alignment_matrix_device)(jnp.asarray(cross)))


@pytest.mark.parametrize("case", ["random", "constant-row", "few-frames"])
def test_alignment_matrix_device_matches_jax(case):
    """A constant token row has std 0 (kept by where(std < 1e-9, 1, std));
    three frames make Bessel's correction a 22% change of the std, so both
    pin the population std of ``jnp.std``."""

    rng = np.random.default_rng(11)
    frames = 3 if case == "few-frames" else 96
    cross = rng.random((4, 8, 24, frames)).astype(np.float32)
    if case == "constant-row":
        cross[2:, :, 5] = 0.25
    got, want = _device_matrix(cross), _jax_matrix(cross)
    assert got.shape == want.shape == (24, frames)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, talign.attention_alignment_matrix(cross), atol=1e-5)
    if case == "constant-row":
        assert np.all(got[5] == 0.0)


# ---------------------------------------------------------------------------
# Host DTW, median filter, word grouping
# ---------------------------------------------------------------------------


def test_dtw_matches_jax():
    n_tok, per = 5, 8
    block = np.full((n_tok, n_tok * per), -1.0)
    for i in range(n_tok):
        block[i, i * per:(i + 1) * per] = 1.0
    spans = talign.token_frame_spans(block)
    assert spans.tolist() == [[i * per, (i + 1) * per] for i in range(n_tok)]
    noise = np.random.default_rng(0).standard_normal((12, 60))
    path = talign.dtw_monotonic(-noise)
    assert path == jalign.dtw_monotonic(-noise)
    assert path[0] == (0, 0) and path[-1] == (11, 59)
    np.testing.assert_array_equal(talign.token_frame_spans(noise),
                                  jalign.token_frame_spans(noise))


def test_median_filter_matches_jax():
    x = np.zeros((2, 21))
    x[:, 10] = 100.0  # an isolated spike vanishes under the width-7 median
    assert np.all(talign._median_filter(x, 7) == 0.0)
    y = np.random.default_rng(4).standard_normal((3, 5, 40))
    np.testing.assert_array_equal(talign._median_filter(y, 7), jalign._median_filter(y, 7))


def _make_decoders(words):
    """(port decoder, JAX decoder, ids): each word maps to 1-2 byte-level
    pieces of the concatenated ' word' stream."""

    b2u = ttok._bytes_to_unicode()
    vocab, ids = {}, []
    for w in words:
        for p in ([f" {w}"] if len(w) < 4 else [f" {w[:2]}", w[2:]]):
            key = "".join(b2u[b] for b in p.encode())
            vocab.setdefault(key, len(vocab))
            ids.append(vocab[key])
    vocab["<|endoftext|>"] = 50256
    return (ttok.ByteLevelBPEDecoder(vocab, special_base=50256),
            jtok.ByteLevelBPEDecoder(vocab, special_base=50256), ids)


def test_group_words_matches_jax():
    words = ["the", "powerhouse", "of", "the", "cell"]
    tdec, jdec, ids = _make_decoders(words)
    spans = np.array([[i * 4, (i + 1) * 4] for i in range(len(ids))])
    got = talign.group_words(ids, spans, tdec, time_offset=10.0)
    want = jalign.group_words(ids, spans, jdec, time_offset=10.0)
    assert [dataclasses.astuple(w) for w in got] == [dataclasses.astuple(w) for w in want]
    assert [w.word for w in got] == words
    assert got[1].end - got[1].start == pytest.approx(2 * 4 * talign.FRAME_SECONDS)


def test_words_from_cross_and_matrix_match_jax():
    """Prefix/EOT tokens never surface as words; the device-reduced matrix
    gives the host reduction's words."""

    tdec, jdec, ids = _make_decoders(["alpha", "beta", "gamma"])
    toks = [TINY.sot_id] + ids + [TINY.eot_id]
    cross = np.random.default_rng(2).random(
        (TINY.decoder_layers, TINY.decoder_heads, len(toks), 60)).astype(np.float32)
    got = talign.words_from_cross(cross, toks, tdec, TINY)
    want = jalign.words_from_cross(cross, toks, jdec, JTINY)
    assert [dataclasses.astuple(w) for w in got] == [dataclasses.astuple(w) for w in want]
    assert [w.word for w in got] == ["alpha", "beta", "gamma"]
    via_matrix = talign.words_from_matrix(_device_matrix(cross), toks, tdec, TINY)
    assert [w.word for w in via_matrix] == [w.word for w in got]
    for a, b in zip(via_matrix, got):
        assert abs(a.start - b.start) < 1e-6 and abs(a.end - b.end) < 1e-6


# ---------------------------------------------------------------------------
# The runtime's aligned path and the ladder
# ---------------------------------------------------------------------------

MODEL_ID = "openai/whisper-aligntest"


def _setup(tmp_path, seconds, freq):
    """(WEIGHTS_DIR, wav path): JAX-saved weights and a sine of ``seconds``."""

    return (write_tiny_whisper(tmp_path / "weights", JTINY, 9, MODEL_ID),
            write_wav(tmp_path / "a.wav", seconds, freq))


def test_transcribe_aligned_matches_jax(tmp_path):
    weights, wav = _setup(tmp_path, 2.5, 330)
    env = {"WEIGHTS_DIR": weights, "MODEL_ASR": MODEL_ID}
    runtime = tasr.WhisperRuntime(tload(env), max_tokens=8, device="cpu")
    got = runtime.transcribe_wav_aligned(wav)
    want = jasr.WhisperRuntime(jload(env), max_tokens=8).transcribe_wav_aligned(wav)

    def plain(segs):
        return [(s["start"], s["duration"], s["text"],
                 [dataclasses.astuple(w) for w in s["words"]]) for s in segs]

    assert plain(got) == plain(want)
    assert len(got) == len(runtime.transcribe_wav(wav))
    window = TINY.max_source_positions * 2 * 160 / 16000
    for seg in got:
        assert seg["text"]
        for w in seg["words"]:
            assert w.end > w.start >= seg["start"] - window and w.end <= 2.5 + 1e-6
            assert w.word.startswith("tok")


def test_word_align_setting_flows_through_ladder(tmp_path):
    """MODEL_ASR_WORD_ALIGN=1: the ladder's segments carry word spans, equal
    to the JAX ladder's, and segments_to_nodes surfaces them; off (the
    default), plain segments."""

    from mmrag_tpu.ingest import youtube as jyt

    weights, wav = _setup(tmp_path, 2.0, 220)
    env = {"WEIGHTS_DIR": weights, "MODEL_ASR": MODEL_ID, "MODEL_ASR_WORD_ALIGN": "1"}
    tasr.reset_asr_runtime()
    try:
        got = tyt.transcribe_audio(wav, tload(env), device="cpu")
    finally:
        tasr.reset_asr_runtime()
    want = jasr.WhisperRuntime(jload(env)).transcribe_wav(wav)
    assert got == [tyt.TranscriptSegment(s.text, s.start, s.duration, s.words) for s in want]
    assert any(s.words for s in got)
    nodes = tyt.segments_to_nodes("vid1", got)
    assert nodes == jyt.segments_to_nodes("vid1", want)
    assert next(n["metadata"]["words"] for n in nodes if "words" in n["metadata"])[0][0] \
        .startswith("tok")
    env_off = dict(env, MODEL_ASR_WORD_ALIGN="0")
    plain = tasr.WhisperRuntime(tload(env_off), device="cpu").transcribe_wav(wav)
    assert plain and all(s.words is None for s in plain)
