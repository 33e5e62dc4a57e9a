"""The port's Whisper (``mmrag_tpu_torch/models/whisper.py``, ``ingest/asr.py``,
the converter and the byte-level decoder) against the JAX package's, on the
CPU in f32, on ``TINY`` (``tests/test_whisper.py``'s geometry).

The same seeded numpy inputs go through the JAX function and the port's,
with the JAX params carried over by ``params_from_jax``. Tolerances: log-mel
2e-5 (f32 DFT and mel products summed in another order, then log10), the
filterbank 1e-6 (the same float64 recipe), encoder states and logits 1e-4;
greedy tokens, language ids, timestamp segments and the runtime's segments
equal.
"""

import dataclasses
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrag_tpu.ingest import asr as jasr
from mmrag_tpu.models import convert as jconvert
from mmrag_tpu.models import tokenizer as jtok
from mmrag_tpu.models import whisper as jwhisper
from mmrag_tpu.settings import load_settings as jload
from mmrag_tpu_torch.ingest import asr as tasr
from mmrag_tpu_torch.ingest import youtube as tyt
from mmrag_tpu_torch.models import convert as tconvert
from mmrag_tpu_torch.models import tokenizer as ttok
from mmrag_tpu_torch.models import whisper as twhisper
from mmrag_tpu_torch.settings import load_settings as tload
from tiny_torch import write_tiny_whisper, write_wav as _write_wav

TINY = twhisper.WhisperConfig(
    num_mel_bins=80, d_model=64, encoder_layers=2, encoder_heads=4,
    decoder_layers=2, decoder_heads=4, ffn_dim=128, vocab_size=200,
    max_source_positions=75, max_target_positions=48,
)
# standard vocab, so real language and timestamp ids exist
STD_TINY = dataclasses.replace(TINY, vocab_size=51865)


def _jcfg(cfg):
    return jwhisper.WhisperConfig(**dataclasses.asdict(cfg))


def _pair(cfg, seed):
    """(JAX params, the port's f32 params) of one seeded JAX init."""

    jparams = jwhisper.init_whisper_params(jax.random.PRNGKey(seed), _jcfg(cfg))
    flat = jconvert.flatten_params(jparams)
    return jparams, tconvert.params_from_jax(flat, "whisper", cfg)


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair(TINY, 0)


@pytest.fixture(scope="module")
def std_pair():
    return _pair(STD_TINY, 3)


def _mel(rng, b=2, cfg=TINY):
    return rng.standard_normal((b, cfg.max_source_positions * 2, cfg.num_mel_bins)).astype(
        np.float32)


def _enc(params, mel, cfg=TINY):
    return twhisper.whisper_encode(params, torch.from_numpy(mel), cfg)


# ---------------------------------------------------------------------------
# Log-mel (X4) and the filterbank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 2], ids=["window", "bucket-with-padding"])
def test_log_mel_matches_jax(rng, rows):
    """A 3.7 s clip in a 30 s window; the two-row case pads its second row
    with zeros, which keeps its own peak (per-row maximum)."""

    audio = np.zeros((rows, twhisper.CHUNK_SAMPLES), np.float32)
    audio[0, : int(16000 * 3.7)] = rng.standard_normal(int(16000 * 3.7)) * 0.1
    want = np.asarray(jax.jit(jwhisper.log_mel_spectrogram)(jnp.asarray(audio)))
    got = twhisper.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (rows, twhisper.NUM_FRAMES, 80)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_mel_filterbank_matches_jax():
    np.testing.assert_allclose(twhisper.mel_filterbank(), jwhisper.mel_filterbank(), atol=1e-6)
    for got, want in zip(twhisper._mel_constants(80), jwhisper._mel_constants(80)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Encoder, decoder, init, conversion
# ---------------------------------------------------------------------------


def test_encoder_matches_jax(tiny_pair, rng):
    jparams, tparams = tiny_pair
    mel = _mel(rng)
    want = np.asarray(jwhisper.whisper_encode(jparams, jnp.asarray(mel), _jcfg(TINY)))
    got = _enc(tparams, mel).numpy()
    assert got.shape == (2, TINY.max_source_positions, TINY.d_model)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_decoder_logits_match_jax(tiny_pair, rng):
    jparams, tparams = tiny_pair
    mel = _mel(rng)
    ids = rng.integers(0, TINY.vocab_size, (2, 7)).astype(np.int32)
    jenc = jwhisper.whisper_encode(jparams, jnp.asarray(mel), _jcfg(TINY))
    want = np.asarray(jwhisper.whisper_decode_logits(jparams, jnp.asarray(ids), jenc,
                                                     _jcfg(TINY)))
    got = twhisper.whisper_decode_logits(tparams, torch.from_numpy(ids), _enc(tparams, mel),
                                         TINY).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_init_tree_matches_jax_layout():
    """The port's seeded init has the JAX tree's paths and shapes (the
    numbers differ: a torch.Generator), and loads through params_from_jax."""

    got = tconvert.flatten_params(twhisper.init_whisper_params(0, TINY))
    want = jconvert.flatten_params(jwhisper.init_whisper_params(jax.random.PRNGKey(0),
                                                                _jcfg(TINY)))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    np.testing.assert_array_equal(got["encoder/positions"], want["encoder/positions"])
    params = tconvert.params_from_jax(got, "whisper", TINY)
    assert params["encoder"]["layers"][0]["attn"]["k"].keys() == {"kernel"}


def test_convert_whisper_matches_jax():
    transformers = pytest.importorskip("transformers")
    hf = transformers.WhisperConfig(
        vocab_size=TINY.vocab_size, num_mel_bins=80, encoder_layers=2,
        encoder_attention_heads=4, decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128, d_model=64,
        max_source_positions=75, max_target_positions=48, pad_token_id=0,
        bos_token_id=0, eos_token_id=1, decoder_start_token_id=2,
    )
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(hf).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    got = tconvert.flatten_params(tconvert.convert_whisper(sd, TINY))
    want = jconvert.flatten_params(jconvert.convert_whisper(sd, _jcfg(TINY)))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # and the converted tree encodes as HF's encoder does
    mel = np.random.default_rng(1).standard_normal((1, 150, 80)).astype(np.float32)
    with torch.no_grad():
        hf_enc = model.model.encoder(torch.from_numpy(mel.transpose(0, 2, 1))).last_hidden_state
    params = tconvert.params_from_jax(got, "whisper", TINY)
    np.testing.assert_allclose(_enc(params, mel).numpy(), hf_enc.numpy(), atol=2e-4)


# ---------------------------------------------------------------------------
# Greedy decode (X5) and detection
# ---------------------------------------------------------------------------


def test_greedy_decode_matches_jax(tiny_pair, rng):
    jparams, tparams = tiny_pair
    mel = _mel(rng)
    jenc = jwhisper.whisper_encode(jparams, jnp.asarray(mel), _jcfg(TINY))
    want, want_len = jwhisper.whisper_greedy_decode(
        jparams, jenc, _jcfg(TINY), forced_prefix=(5, 9), max_len=12, eot_id=3)
    got, got_len = twhisper.whisper_greedy_decode(
        tparams, _enc(tparams, mel), TINY, forced_prefix=(5, 9), max_len=12, eot_id=3)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_greedy_decode_stops_counting_at_eot(tiny_pair, rng):
    jparams, tparams = tiny_pair
    mel = _mel(rng, b=1)
    tokens, lengths = twhisper.whisper_greedy_decode(
        tparams, _enc(tparams, mel), TINY, forced_prefix=(5, 3), max_len=8, eot_id=3)
    jenc = jwhisper.whisper_encode(jparams, jnp.asarray(mel), _jcfg(TINY))
    want, want_len = jwhisper.whisper_greedy_decode(
        jparams, jenc, _jcfg(TINY), forced_prefix=(5, 3), max_len=8, eot_id=3)
    assert int(lengths[0]) == int(want_len[0]) == 1  # only the '5' before the forced eot
    assert tokens[0, 1:].tolist() == np.asarray(want)[0, 1:].tolist() == [3] * 7


def test_timestamp_prefix_greedy_decode_matches_jax(std_pair, rng):
    """The timestamp prefix (no <|notimestamps|>) on a standard-vocab model:
    the decode behind sub-window segments."""

    jparams, tparams = std_pair
    prefix = STD_TINY.forced_prefix(language="en")[:-1]
    assert prefix[-1] == STD_TINY.transcribe_id
    mel = _mel(rng, cfg=STD_TINY)
    jenc = jwhisper.whisper_encode(jparams, jnp.asarray(mel), _jcfg(STD_TINY))
    want, want_len = jwhisper.whisper_greedy_decode(
        jparams, jenc, _jcfg(STD_TINY), forced_prefix=prefix, max_len=16)
    got, got_len = twhisper.whisper_greedy_decode(
        tparams, _enc(tparams, mel, STD_TINY), STD_TINY, forced_prefix=prefix, max_len=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_greedy_decode_rejects_overlong_max_len(tiny_pair, rng):
    _, tparams = tiny_pair
    enc = _enc(tparams, _mel(rng, b=1))
    with pytest.raises(AssertionError, match="max_target_positions"):
        twhisper.whisper_greedy_decode(tparams, enc, TINY, forced_prefix=(5,), eot_id=3,
                                       max_len=TINY.max_target_positions + 1)


def test_detect_language_matches_jax(rng):
    cfg = dataclasses.replace(STD_TINY, max_source_positions=30, max_target_positions=16)
    jparams, tparams = _pair(cfg, 7)
    mel = rng.standard_normal((3, 60, 80)).astype(np.float32)
    jenc = jwhisper.whisper_encode(jparams, jnp.asarray(mel), _jcfg(cfg))
    want = np.asarray(jwhisper.detect_language(jparams, jenc, _jcfg(cfg)))
    got = twhisper.detect_language(tparams, _enc(tparams, mel, cfg), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(cfg.lang_base_id <= x < cfg.lang_base_id + cfg.num_languages for x in want)


# ---------------------------------------------------------------------------
# Token ids, presets, the byte-level decoder, segment parsing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [200, 51864, 51865, 51866])
def test_special_token_ids_match_jax(vocab):
    got = dataclasses.replace(twhisper.WHISPER_BASE, vocab_size=vocab)
    want = _jcfg(got)
    names = ("eot_id", "sot_id", "num_languages", "lang_base_id", "translate_id",
             "transcribe_id", "no_timestamps_id", "timestamp_begin_id", "multilingual")
    assert [getattr(got, n) for n in names] == [getattr(want, n) for n in names]
    assert got.forced_prefix() == want.forced_prefix()
    if got.multilingual:
        assert got.forced_prefix(language="de") == want.forced_prefix(language="de")
    assert twhisper.LANGUAGES == jwhisper.LANGUAGES
    for name in ("openai/whisper-tiny", "openai/whisper-base", "openai/whisper-small"):
        assert dataclasses.asdict(twhisper.preset(name)) == dataclasses.asdict(
            jwhisper.preset(name))


def _b2u_vocab(words):
    b2u = ttok._bytes_to_unicode()
    return {"".join(b2u[b] for b in w.encode("utf-8")): i for i, w in enumerate(words)}


def test_byte_level_decoder_matches_jax():
    vocab = _b2u_vocab(["hello", " world", " → tpu"])
    vocab["<|eot|>"] = 3
    got = ttok.ByteLevelBPEDecoder(vocab, special_base=3)
    want = jtok.ByteLevelBPEDecoder(vocab, special_base=3)
    assert got.decode([0, 1, 2, 3]) == want.decode([0, 1, 2, 3]) == "hello world → tpu"
    assert got.decode([3, 3]) == "" and got.decode([2, 99, 0]) == want.decode([2, 99, 0])
    assert ttok._bytes_to_unicode() == jtok._bytes_to_unicode()


def test_parse_timestamp_segments_match_jax():
    cfg = twhisper.WHISPER_BASE
    tsb, eot = cfg.timestamp_begin_id, cfg.eot_id

    def ts(sec):
        return tsb + int(sec / 0.02)

    prefix = list(cfg.forced_prefix()[:-1])
    cases = [
        (prefix + [ts(0.0), 11, 12, ts(3.5), ts(3.5), 13, ts(7.0), eot, eot], 30.0, 30.0),
        (prefix + [14, ts(1.0), 15, 16], 0.0, 8.0),
        (prefix + [11, 12, eot], 0.0, 30.0),
    ]
    for toks, offset, window in cases:
        got = twhisper.parse_timestamp_segments(toks, cfg, offset, window)
        assert got == jwhisper.parse_timestamp_segments(toks, _jcfg(cfg), offset, window)
    assert twhisper.parse_timestamp_segments(cases[0][0], cfg, 30.0) == [
        (30.0, 33.5, [11, 12]), (33.5, 37.0, [13])]


def test_window_segments_match_jax():
    cfg = twhisper.WHISPER_BASE
    vocab = _b2u_vocab([" alpha", " beta"])
    vocab = {k: v + 11 for k, v in vocab.items()}
    tsb = cfg.timestamp_begin_id
    streams = [
        (list(cfg.forced_prefix()[:-1]) + [tsb, 11, tsb + 100, tsb + 100, 12, tsb + 200],
         30.0, 30.0),
        (list(cfg.forced_prefix()) + [11, 12], 0.0, 12.5),
    ]
    results = []
    for mod, dec_mod, mcfg in ((tasr, ttok, cfg), (jasr, jtok, _jcfg(cfg))):
        runtime = mod.WhisperRuntime.__new__(mod.WhisperRuntime)
        runtime.timestamps = True
        runtime._model_cfg = mcfg
        runtime._decoder = dec_mod.ByteLevelBPEDecoder(vocab, special_base=cfg.eot_id)
        results.append([runtime._window_segments(np.asarray(t), s, c) for t, s, c in streams])
    assert results[0] == results[1]
    assert results[0] == [[(30.0, 2.0, "alpha"), (32.0, 2.0, "beta")],
                          [(0.0, 12.5, "alpha beta")]]


# ---------------------------------------------------------------------------
# The runtime end to end: wav -> segments, against the JAX runtime
# ---------------------------------------------------------------------------

MODEL_ID = "openai/whisper-testtiny"


def _write_weights(root, cfg, seed=0, model_id=MODEL_ID):
    return write_tiny_whisper(root, _jcfg(cfg), seed, model_id)


def test_asr_runtime_end_to_end_matches_jax(tmp_path):
    env = {"WEIGHTS_DIR": _write_weights(tmp_path / "weights", TINY), "MODEL_ASR": MODEL_ID}
    runtime = tasr.WhisperRuntime(tload(env), max_tokens=8, device="cpu")
    assert runtime.available() and runtime.compute_dtype == torch.float32
    wav = _write_wav(tmp_path / "a.wav", 2.0)
    got = runtime.transcribe_wav(wav)
    want = jasr.WhisperRuntime(jload(env), max_tokens=8).transcribe_wav(wav)
    assert [(s.text, s.start, s.duration) for s in got] == [
        (s.text, s.start, s.duration) for s in want]
    window = TINY.max_source_positions * 2 * 160 / 16000
    assert got and all(s.start % window == 0 and 0 < s.duration <= window and s.text
                       for s in got)


def test_chunking_covers_long_audio_matches_jax(tmp_path):
    """3 1/3 windows: one bucket-4 dispatch with a padded row, the ragged
    tail's duration kept; then 9 windows, buckets 8 + 1."""

    env = {"WEIGHTS_DIR": _write_weights(tmp_path / "weights", TINY), "MODEL_ASR": MODEL_ID}
    runtime = tasr.WhisperRuntime(tload(env), max_tokens=4, device="cpu")
    jruntime = jasr.WhisperRuntime(jload(env), max_tokens=4)
    window = TINY.max_source_positions * 2 * 160
    noise = np.random.default_rng(0).standard_normal(window * 9).astype(np.float32) * 0.05
    for n in (window * 3 + window // 3, window * 9):
        segs = runtime.transcribe_array(noise[:n])
        assert segs == jruntime.transcribe_array(noise[:n])
        for start, dur, text in segs:
            assert (start * 16000) % window == 0 and 0 < dur <= window / 16000 and text
    tail = [d for s, d, _ in runtime.transcribe_array(noise[: window * 3 + window // 3])
            if s * 16000 == window * 3]
    assert tail and all(abs(d - (window // 3) / 16000) < 1e-6 for d in tail)
    assert set(runtime._fns) == {(4, (TINY.sot_id,)), (8, (TINY.sot_id,)), (1, (TINY.sot_id,))}


def test_asr_singleton_rebuilds_on_settings_change(tmp_path):
    root = tmp_path / "w"
    for name in ("m1", "m2"):
        _write_weights(root, TINY, model_id=f"openai/{name}")
    cfg1 = tload({"WEIGHTS_DIR": str(root), "MODEL_ASR": "openai/m1"})
    cfg2 = tload({"WEIGHTS_DIR": str(root), "MODEL_ASR": "openai/m2"})
    tasr.reset_asr_runtime()
    try:
        r1 = tasr.get_asr_runtime(cfg1, device="cpu")
        assert r1 is not None and r1.cfg.models.asr == "openai/m1"
        assert tasr.get_asr_runtime(cfg1, device="cpu") is r1
        r2 = tasr.get_asr_runtime(cfg2, device="cpu")
        assert r2 is not None and r2.cfg.models.asr == "openai/m2" and r2 is not r1
        assert tasr.get_asr_runtime(tload({"WEIGHTS_DIR": str(tmp_path / "none")}),
                                    device="cpu") is None
    finally:
        tasr.reset_asr_runtime()


def test_read_wav_errors(tmp_path):
    for name, rate, channels, width in (("rate", 8000, 1, 2), ("stereo", 16000, 2, 2),
                                        ("width", 16000, 1, 3)):
        path = tmp_path / f"{name}.wav"
        with wave.open(str(path), "wb") as fh:
            fh.setnchannels(channels)
            fh.setsampwidth(width)
            fh.setframerate(rate)
            fh.writeframes(b"\x00" * 600)
        with pytest.raises(ValueError):
            tasr.read_wav_mono16k(str(path))
        with pytest.raises(ValueError):
            jasr.read_wav_mono16k(str(path))
    ok = _write_wav(tmp_path / "ok.wav", 0.5)
    np.testing.assert_array_equal(tasr.read_wav_mono16k(ok), jasr.read_wav_mono16k(ok))


def test_runtime_refuses_a_missing_card(tmp_path, monkeypatch):
    """Without CUDA, a runtime not given device='cpu' raises, and so does the
    ladder when weights exist (no silent CPU run); without weights the
    singleton is None and nothing touches the device."""

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = {"WEIGHTS_DIR": _write_weights(tmp_path / "weights", TINY), "MODEL_ASR": MODEL_ID}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tasr.WhisperRuntime(tload(env))
    tasr.reset_asr_runtime()
    try:
        assert tasr.get_asr_runtime(tload({"WEIGHTS_DIR": str(tmp_path / "none")})) is None
        with pytest.raises(tyt.YouTubeIngestError, match="CUDA is not available"):
            tyt.transcribe_audio(_write_wav(tmp_path / "a.wav", 0.5), tload(env))
    finally:
        tasr.reset_asr_runtime()
