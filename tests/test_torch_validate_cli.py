"""The port's real-weights tools (``models/{validate,probe,cli}.py``) on the CPU.

The seven tests of ``tests/test_validate_cli.py`` on the port with
``--platform cpu`` / ``device="cpu"``, on TINY random-init HF checkpoints
written with ``save_pretrained`` (real checkpoint files, the identical
``from_pretrained -> derive config -> convert -> battery`` pipeline), plus:

* each family's report held against JAX's on the same checkpoint: the same
  report keys, the same gate verdicts, the torch-parity numbers within 1e-7
  (f32 rounding: drifts about 1e-12, score errors 5e-9 and 7e-9, against
  gates of 1e-3 and 2e-3), the W8A8 cosine within 1e-4,
  and the same PQ recall. JAX runs with ``MMRAG_ATTN_IMPL=fused``: on the CPU
  its default path skips the W8A8 kernels (``mmrag_tpu/models/bert.py:
  _use_q8`` follows ``use_fused``, which is off on the CPU), so its "W8A8"
  numbers would be the bf16 tower's; the port runs its W8A8 blocks on every
  device, so the fused setting is the like-for-like comparison;
* the CLI's exit codes 2 (nothing to validate, ``--model-id`` over several
  families, a missing dependency), ``find_real_checkpoints`` on the hub
  cache layout, and a failing family skipped by ``convert_found_into``.

Each model of the fixture is drawn after its own ``torch.manual_seed(0)``.
Seeded rerank logits sit about 1e-5 apart, so whether the W8A8 tower keeps
their order is a draw; on this draw JAX's q8 kernels and the port's both
keep it (``test_reports_match_jax`` holds the verdicts equal), which the
end-to-end test's passing reranker relies on.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from mmrag_tpu.models import validate as jval  # noqa: E402
from mmrag_tpu_torch.models import cli as models_cli  # noqa: E402
from mmrag_tpu_torch.models import validate as val  # noqa: E402


def _whisper_cfg():
    return transformers.WhisperConfig(
        vocab_size=256, num_mel_bins=80, d_model=32,
        encoder_layers=2, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=64, max_target_positions=32,
        dropout=0.0, attention_dropout=0.0,
        pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=3, suppress_tokens=[], begin_suppress_tokens=[],
    )


@pytest.fixture(scope="module")
def tiny_checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf_ckpts")
    bert = dict(vocab_size=512, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    transformers.BertModel(transformers.BertConfig(**bert)).eval().save_pretrained(
        root / "minilm")
    torch.manual_seed(0)
    transformers.BertForSequenceClassification(
        transformers.BertConfig(num_labels=1, **bert)).eval().save_pretrained(root / "reranker")
    clip_cfg = transformers.CLIPConfig(
        text_config_dict=dict(
            vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=16,
            # the real CLIP vocab layout: BOT/EOT are the two largest ids
            bos_token_id=126, eos_token_id=127),
        vision_config_dict=dict(image_size=32, patch_size=16, hidden_size=32,
                                num_hidden_layers=2, num_attention_heads=4,
                                intermediate_size=64),
        projection_dim=32)
    torch.manual_seed(0)
    transformers.CLIPModel(clip_cfg).eval().save_pretrained(root / "clip")
    torch.manual_seed(0)
    transformers.WhisperForConditionalGeneration(_whisper_cfg()).eval().save_pretrained(
        root / "whisper")
    return root


def test_validate_minilm_battery(tiny_checkpoints):
    rep = val.validate_minilm(str(tiny_checkpoints / "minilm"), pq_corpus=512, device="cpu")
    assert rep["parity_ok"], rep["cosine_drift_vs_torch"]
    assert rep["cosine_drift_vs_torch"] <= val.COSINE_GATE
    assert 0.0 <= rep["w8a8_cosine_vs_f32"] <= 1.0
    assert 0.0 <= rep["pq_refined_recall_at_10"] <= 1.0
    # derived-from-checkpoint architecture, not a preset
    assert rep["config"]["hidden_size"] == 32


def test_validate_reranker_battery(tiny_checkpoints):
    rep = val.validate_reranker(str(tiny_checkpoints / "reranker"), device="cpu")
    assert rep["parity_ok"], rep
    assert rep["order_preserved_vs_torch"]


def test_validate_clip_battery(tiny_checkpoints):
    rep = val.validate_clip(str(tiny_checkpoints / "clip"), device="cpu")
    assert rep["parity_ok"], rep
    assert rep["config"]["vision"]["image_size"] == 32


def test_validate_whisper_battery(tiny_checkpoints):
    rep = val.validate_whisper(str(tiny_checkpoints / "whisper"), device="cpu")
    assert rep["parity_ok"], rep
    assert rep["decoder_token_agreement"] == 1.0


# torch-parity numbers (f32 rounding on both sides, 1e-8 at most measured),
# the W8A8 cosine (the port's q8 blocks against JAX's interpret-mode
# kernels: 1e-5 apart measured)
PARITY_TOL = 1e-7
W8A8_TOL = 1e-4


@pytest.mark.parametrize("family", ["minilm", "reranker", "clip", "whisper"])
def test_reports_match_jax(family, tiny_checkpoints, monkeypatch):
    monkeypatch.setenv("MMRAG_ATTN_IMPL", "fused")
    kw = {"pq_corpus": 512} if family == "minilm" else {}
    src = str(tiny_checkpoints / family)
    got = val.public_report(val.VALIDATORS[family](src, device="cpu", **kw))
    want = jval.public_report(jval.VALIDATORS[family](src, **kw))
    assert sorted(got) == sorted(want)
    assert got["config"] == want["config"]
    for key, w in want.items():
        g = got[key]
        if isinstance(w, (bool, str, int)):
            assert g == w, (key, g, w)
        elif key.startswith("w8a8"):
            assert abs(g - w) <= W8A8_TOL, (key, g, w)
        elif key.startswith("pq_"):
            assert g == w, (key, g, w)
        elif isinstance(w, float):
            assert abs(g - w) <= PARITY_TOL, (key, g, w)
    assert val.report_passed(got) == jval.report_passed(want)


def test_validate_cli_end_to_end(tiny_checkpoints, tmp_path, capsys):
    out_root = tmp_path / "weights"
    models_cli.main([
        "validate", "--platform", "cpu",
        "--minilm", str(tiny_checkpoints / "minilm"),
        "--reranker", str(tiny_checkpoints / "reranker"),
        "--out", str(out_root),
    ])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["passed"] is True
    assert {r["family"] for r in report["reports"]} == {"minilm", "reranker"}
    # passing weights persisted in the runtime's layout, in JAX's flat npz
    for model_id in ("sentence-transformers__all-MiniLM-L6-v2",
                     "cross-encoder__ms-marco-MiniLM-L-6-v2"):
        assert (out_root / model_id / "model.npz").exists()
    from mmrag_tpu.models import convert as jconvert

    loaded = jconvert.load_params(str(out_root / "sentence-transformers__all-MiniLM-L6-v2"),
                                  "model")
    assert len(loaded["layers"]) == 2


def test_validate_cli_failure_exits_nonzero(tiny_checkpoints, tmp_path, monkeypatch):
    """A failing gate must exit non-zero and NOT persist weights."""

    def broken(source, **kw):
        rep = val.validate_minilm(source, pq_corpus=256, **kw)
        rep["parity_ok"] = False  # a drifted checkpoint
        return rep

    monkeypatch.setitem(val.VALIDATORS, "minilm", broken)
    out_root = tmp_path / "weights"
    with pytest.raises(SystemExit) as exc:
        models_cli.main(["validate", "--platform", "cpu",
                         "--minilm", str(tiny_checkpoints / "minilm"), "--out", str(out_root)])
    assert exc.value.code == 1
    assert not (out_root / "sentence-transformers__all-MiniLM-L6-v2").exists()


def test_validate_cli_usage_errors_exit_2(tiny_checkpoints, tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        models_cli.main(["validate", "--platform", "cpu"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        models_cli.main(["validate", "--platform", "cpu", "--model-id", "x",
                         "--minilm", str(tiny_checkpoints / "minilm"),
                         "--reranker", str(tiny_checkpoints / "reranker")])
    assert exc.value.code == 2

    def missing(source, **kw):
        raise ImportError("No module named 'transformers'")

    monkeypatch.setitem(val.VALIDATORS, "minilm", missing)
    with pytest.raises(SystemExit) as exc:
        models_cli.main(["validate", "--platform", "cpu", "--out", str(tmp_path / "w"),
                         "--minilm", str(tiny_checkpoints / "minilm")])
    assert exc.value.code == 2
    assert "missing dependency" in capsys.readouterr().err
    assert not (tmp_path / "w").exists()


def test_validate_takes_the_card_unless_cpu_is_asked(tiny_checkpoints, monkeypatch):
    """``device=None`` is the card: without CUDA the battery raises rather
    than run on the CPU."""

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        val.validate_reranker(str(tiny_checkpoints / "reranker"))


def test_find_real_checkpoints_reads_the_hub_cache_newest_snapshot(tiny_checkpoints, tmp_path,
                                                                   monkeypatch):
    from mmrag_tpu_torch.models.probe import find_real_checkpoints

    snaps = tmp_path / "hf" / "hub" / "models--openai--clip-vit-base-patch32" / "snapshots"
    old, new = snaps / "aaa", snaps / "bbb"
    for d in (old, new):
        d.mkdir(parents=True)
        for name in ("config.json", "model.safetensors"):
            (d / name).write_bytes((tiny_checkpoints / "clip" / name).read_bytes())
    os.utime(old, (1, 1))
    (snaps / "broken").mkdir()  # no weights: never chosen
    monkeypatch.delenv("TPU_REAL_WEIGHTS_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert find_real_checkpoints() == {"clip": str(new)}


def test_convert_found_into_skips_a_bad_family(tiny_checkpoints, tmp_path):
    from mmrag_tpu.models import convert as jconvert
    from mmrag_tpu_torch.models.probe import convert_found_into

    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "config.json").write_text("{}")
    converted = convert_found_into(str(tmp_path / "w"), {
        "minilm": str(tiny_checkpoints / "minilm"), "clip": str(bad)})
    assert set(converted) == {"minilm"} and converted["minilm"].hidden_size == 32
    tree = jconvert.load_params(str(tmp_path / "w" / "sentence-transformers__all-MiniLM-L6-v2"),
                                "model")
    assert len(tree["layers"]) == 2
    assert not (tmp_path / "w" / "openai__clip-vit-base-patch32" / "model.npz").exists()


def test_convert_found_into_upgrades_asr_runtime(tmp_path, monkeypatch):
    """A local real-format whisper checkpoint is found by
    ``find_real_checkpoints``, converted by ``convert_found_into`` into the
    layout the port's ASR runtime loads, and the runtime then transcribes
    and word-aligns with it on the CPU."""

    import wave

    from mmrag_tpu_torch import settings as settings_mod
    from mmrag_tpu_torch.ingest import asr
    from mmrag_tpu_torch.models import tokenizer as ttok
    from mmrag_tpu_torch.models.probe import convert_found_into, find_real_checkpoints

    torch.manual_seed(7)
    wh_cfg = _whisper_cfg()
    src = tmp_path / "real" / "whisper-base"
    transformers.WhisperForConditionalGeneration(wh_cfg).eval().save_pretrained(src)
    # real whisper checkpoints ship vocab.json (the byte-level BPE
    # detokenizer the align rung needs)
    b2u = ttok._bytes_to_unicode()
    vocab = {"".join(b2u[b] for b in f" tok{i}".encode()): i for i in range(wh_cfg.vocab_size)}
    (src / "vocab.json").write_text(json.dumps(vocab))
    monkeypatch.setenv("TPU_REAL_WEIGHTS_DIR", str(tmp_path / "real"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hf"))

    found = find_real_checkpoints()
    assert found == {"whisper": str(src)}
    weights_dir = tmp_path / "weights"
    converted = convert_found_into(str(weights_dir), found)
    assert set(converted) == {"whisper"}
    assert converted["whisper"].d_model == 32  # derived from the checkpoint
    wdir = weights_dir / "openai__whisper-base"
    assert (wdir / "model.npz").exists()
    assert (wdir / "vocab.json").exists()

    sr = 16000
    t = np.arange(int(sr * 1.5)) / sr
    pcm = (np.sin(2 * np.pi * 330 * t) * 0.3 * 32767).astype(np.int16)
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(sr)
        fh.writeframes(pcm.tobytes())

    cfg = settings_mod.load_settings({
        "WEIGHTS_DIR": str(weights_dir), "MODEL_ASR": "openai/whisper-base",
        "MODEL_ASR_WORD_ALIGN": "1"})
    runtime = asr.WhisperRuntime(cfg, max_tokens=8, device="cpu")
    assert runtime.available()
    segments = runtime.transcribe_wav(str(wav))  # the ladder contract
    assert segments and segments[0].text
    assert segments[0].words, segments[0]
    for word, start, end in segments[0].words:
        assert word.startswith("tok")
        assert 0.0 <= start <= end <= 1.5 + 1e-6
