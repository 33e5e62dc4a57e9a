"""The port's host-side ingest — ``ingest/pdf.py``, ``ingest/youtube.py`` (no
network) and ``utils/note_builder.py`` — gives the JAX package's outputs on
the same inputs (exact equality: both are the same pure-Python code), and
its ASR rung runs the port's Whisper when converted weights exist, raises
like JAX's without them, and never swallows an error of the port's runtime."""

import zlib

import pytest

from mmrag_tpu.ingest import pdf as jpdf
from mmrag_tpu.ingest import youtube as jyt
from mmrag_tpu.settings import load_settings as jload
from mmrag_tpu.utils import note_builder as jnb
from mmrag_tpu_torch.ingest import pdf as tpdf
from mmrag_tpu_torch.ingest import youtube as tyt
from mmrag_tpu_torch.settings import load_settings as tload
from mmrag_tpu_torch.utils import note_builder as tnb
from tiny_torch import write_wav


def _pdf(page_ops):
    objects, kids, next_id = [], [], 3
    for ops in page_ops:
        comp = zlib.compress(ops.encode("latin-1"))
        kids.append(next_id)
        objects.append((next_id, f"<< /Type /Page /Parent 2 0 R /Contents {next_id + 1} 0 R >>"
                        .encode()))
        objects.append((next_id + 1, b"<< /Filter /FlateDecode /Length " + str(len(comp)).encode()
                        + b" >>\nstream\n" + comp + b"\nendstream"))
        next_id += 2
    refs = " ".join(f"{k} 0 R" for k in kids)
    body = b"%PDF-1.4\n"
    for num, payload in [(1, b"<< /Type /Catalog /Pages 2 0 R >>"),
                         (2, f"<< /Type /Pages /Kids [{refs}] /Count {len(kids)} >>".encode())
                         ] + objects:
        body += f"{num} 0 obj\n".encode() + payload + b"\nendobj\n"
    return body + b"%%EOF"


PAGES = [
    "BT /F1 12 Tf 72 720 Td (Hello page one) Tj ET",
    r"BT (Parens \( inside \) and \\ backslash) Tj ET",
    "BT [(Kerned) -250 (words) 120 (here)] TJ ET",
    "BT <48656C6C6F20686578> Tj T* (next line) ' ET",
    "BT (" + "alpha beta gamma delta " * 80 + ") Tj ET",
]


def test_minipdf_pages_match_jax():
    data = _pdf(PAGES)
    assert tpdf.MiniPdf(data).page_texts() == jpdf.MiniPdf(data).page_texts()
    assert tpdf.MiniPdf(data).page_texts()[1] == "Parens ( inside ) and \\ backslash"


def test_extract_pdf_nodes_match_jax(tmp_path):
    path = tmp_path / "doc.pdf"
    path.write_bytes(_pdf(PAGES))
    env = {"MEDIA_DIR": str(tmp_path / "media")}
    want = jpdf.extract_pdf_nodes("u1", "doc1", str(path), jload(env))
    got = tpdf.extract_pdf_nodes("u1", "doc1", str(path), tload(env))
    assert got == want
    text_nodes, image_nodes = got
    assert {n["metadata"]["page"] for n in text_nodes} == {1, 2, 3, 4, 5}
    assert len(text_nodes) > 5 and image_nodes == []


@pytest.mark.parametrize("payload", [None, b"not a pdf at all"], ids=["missing", "not-pdf"])
def test_extract_pdf_errors(tmp_path, payload):
    path = tmp_path / "bad.pdf"
    if payload is not None:
        path.write_bytes(payload)
    with pytest.raises(tpdf.PdfExtractionError):
        tpdf.extract_pdf_nodes("u1", "d", str(path), tload({"MEDIA_DIR": str(tmp_path)}))


@pytest.mark.parametrize("url", [
    "https://www.youtube.com/watch?v=dQw4w9WgXcQ", "https://youtu.be/dQw4w9WgXcQ",
    "https://www.youtube.com/embed/dQw4w9WgXcQ?rel=0", "https://www.youtube.com/shorts/dQw4w9WgXcQ",
    "dQw4w9WgXcQ", "https://m.youtube.com/watch?feature=share&v=aBc_-123XyZ"])
def test_resolve_video_id_matches_jax(url):
    assert tyt.resolve_video_id(url) == jyt.resolve_video_id(url)


def test_resolve_video_id_rejects_garbage():
    with pytest.raises(tyt.YouTubeIngestError):
        tyt.resolve_video_id("https://example.com/not-youtube")


def _segs(mod):
    return [
        mod.TranscriptSegment("intro to cells", 0.0, 5.0),
        mod.TranscriptSegment("mitochondria make ATP", 5.0, 5.0),
        mod.TranscriptSegment("   ", 9.0, 1.0),
        mod.TranscriptSegment("chloroplasts do photosynthesis", 10.0, 5.0,
                              words=[("chloroplasts", 10.0, 11.0)]),
    ]


def test_segments_to_nodes_match_jax():
    got = tyt.segments_to_nodes("vid1", _segs(tyt))
    assert got == jyt.segments_to_nodes("vid1", _segs(jyt))
    assert got[1]["metadata"]["ts_end"] == 10.0 and got[1]["id"] == "vid1-s1"


def test_transcript_ladder_matches_jax(tmp_path):
    for mod in (tyt, jyt):
        out = mod.transcript_or_fallback(
            "https://youtu.be/dQw4w9WgXcQ", str(tmp_path),
            transcript_fn=lambda vid, m=mod: _segs(m),
            download_fn=lambda *a, **k: pytest.fail("must not download"))
        assert out["source"] == "transcript" and out["video_id"] == "dQw4w9WgXcQ"
    calls = []
    out = tyt.transcript_or_fallback(
        "dQw4w9WgXcQ", str(tmp_path),
        transcript_fn=lambda vid: (_ for _ in ()).throw(RuntimeError("no captions")),
        download_fn=lambda url, d, cfg: calls.append("dl") or str(tmp_path / "v.mp4"),
        audio_fn=lambda p, cfg: calls.append("wav") or str(tmp_path / "v.wav"),
        asr_fn=lambda p: calls.append("asr") or _segs(tyt))
    assert out["source"] == "asr" and calls == ["dl", "wav", "asr"]
    with pytest.raises(tyt.YouTubeIngestError):
        tyt.transcript_or_fallback("dQw4w9WgXcQ", str(tmp_path), transcript_fn=lambda vid: [],
                                   download_fn=lambda *a, **k: "v.mp4",
                                   audio_fn=lambda *a, **k: "v.wav", asr_fn=lambda p: [])


def _no_torch_rungs(monkeypatch):
    """whisperx / whisper absent, whatever the environment holds."""

    import sys

    monkeypatch.setitem(sys.modules, "whisperx", None)
    monkeypatch.setitem(sys.modules, "whisper", None)


def _whisper_weights(root, broken=False):
    """Seeded JAX-saved tiny Whisper weights and a byte-level vocab under
    ``root``; returns the settings env. ``broken``: the weights file is
    there but is no npz."""

    from mmrag_tpu.models import whisper as jwhisper
    from tiny_torch import write_tiny_whisper

    cfg = jwhisper.WhisperConfig(d_model=64, encoder_layers=2, encoder_heads=4,
                                 decoder_layers=2, decoder_heads=4, ffn_dim=128,
                                 vocab_size=200, max_source_positions=75,
                                 max_target_positions=48)
    model_id = "openai/whisper-ingesttest"
    write_tiny_whisper(root, cfg, 5, model_id)
    if broken:
        (root / "openai__whisper-ingesttest" / "model.npz").write_bytes(b"not an npz")
    return {"WEIGHTS_DIR": str(root), "MODEL_ASR": model_id}


def test_asr_rung_raises_until_ported(tmp_path, monkeypatch):
    """No converted weights (nothing of the port's Whisper to run) and no
    whisperx / whisper: the ladder raises YouTubeIngestError, as JAX's
    does, and never returns an empty or silently skipped transcript."""

    from mmrag_tpu.ingest import asr as jasr

    _no_torch_rungs(monkeypatch)
    env = {"WEIGHTS_DIR": str(tmp_path / "none")}
    monkeypatch.setattr(jasr, "_default_settings", jload(env))
    wav = str(tmp_path / "v.wav")
    jasr.reset_asr_runtime()
    with pytest.raises(jyt.YouTubeIngestError, match="neither whisperx nor whisper"):
        jyt.transcribe_audio(wav)
    with pytest.raises(tyt.YouTubeIngestError, match="neither whisperx nor whisper"):
        tyt.transcribe_audio(wav, tload(env), device="cpu")
    with pytest.raises(tyt.YouTubeIngestError, match="neither whisperx nor whisper"):
        tyt.transcript_or_fallback(
            "dQw4w9WgXcQ", str(tmp_path), tload(env),
            transcript_fn=lambda vid: (_ for _ in ()).throw(RuntimeError("no captions")),
            download_fn=lambda *a, **k: "v.mp4", audio_fn=lambda *a, **k: wav, device="cpu")


def test_asr_rung_transcribes_with_weights(tmp_path, monkeypatch):
    """Captions fail, weights exist: the ladder's default ASR stage is the
    port's Whisper (on the device it is given), and its segments are the
    runtime's."""

    from mmrag_tpu_torch.ingest import asr as tasr

    _no_torch_rungs(monkeypatch)
    env = _whisper_weights(tmp_path / "weights")
    wav = write_wav(tmp_path / "v.wav", 2.0)
    tasr.reset_asr_runtime()
    try:
        out = tyt.transcript_or_fallback(
            "dQw4w9WgXcQ", str(tmp_path), tload(env),
            transcript_fn=lambda vid: (_ for _ in ()).throw(RuntimeError("no captions")),
            download_fn=lambda *a, **k: str(tmp_path / "v.mp4"),
            audio_fn=lambda *a, **k: wav, device="cpu")
        runtime = tasr.get_asr_runtime(tload(env), device="cpu")
        assert runtime is not None and runtime.device.type == "cpu"
    finally:
        tasr.reset_asr_runtime()
    assert out["source"] == "asr" and out["segments"]
    want = tasr.WhisperRuntime(tload(env), device="cpu").transcribe_wav(wav)
    assert out["segments"] == want


def test_asr_rung_error_of_the_runtime_propagates(tmp_path, monkeypatch):
    """Weights present but unreadable: the port's runtime raises, and the
    ladder reports it as YouTubeIngestError with its cause, without trying
    whisperx (JAX's ladder would move on)."""

    import sys
    import types

    from mmrag_tpu_torch.ingest import asr as tasr

    tried = []
    fake = types.ModuleType("whisperx")
    fake.load_model = lambda *a, **k: tried.append("whisperx")
    monkeypatch.setitem(sys.modules, "whisperx", fake)
    env = _whisper_weights(tmp_path / "weights", broken=True)
    tasr.reset_asr_runtime()
    try:
        with pytest.raises(tyt.YouTubeIngestError, match="Whisper ASR failed") as err:
            tyt.transcribe_audio(write_wav(tmp_path / "v.wav", 2.0), tload(env), device="cpu")
    finally:
        tasr.reset_asr_runtime()
    assert err.value.__cause__ is not None and tried == []


def test_gated_deps_raise_cleanly():
    with pytest.raises(tyt.YouTubeIngestError, match="yt-dlp"):
        tyt.fetch_video_info("https://youtu.be/dQw4w9WgXcQ")
    with pytest.raises(tyt.YouTubeIngestError, match="transcript"):
        tyt.get_transcript("dQw4w9WgXcQ")


def test_notes_match_jax():
    for max_chars in (120, 10_000):
        assert tnb.truncate_context(_segs(tyt), max_chars) == jnb.truncate_context(
            _segs(jyt), max_chars)
    for q in (0, 2, 5):
        assert tnb.heuristic_notes("Bio video", _segs(tyt), q) == jnb.heuristic_notes(
            "Bio video", _segs(jyt), q)
    assert tnb.heuristic_notes("t", [], 3) == jnb.heuristic_notes("t", [], 3)
    got = tnb.build_notes_payload("Title", _segs(tyt), tload({}))
    assert got == jnb.build_notes_payload("Title", _segs(jyt), jload({}))
    assert got["title"] == "Title" and got["summary"]
    q = got["quiz"][0]
    assert q["answer"] in q["options"] and "_____" in q["question"]
