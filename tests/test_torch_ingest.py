"""The port's host-side ingest — ``ingest/pdf.py``, ``ingest/youtube.py`` (no
network) and ``utils/note_builder.py`` — gives the JAX package's outputs on
the same inputs (exact equality: both are the same pure-Python code), and
its ASR rung raises until ASR is ported."""

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


def test_asr_rung_raises_until_ported(tmp_path):
    """No captions: the ladder reaches ASR, which is not ported (ROADMAP Queue
    A item 6) — it raises, never returns an empty or silently skipped
    transcript."""

    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        tyt.transcribe_audio(str(tmp_path / "v.wav"))
    with pytest.raises(NotImplementedError, match="ASR is not ported"):
        tyt.transcript_or_fallback(
            "dQw4w9WgXcQ", str(tmp_path),
            transcript_fn=lambda vid: (_ for _ in ()).throw(RuntimeError("no captions")),
            download_fn=lambda *a, **k: "v.mp4", audio_fn=lambda *a, **k: "v.wav")


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
