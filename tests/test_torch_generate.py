"""The port's grounded generation (``rag/generate.py``, offline path) and its
SQLite TTL store (``storage/kv.py``) against the JAX package's: the same
hits give equal prompts, citation tokens, payloads and abstentions, and the
store's TTL semantics are equal."""

import pytest

from mmrag_tpu.rag import generate as jgen
from mmrag_tpu.settings import load_settings as jload
from mmrag_tpu.storage.kv import KVStore as JKV
from mmrag_tpu_torch.rag import generate as tgen
from mmrag_tpu_torch.settings import load_settings as tload
from mmrag_tpu_torch.storage.kv import KVStore as TKV

HITS = [
    {"chunk_id": "d1-p3-c0", "document_id": "d1", "modality": "text", "score": 0.91,
     "combined_score": 1.4, "text": "The mitochondria is the powerhouse of the cell.",
     "meta": {"page": 3}},
    {"chunk_id": "v1-s2", "document_id": "v1", "modality": "text", "score": 0.72,
     "combined_score": None, "text": "krebs cycle " * 60, "meta": {"ts_start": 12.4, "ts_end": 17.9}},
    {"chunk_id": "d1-img0", "document_id": "d1", "modality": "image", "score": 0.31,
     "combined_score": 0.2, "media_path": "/media/d1/img0.png", "meta": {}},
    {"chunk_id": "d2-c9", "document_id": "d2", "modality": "text", "score": 0.5, "text": "",
     "meta": {}},
]


@pytest.mark.parametrize("hit", HITS, ids=[h["chunk_id"] for h in HITS])
def test_citation_token_matches_jax(hit):
    assert tgen.citation_token(hit) == jgen.citation_token(hit)


def test_build_prompt_matches_jax():
    got = tgen.build_prompt("why?", HITS)
    assert got == jgen.build_prompt("why?", HITS)
    assert "[doc:d1 p:3] The mitochondria" in got and "[ts:12-18]" in got
    assert "/media/d1/img0.png [doc:d1]" in got and got.endswith("Question: why?")


@pytest.mark.parametrize("tau,hits", [
    ("0.0", HITS), ("5.0", HITS), ("0.0", []), ("0.0", HITS[2:3]), ("0.6", HITS[1:2])],
    ids=["answers", "abstains", "empty", "images-only", "unfused-score"])
def test_generate_response_matches_jax(tau, hits):
    env = {"CONFIDENCE_TAU": tau}
    got = tgen.generate_response("what is the powerhouse?", hits, tload(env))
    want = jgen.generate_response("what is the powerhouse?", hits, jload(env))
    assert got == want
    assert got["response"] == got["answer"]
    assert set(got["citations"]) == {"text", "images"}


def test_generate_offline_answer_and_abstention():
    ans = tgen.generate_response("q", HITS, tload({"CONFIDENCE_TAU": "0.0"}))
    assert not ans["abstained"] and ans["answer"].startswith("Based on the indexed evidence")
    low = tgen.generate_response("q", HITS, tload({"CONFIDENCE_TAU": "5.0"}))
    assert low["abstained"] and "closest passages" in low["answer"]
    assert tgen.generate_response("q", [], tload({}))["abstained"]


def test_gemini_gate_without_key_or_sdk():
    from mmrag_tpu_torch.utils.gemini import get_model

    assert get_model(tload({})) is None
    assert get_model(tload({"GEMINI_API_KEY": "k"})) is None  # no SDK installed


def test_kv_ttl_semantics_match_jax(tmp_path, monkeypatch):
    """setex / get / set_if_absent / delete / sweep on a clock both stores
    read: equal answers at every step, expiry included."""

    import time as _time

    now = [1000.0]
    monkeypatch.setattr(_time, "time", lambda: now[0])
    stores = (JKV(str(tmp_path / "j" / "kv.db")), TKV(str(tmp_path / "t" / "kv.db")))

    def both(fn):
        out = [fn(s) for s in stores]
        assert out[0] == out[1], out
        return out[1]

    both(lambda s: s.setex("a", 10.0, "1"))
    both(lambda s: s.setex("forever", None, "x"))
    assert both(lambda s: s.get("a")) == "1"
    assert both(lambda s: s.set_if_absent("a", 5.0, "2")) is False
    assert both(lambda s: s.set_if_absent("b", 5.0, "3")) is True
    now[0] += 6.0
    assert both(lambda s: s.get("b")) is None  # expired
    assert both(lambda s: s.set_if_absent("b", 5.0, "4")) is True
    now[0] += 5.0
    assert both(lambda s: s.get("a")) is None  # expired and deleted on read
    now[0] += 1.0
    assert both(lambda s: s.sweep()) == 1  # "b", past its TTL, never read
    assert both(lambda s: s.get("forever")) == "x"
    both(lambda s: s.delete("forever"))
    assert both(lambda s: s.get("forever")) is None
    for s in stores:
        s.close()
