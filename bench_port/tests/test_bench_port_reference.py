"""The plain reference against the system's plain CPU path at tiny widths:
the one place that imports both."""

import numpy as np
import pytest
import torch

from bench_port.harness import corpus, weights
from bench_port.harness.system import bert_config, clip_config
from bench_port.reference import encoders, retrieval
from bench_port.reference.tokenizers import ClipBPE, WordPiece

from .tiny_root import tiny_config


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    corpus.write_vocabularies([str(d / "bert")], str(d / "clip"))
    return d


@pytest.fixture(scope="module")
def texts():
    text = corpus.Text(np.random.default_rng(7), pool=128)
    return [text.passage(1200) for _ in range(6)] + [text.query(n) for n in (3, 8, 30)]


def test_tokenizers_match_the_system(vocab, texts):
    from mmrag_tpu_torch.models import tokenizer as tok

    port_wp = tok.load_bert_tokenizer(str(vocab / "bert"))
    port_bpe = tok.load_clip_tokenizer(str(vocab / "clip"))
    assert isinstance(port_wp, tok.WordPieceTokenizer)
    assert isinstance(port_bpe, tok.ClipBPETokenizer)
    wp = WordPiece.from_file(str(vocab / "bert" / "vocab.txt"))
    bpe = ClipBPE.from_files(str(vocab / "clip" / "vocab.json"), str(vocab / "clip" / "merges.txt"))
    for t in texts:
        assert wp.ids(t) == port_wp.tokenize_ids(t)
        assert bpe.ids(t) == port_bpe.tokenize_ids(t)
    ids, mask = bpe.encode(texts, 77)
    pids, pmask = port_bpe.encode(texts, 77)
    assert (ids == pids).all() and (mask == pmask).all()
    ids, mask, tt = wp.pairs(texts[-3:], texts[:3], 512)
    pids, pmask, ptt = port_wp.encode_pairs(texts[-3:], texts[:3], 512)
    w = ids.shape[1]
    assert (ids == pids[:, :w]).all() and (tt == ptt[:, :w]).all() and (pmask[:, w:] == 0).all()


@pytest.fixture(scope="module")
def towers():
    cfg = tiny_config()
    models = cfg["models"]
    flat = {role: weights.make_flat(leaves(models[role]), 17 + i, "cpu")
            for i, (role, leaves) in enumerate((("text", weights.bert_leaves),
                                                 ("clip", weights.clip_leaves),
                                                 ("reranker", weights.cross_leaves)))}
    return cfg, flat


def _ids(rng, vocab_size, b, s, lengths):
    ids = rng.integers(1000, vocab_size - 2, (b, s))
    mask = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(np.int64)
    return torch.as_tensor(ids * mask), torch.as_tensor(mask)


def test_encoders_match_the_system(towers):
    from mmrag_tpu_torch.models import bert, clip
    from mmrag_tpu_torch.models.convert import params_from_jax

    cfg, flat = towers
    models = cfg["models"]
    rng = np.random.default_rng(3)
    ids, mask = _ids(rng, 30522, 3, 24, [24, 9, 2])
    bcfg = bert_config(models["text"])
    port = params_from_jax(flat["text"], "minilm", bcfg, device="cpu")
    ref = encoders.to_torch(weights.nest(flat["text"]), "cpu")
    want = encoders.minilm_embed(ref, ids, mask, heads=2)
    got = bert.minilm_embed(port, ids, mask, bcfg)
    assert torch.allclose(got, want, atol=2e-6)

    tt = torch.as_tensor((np.arange(24)[None] > 5).astype(np.int64).repeat(3, 0)) * mask
    port = params_from_jax(flat["reranker"], "cross", bcfg, device="cpu")
    ref = encoders.to_torch(weights.nest(flat["reranker"]), "cpu")
    got = bert.cross_encoder_score(port, ids, mask, tt, bcfg)
    want = encoders.cross_logits(ref, ids, mask, tt, heads=2)
    assert torch.allclose(got, want, atol=2e-5)

    ccfg = clip_config(models["clip"])
    cids = np.zeros((3, 77), np.int64)
    cmask = np.zeros((3, 77), np.int64)
    for i, n in enumerate((77, 10, 3)):
        cids[i, :n] = rng.integers(300, 49000, n)
        cids[i, n - 1] = 49407
        cmask[i, :n] = 1
    port = params_from_jax(flat["clip"], "clip", ccfg, device="cpu")
    ref = encoders.to_torch(weights.nest(flat["clip"]), "cpu")
    got = bert.l2_normalize(clip.clip_text_features(port, torch.as_tensor(cids),
                                                    torch.as_tensor(cmask), ccfg))
    want = encoders.clip_text_embed(ref, torch.as_tensor(cids), torch.as_tensor(cmask),
                                    heads=models["clip"]["text_config"]["num_attention_heads"])
    assert torch.allclose(got, want, atol=2e-6)


def test_fusion_matches_the_system():
    from mmrag_tpu_torch.ops.fusion import fuse_results
    from mmrag_tpu_torch.storage.records import RetrievedHit

    rng = np.random.default_rng(5)
    text = [{"chunk_id": f"t{i}", "score": float(s), "rerank_score": float(r) if i < 8 else None}
            for i, (s, r) in enumerate(zip(rng.random(50), rng.normal(size=50)))]
    text = retrieval.resort(text)
    images = [{"chunk_id": f"i{i}", "score": float(s)} for i, s in enumerate(rng.random(12))]

    def hit(h, modality):
        return RetrievedHit(chunk_id=h["chunk_id"], document_id="d", user_id="u",
                            modality=modality, score=h["score"],
                            rerank_score=h.get("rerank_score"))

    got = fuse_results([hit(h, "text") for h in text], [hit(h, "image") for h in images], 4)
    want = retrieval.fuse(text, images, 4)
    assert [h.chunk_id for h in got] == [h["chunk_id"] for h in want]
    assert [h.combined_score for h in got] == [h["combined_score"] for h in want]


def test_masked_topk_matches_the_system():
    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.storage.records import VectorRow

    rng = np.random.default_rng(8)
    rows = rng.standard_normal((3000, 32)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    users = [f"u{i % 3}" for i in range(3000)]
    docs = [f"d{i % 7}" for i in range(3000)]
    index = VectorIndex(32, dtype="float32", device="cpu")
    index.upsert([VectorRow(chunk_id=f"c{i}", user_id=u, document_id=d, modality="text",
                            embedding=r) for i, (u, d, r) in enumerate(zip(users, docs, rows))])
    q = rng.standard_normal((2, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got = index.search_batch_multi(q, ["u1", "u2"], 20, [None, "d3"])
    for qi, (u, d) in enumerate((("u1", None), ("u2", "d3"))):
        keep = np.asarray(users) == u
        if d:
            keep &= np.asarray(docs) == d
        scores = retrieval.masked_scores(torch.as_tensor(q[qi]), torch.as_tensor(rows),
                                         torch.as_tensor(keep))
        top = torch.topk(scores, 20)
        assert [c for c, _ in got[qi]] == [f"c{j}" for j in top.indices.tolist()]
        assert np.allclose([s for _, s in got[qi]], top.values.numpy(), atol=1e-6)
