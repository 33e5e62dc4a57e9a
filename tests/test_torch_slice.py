"""The port's chat query path against the JAX package's, end to end.

A JAX ``RagEngine`` and the port's ``RagEngine`` (device cpu) load the same
``WEIGHTS_DIR/<model>/model.npz`` (written here by
``mmrag_tpu.models.convert.save_params``) and the same settings, ingest the
same text nodes for two tenants and the same seeded images, and must return
the same final-4 ids in the same order, scores within 1e-4, from
``retrieve`` and ``retrieve_batch`` — the pattern of
``tests/test_e2e_reference_parity.py:317``. Small widths, f32. The same holds
with ``TPU_TOPK_BACKEND=ivf`` and ``TPU_INDEX_DTYPE=pq`` (the literal
IVF_PQ: a partitioned, product-quantized text index, refined exactly on the
host), before and after an append tail.
"""

import os

import jax
import numpy as np
import pytest
import torch

from mmrag_tpu.models import bert as jbert
from mmrag_tpu.models import clip as jclip
from mmrag_tpu.models import convert as jconvert
from mmrag_tpu_torch.models import bert as tbert
from mmrag_tpu_torch.models import clip as tclip

_BERT = dict(vocab_size=30522, hidden_size=64, num_layers=2, num_heads=2,
             intermediate_size=128, max_position=128)
_VISION = dict(image_size=224, patch_size=32, hidden_size=64, num_layers=2, num_heads=2,
               intermediate_size=128)
_TEXT = dict(vocab_size=49408, hidden_size=64, num_layers=2, num_heads=2,
             intermediate_size=128, max_position=77)

QUERIES = [
    ("u1", "posture risk assessment with a camera", None),
    ("u2", "warehouse worker lifting boxes", None),
    ("u1", "model accuracy on the benchmark", "doc-u1-1"),
    ("u2", "architecture diagram of the retrieval pipeline", None),
    ("u1", "unknown tenant filter", "doc-never-seen"),
]

_WORDS = (
    "posture risk assessment camera vision model accuracy warehouse worker lifting box "
    "pipeline retrieval architecture diagram chart results learning dataset sensor "
    "ergonomics injury benchmark latency index embedding query document image"
).split()


def _nodes(tenant, n, rng):
    out = []
    for i in range(n):
        words = rng.choice(_WORDS, size=int(rng.integers(8, 40)))
        out.append({"id": f"{tenant}-c{i}", "text": " ".join(words),
                    "metadata": {"document_id": f"doc-{tenant}-{i % 3}", "page": i % 5}})
    return out


def _write_weights(root):
    from mmrag_tpu.models.runtime import _sanitize

    bcfg = jbert.BertConfig(**_BERT)
    ccfg = jclip.CLIPConfig(vision=jclip.CLIPVisionConfig(**_VISION),
                            text=jclip.CLIPTextConfig(**_TEXT), projection_dim=32)
    minilm = jbert.init_bert_params(jax.random.PRNGKey(0), bcfg)
    cross = jbert.init_cross_encoder_params(jax.random.PRNGKey(2), bcfg)
    # spread the rerank logits: random-init logits sit ~1e-5 apart, where any
    # f32 reordering of a sum swaps near-tied candidates
    cross["classifier"]["kernel"] = cross["classifier"]["kernel"] * 50.0
    clip_p = jclip.init_clip_params(jax.random.PRNGKey(1), ccfg)
    for model_id, params in (
        ("sentence-transformers/all-MiniLM-L6-v2", minilm),
        ("cross-encoder/ms-marco-MiniLM-L-6-v2", cross),
        ("openai/clip-vit-base-patch32", clip_p),
    ):
        jconvert.save_params(params, os.path.join(root, _sanitize(model_id)), "model")
    return bcfg, ccfg


def _build_engines(td, extra_env):
    from mmrag_tpu.models.runtime import EncoderRuntime as JRuntime
    from mmrag_tpu.rag import index_build as jib
    from mmrag_tpu.rag.engine import RagEngine as JEngine
    from mmrag_tpu.settings import load_settings as jload
    from mmrag_tpu.storage.records import Chunk as JChunk, VectorRow as JRow
    from mmrag_tpu_torch.models.runtime import EncoderRuntime as TRuntime
    from mmrag_tpu_torch.rag import index_build as tib
    from mmrag_tpu_torch.rag.engine import RagEngine as TEngine
    from mmrag_tpu_torch.settings import load_settings as tload
    from mmrag_tpu_torch.storage.records import Chunk as TChunk, VectorRow as TRow

    weights = str(td / "weights")
    bcfg, ccfg = _write_weights(weights)
    common = {
        "WEIGHTS_DIR": weights,
        "TPU_COMPUTE_DTYPE": "float32",
        "TPU_INDEX_DTYPE": "float32",
        "TPU_MICROBATCH_WINDOW_MS": "0",
        "TPU_DATA_PARALLEL": "off",
        "TPU_INDEX_JOURNAL": "0",
        "TPU_TEXT_SEQ_BUCKETS": "16,32,64",
        "TPU_TEXT_BATCH_BUCKETS": "8,32",
        "TPU_RERANK_SEQ_LEN": "64",
        **extra_env,
    }
    stacks = {}
    rng_nodes = np.random.default_rng(0)
    nodes = {"u1": _nodes("u1", 24, rng_nodes), "u2": _nodes("u2", 16, rng_nodes)}
    img_rng = np.random.default_rng(1)
    images = [img_rng.integers(0, 256, (224, 224, 3), dtype=np.uint8) for _ in range(6)]
    for name, load, Runtime, Engine, ib, Row, Chunk, rt_kw in (
        ("jax", jload, JRuntime, JEngine, jib, JRow, JChunk, {"bert_cfg": bcfg, "clip_cfg": ccfg}),
        ("torch", tload, TRuntime, TEngine, tib, TRow, TChunk,
         {"bert_cfg": tbert.BertConfig(**_BERT), "device": "cpu",
          "clip_cfg": tclip.CLIPConfig(vision=tclip.CLIPVisionConfig(**_VISION),
                                       text=tclip.CLIPTextConfig(**_TEXT), projection_dim=32)}),
    ):
        env = dict(common, TPU_INDEX_DIR=str(td / name / "index"),
                   NOTES_DB_PATH=str(td / name / "notes.db"))
        cfg = load(env)
        runtime = Runtime(cfg, **rt_kw)
        engine = Engine(cfg, runtime)
        for tenant, tnodes in nodes.items():
            ib.index_text_nodes(tenant, tnodes, engine)
        emb = runtime.embed_images_batch(images)
        for tenant, sel in (("u1", range(0, 4)), ("u2", range(4, 6))):
            rows = [Row(chunk_id=f"img-{i}", user_id=tenant, document_id=f"doc-{tenant}-1",
                        modality="image", embedding=emb[i]) for i in sel]
            chunks = [Chunk(chunk_id=f"img-{i}", document_id=f"doc-{tenant}-1", user_id=tenant,
                            modality="image", media_path=f"/media/img-{i}.png") for i in sel]
            ib.index_image_rows(tenant, rows, chunks, engine)
        stacks[name] = engine
    return stacks


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    stacks = _build_engines(tmp_path_factory.mktemp("slice"), {})
    yield stacks
    for engine in stacks.values():
        engine.close()


@pytest.fixture(scope="module")
def engines_int8(tmp_path_factory):
    """Both engines with ``TPU_ENCODER_QUANT=int8``. The JAX package engages
    its q8 kernels only where its fused kernels do; on the CPU that takes
    ``MMRAG_ATTN_IMPL=fused`` (interpret mode), set while it ingests here and
    in every int8 test (``fused_jax``)."""

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRAG_ATTN_IMPL", "fused")
        stacks = _build_engines(tmp_path_factory.mktemp("slice_int8"),
                                {"TPU_ENCODER_QUANT": "int8"})
    yield stacks
    for engine in stacks.values():
        engine.close()


@pytest.fixture()
def fused_jax(monkeypatch):
    monkeypatch.setenv("MMRAG_ATTN_IMPL", "fused")


def _clear():
    from mmrag_tpu.cache import clear_all_caches as jclear
    from mmrag_tpu_torch.cache import clear_all_caches as tclear

    jclear()
    tclear()


@pytest.fixture(autouse=True)
def _clear_port_caches():
    _clear()
    yield
    _clear()


def _assert_same(got, want):
    assert [h["chunk_id"] for h in got["results"]] == [h["chunk_id"] for h in want["results"]]
    for key in ("results", "text", "images"):
        gs = [h["score"] for h in got[key]]
        ws = [h["score"] for h in want[key]]
        assert [h["chunk_id"] for h in got[key]][:8] == [h["chunk_id"] for h in want[key]][:8]
        np.testing.assert_allclose(gs, ws, atol=1e-4)
    gr = [h["rerank_score"] for h in got["text"] if h["rerank_score"] is not None]
    wr = [h["rerank_score"] for h in want["text"] if h["rerank_score"] is not None]
    np.testing.assert_allclose(gr, wr, atol=1e-4)


@pytest.mark.parametrize("item", QUERIES, ids=[q for _, q, _ in QUERIES])
def test_retrieve_matches_jax(engines, item):
    from mmrag_tpu.rag import retrieve as jrv
    from mmrag_tpu_torch.rag import retrieve as trv

    user, query, doc = item
    want = jrv.retrieve(user, query, engines["jax"], doc)
    got = trv.retrieve(user, query, engines["torch"], doc)
    _assert_same(got, want)


def test_retrieve_batch_matches_jax(engines):
    from mmrag_tpu.rag import retrieve as jrv
    from mmrag_tpu_torch.rag import retrieve as trv

    want = jrv.retrieve_batch(QUERIES, engines["jax"])
    got = trv.retrieve_batch(QUERIES, engines["torch"])
    assert len(got) == len(want) == len(QUERIES)
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_tenant_isolation_and_document_filter(engines):
    from mmrag_tpu_torch.rag import retrieve as trv

    payloads = trv.retrieve_batch(QUERIES, engines["torch"])
    for (user, _, doc), payload in zip(QUERIES, payloads):
        hits = payload["results"] + payload["text"] + payload["images"]
        assert all(h["user_id"] == user for h in hits)
        if doc is not None:
            assert all(h["document_id"] == doc for h in hits)
    assert payloads[0]["results"] and payloads[1]["results"]
    assert payloads[4]["results"] == []  # a document the index never saw
    # a tenant with no rows sees nothing
    empty = trv.retrieve("nobody", "posture", engines["torch"])
    assert empty["results"] == [] and empty["text"] == [] and empty["images"] == []


def test_delete_document_hides_its_rows(engines):
    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.storage.records import VectorRow

    index = VectorIndex(dim=8, dtype="float32", device="cpu")
    rng = np.random.default_rng(0)
    rows = [VectorRow(chunk_id=f"c{i}", user_id="u", document_id=f"d{i % 2}", modality="text",
                      embedding=rng.standard_normal(8).astype(np.float32)) for i in range(6)]
    index.upsert(rows)
    assert index.delete_document("d0") == 3
    hits = index.search(rows[0].embedding, "u", 6)
    assert {cid for cid, _ in hits} == {"c1", "c3", "c5"}
    # delete-then-add upsert keeps one live row per chunk id
    index.upsert([VectorRow(chunk_id="c1", user_id="u", document_id="d1", modality="text",
                            embedding=rows[1].embedding)])
    assert len(index) == 3
    assert index._capacity == 4096


# The W8A8 chat path. Tolerance 1e-3 on cosine and rerank scores: the port's
# q8 towers agree with the JAX package's within 1e-3 on features
# (test_torch_models.py); the ids and their order must be identical.


def _assert_same_int8(got, want):
    for key in ("results", "text", "images"):
        assert [h["chunk_id"] for h in got[key]] == [h["chunk_id"] for h in want[key]]
        np.testing.assert_allclose([h["score"] for h in got[key]],
                                   [h["score"] for h in want[key]], atol=1e-3)
    gr = [h["rerank_score"] for h in got["text"] if h["rerank_score"] is not None]
    wr = [h["rerank_score"] for h in want["text"] if h["rerank_score"] is not None]
    np.testing.assert_allclose(gr, wr, atol=1e-3)


def test_int8_engines_run_the_q8_towers(engines_int8):
    runtime = engines_int8["torch"].runtime
    assert runtime.quant
    for q8 in (runtime._ensure_minilm_q8(), runtime._ensure_cross_q8(),
               runtime._ensure_clip_q8()):
        assert q8["layers"][0]["qkv"]["q"].dtype == torch.int8


@pytest.mark.parametrize("item", QUERIES[:3], ids=[q for _, q, _ in QUERIES[:3]])
def test_retrieve_int8_matches_jax(engines_int8, fused_jax, item):
    from mmrag_tpu.rag import retrieve as jrv
    from mmrag_tpu_torch.rag import retrieve as trv

    user, query, doc = item
    want = jrv.retrieve(user, query, engines_int8["jax"], doc)
    got = trv.retrieve(user, query, engines_int8["torch"], doc)
    assert got["results"]
    _assert_same_int8(got, want)


def test_retrieve_batch_int8_matches_jax(engines_int8, fused_jax):
    from mmrag_tpu.rag import retrieve as jrv
    from mmrag_tpu_torch.rag import retrieve as trv

    want = jrv.retrieve_batch(QUERIES, engines_int8["jax"])
    got = trv.retrieve_batch(QUERIES, engines_int8["torch"])
    for g, w in zip(got, want):
        _assert_same_int8(g, w)


# The IVF_PQ chat path: TPU_TOPK_BACKEND=ivf + TPU_INDEX_DTYPE=pq with a low
# TPU_IVF_MIN_ROWS, so the text index (40 rows) builds its IVF_PQ layout at
# the first search and the image index (6 rows) stays flat pq. Both refine
# their ADC shortlists to exact cosines, so ids, order and scores are JAX's.


@pytest.fixture(scope="module")
def engines_ivf_pq(tmp_path_factory):
    stacks = _build_engines(tmp_path_factory.mktemp("slice_ivf_pq"), {
        "TPU_TOPK_BACKEND": "ivf", "TPU_INDEX_DTYPE": "pq", "TPU_IVF_MIN_ROWS": "16"})
    for engine in stacks.values():  # build at the first search, deterministically
        engine.text_index.ivf_build_async = engine.image_index.ivf_build_async = False
    yield stacks
    for engine in stacks.values():
        engine.close()


def test_ivf_pq_slice_matches_jax_before_and_after_a_tail(engines_ivf_pq):
    from mmrag_tpu.rag import index_build as jib
    from mmrag_tpu.rag import retrieve as jrv
    from mmrag_tpu_torch.rag import index_build as tib
    from mmrag_tpu_torch.rag import retrieve as trv

    want = jrv.retrieve_batch(QUERIES, engines_ivf_pq["jax"])
    got = trv.retrieve_batch(QUERIES, engines_ivf_pq["torch"])
    for name in ("jax", "torch"):
        text = engines_ivf_pq[name].text_index
        assert text.is_pq and text._ivf is not None and text._ivf.is_pq
        assert engines_ivf_pq[name].image_index.is_pq
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert got[0]["results"] and got[4]["results"] == []
    # an append tail after the build: scored by the flat ADC path, merged
    tail = _nodes("u1", 30, np.random.default_rng(7))[24:]
    tib.index_text_nodes("u1", tail, engines_ivf_pq["torch"])
    jib.index_text_nodes("u1", tail, engines_ivf_pq["jax"])
    _clear()
    text = engines_ivf_pq["torch"].text_index
    assert text._size > text._ivf.built_rows
    want = jrv.retrieve_batch(QUERIES, engines_ivf_pq["jax"])
    got = trv.retrieve_batch(QUERIES, engines_ivf_pq["torch"])
    for g, w in zip(got, want):
        _assert_same(g, w)
    single = trv.retrieve("u1", QUERIES[0][1], engines_ivf_pq["torch"])
    _assert_same(single, jrv.retrieve("u1", QUERIES[0][1], engines_ivf_pq["jax"]))
