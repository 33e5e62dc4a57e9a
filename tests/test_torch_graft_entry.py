"""The port's flagship forward and multi-device dry run
(``mmrag_tpu_torch/graft_entry.py``) against ``__graft_entry__.py`` on the
CPU.

``entry()``'s forward runs on JAX's own ``entry()`` params, carried across
with ``params_from_jax``, in f32 on both sides (JAX's forward is fixed to
bf16, so its f32 twin is built from ``mmrag_tpu.models.clip``), within the
port's CLIP-tower parity tolerance (atol 1e-4, ``tests/test_torch_models.py``).
``dryrun_multichip(8, devices=["cpu"] * 8)`` makes JAX's assertions; its pq
and ivf hits equal the JAX package's ``VectorIndex`` on its 8 CPU devices
over the same ``default_rng(0)`` rows (ids equal, scores within 1e-5), and
its sharded CLIP step, from JAX's carried-across initial params, gives JAX's
loss within 1e-5 relative (the training suite's tolerance).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from mmrag_tpu.index.store import VectorIndex as JIndex
from mmrag_tpu.models import bert as jbert
from mmrag_tpu.models import clip as jclip
from mmrag_tpu.models import convert as jconvert
from mmrag_tpu.ops.images import preprocess_batch as jpreprocess
from mmrag_tpu.parallel import training as jtr
from mmrag_tpu.parallel.mesh import build_mesh as jbuild_mesh
from mmrag_tpu.storage.records import VectorRow as JRow
from mmrag_tpu_torch import graft_entry
from mmrag_tpu_torch.cache import clear_all_caches
from mmrag_tpu_torch.models import convert as tconvert
from mmrag_tpu_torch.parallel.mesh import build_mesh

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # the port's CLIP-tower parity tolerance
N = 8  # JAX's CPU devices (tests/conftest.py)


@pytest.fixture(autouse=True)
def _clear_port_caches():
    clear_all_caches()
    yield
    clear_all_caches()


@pytest.fixture(scope="module")
def jgraft():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_jax", os.path.join(_REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    os.environ.pop("TPU_REAL_WEIGHTS_DIR", None)
    old = os.environ.get("HF_HOME")
    os.environ["HF_HOME"] = str(tmp_path_factory.mktemp("no_hf"))
    try:
        return graft_entry.dryrun_multichip(N, devices=["cpu"] * N)
    finally:
        if old is None:
            os.environ.pop("HF_HOME")
        else:
            os.environ["HF_HOME"] = old


def _jax_draws():
    """JAX's dry run's rows and batch, drawn by its own lines
    (``__graft_entry__.py:185-236``)."""

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((64, 64)).astype(np.float32)
    cents = rng.standard_normal((8, 64)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    cl = (cents[rng.integers(0, 8, 1024)]
          + 0.2 * rng.standard_normal((1024, 64))).astype(np.float32)
    b = max(N, 4)
    images = np.asarray(rng.standard_normal((b, 32, 32, 3)), np.float32)
    ids = np.asarray(rng.integers(1, 500, (b, 16)), np.int32)
    return vecs, cl, (images, ids, np.ones((b, 16), np.int32))


def _jax_rows(mat, prefix):
    return [JRow(chunk_id=f"{prefix}{i}", user_id="u1", document_id="d1", modality="text",
                 embedding=mat[i]) for i in range(len(mat))]


def _same_hits(got, want, atol=1e-5):
    assert [[c for c, _ in q] for q in got] == [[c for c, _ in q] for q in want]
    np.testing.assert_allclose([s for q in got for _, s in q], [s for q in want for _, s in q],
                               rtol=0, atol=atol)


def test_entry_forward_matches_jax_in_f32(jgraft):
    _, (jparams, jimages) = jgraft.entry()
    forward, (params, images) = graft_entry.entry(device="cpu")
    del params  # the port's own seeded tree: the comparison runs on JAX's
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))
    assert images.shape == (8, 224, 224, 3) and images.dtype == torch.uint8
    cfg = jclip.CLIP_VIT_B32
    want = np.asarray(jbert.l2_normalize(
        jclip.clip_image_features(jparams, jpreprocess(jimages), cfg)))
    carried = tconvert.params_from_jax(jconvert.flatten_params(jax.device_get(jparams)), "clip")
    got = forward(carried, images).numpy()
    assert got.shape == (8, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_dryrun_multichip_makes_jax_assertions(report):
    assert report["n_devices"] == N and report["devices"] == ["cpu"]
    assert report["final_ids"] and all(c.startswith("doc1-c") for c in report["final_ids"])
    assert report["pq_hits"][0][0][0] == "c0"
    for dtype in ("float32", "pq"):
        assert report["ivf_hits"][dtype][0][0][0] == "v0"
    assert report["model_parallel"] == 2 and np.isfinite(report["loss"])
    assert report["real_weights"] == [] and not report["reranker_seeded"]
    # on CPU tensors the plain versions run: no kernel launch is counted
    assert set(report["launches"]) == {"engine", "pq", "ivf float32", "ivf pq", "train"}
    assert not any(report["launches"].values())


def test_dryrun_draws_jax_rows_in_jax_order():
    vecs, cl, batch = _jax_draws()
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(graft_entry.pq_rows(rng), vecs)
    np.testing.assert_array_equal(graft_entry.ivf_rows(rng), cl)
    for got, want in zip(graft_entry.clip_batch(rng, max(N, 4)), batch):
        np.testing.assert_array_equal(got, want)


def test_dryrun_pq_and_ivf_hits_match_jax(report):
    vecs, cl, _ = _jax_draws()
    pq_ix = JIndex(dim=64, dtype="pq", mesh=jbuild_mesh(model_parallel=1))
    pq_ix.upsert(_jax_rows(vecs, "c"))
    _same_hits(report["pq_hits"], pq_ix.search_batch(vecs[:2], "u1", k=4))
    for ivf_dtype in ("float32", "pq"):
        ivf_ix = JIndex(dim=64, dtype=ivf_dtype, backend="ivf",
                        mesh=jbuild_mesh(model_parallel=1), ivf_min_rows=10)
        ivf_ix.ivf_build_async = False
        ivf_ix.upsert(_jax_rows(cl, "v"))
        _same_hits(report["ivf_hits"][ivf_dtype], ivf_ix.search_batch(cl[:2], "u1", k=4))


def test_sharded_clip_step_loss_matches_jax():
    _, _, batch = _jax_draws()
    cfg = jclip.CLIPConfig(
        vision=jclip.CLIPVisionConfig(image_size=32, patch_size=16, hidden_size=32,
                                      num_layers=2, num_heads=2, intermediate_size=64),
        text=jclip.CLIPTextConfig(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
                                  intermediate_size=64, max_position=16),
        projection_dim=32,
    )
    jmesh = jbuild_mesh(n_devices=N, model_parallel=2)
    params, opt_state, tx = jtr.train_state_init(jax.random.PRNGKey(0), jmesh, cfg)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    step = jtr.make_train_step(jmesh, tx, cfg)
    _, _, want = step(params, opt_state, *(jax.numpy.asarray(a) for a in batch))
    carried = tconvert.params_from_jax(jconvert.flatten_params(init), "clip",
                                       graft_entry.train_clip_config())
    mesh = build_mesh(N, model_parallel=2, devices=["cpu"] * N)
    got = graft_entry.clip_train_step(mesh, batch, init=carried)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)


def test_dryrun_survives_reranker_only_provisioning(monkeypatch, tmp_path):
    """Only a tiny HF cross-encoder is provisioned: its arch differs from
    the text encoder's config, so the cross-encoder stays seeded and the
    dry run runs to its end (``tests/test_bench_emit.py:361-389``)."""

    import transformers

    torch.manual_seed(2)
    cfg = transformers.BertConfig(
        vocab_size=211, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=96, type_vocab_size=2, num_labels=1)
    src = tmp_path / "real" / "ms-marco-MiniLM-L-6-v2"
    transformers.BertForSequenceClassification(cfg).eval().save_pretrained(src)
    monkeypatch.setenv("TPU_REAL_WEIGHTS_DIR", str(tmp_path / "real"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hf"))
    out = graft_entry.dryrun_multichip(N, devices=["cpu"] * N)
    assert out["real_weights"] == ["reranker"] and out["reranker_seeded"]
    assert out["final_ids"] and np.isfinite(out["loss"])


def test_entry_points_take_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="2 devices asked for"):
        graft_entry.dryrun_multichip(2, devices=["cpu"])
