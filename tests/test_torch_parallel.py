"""The port's mesh, sharded top-k (X7) and data-parallel encoders against the
JAX package's on its 8 virtual CPU devices: the serving cases of
``tests/test_parallel.py``. The port's side runs on an 8-shard mesh over
``cpu`` (one device listed eight times). Ids and their order are identical,
scores within 1e-6, embeddings within 1e-4; a ragged batch or corpus raises
in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.parallel import mesh as jmesh
from mmrag_tpu.parallel import sharded_index as jsi
from mmrag_tpu_torch.parallel import mesh as tmesh
from mmrag_tpu_torch.parallel import sharded_index as tsi


@pytest.fixture(scope="module")
def meshes():
    return jmesh.build_mesh(model_parallel=1), tmesh.build_mesh(devices=["cpu"] * 8)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_build_mesh_shapes():
    mesh = tmesh.build_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {tmesh.DATA_AXIS: 8, tmesh.MODEL_AXIS: 1}
    assert mesh.distinct == (torch.device("cpu"),)
    mesh2 = tmesh.build_mesh(devices=["cpu", "meta"] * 2)
    assert mesh2.distinct == (torch.device("cpu"), torch.device("meta"))
    assert tmesh.build_mesh(n_devices=3, devices=["cpu"] * 8).n_data == 3
    with pytest.raises(ValueError):
        tmesh.build_mesh(devices=[])


def test_placement_helpers():
    mesh = tmesh.build_mesh(devices=["cpu"] * 4)
    x = torch.arange(24.0).reshape(8, 3)
    shards = tmesh.row_sharded(mesh, x)
    assert len(shards) == 4 and all(s.shape == (2, 3) for s in shards)
    assert torch.equal(torch.cat(shards), x)
    assert tmesh.batch_sharded is tmesh.row_sharded
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.row_sharded(mesh, x[:7])
    reps = tmesh.replicated(mesh, {"w": x, "n": [x[0]]})
    assert list(reps) == [torch.device("cpu")] and reps[torch.device("cpu")]["w"] is x


def test_sharded_rows_reads_and_writes_across_blocks():
    mesh = tmesh.build_mesh(devices=["cpu"] * 4)
    col = tmesh.ShardedRows.full(mesh, (16, 2), 0.0, torch.float32)
    ref = torch.zeros((16, 2))
    vals = torch.arange(20.0).reshape(10, 2)
    col[3:13] = vals
    ref[3:13] = vals
    col[torch.tensor([0, 5, 15])] = -1.0
    ref[torch.tensor([0, 5, 15])] = -1.0
    col[14:16] = 7.0
    ref[14:16] = 7.0
    assert col.shape == (16, 2) and torch.equal(col[0:16], ref)
    assert torch.equal(col[2:9], ref[2:9]) and col[5:5].shape == (0, 2)
    assert torch.equal(torch.cat(col.shards), ref)
    with pytest.raises(ValueError):
        tmesh.ShardedRows.full(mesh, (10,), 0, torch.int32)


def test_sharded_topk_matches_jax_and_single_device(rng, meshes):
    from mmrag_tpu_torch.ops.topk import cosine_topk

    jm, tm = meshes
    n, d, k = 1024, 64, 7
    corpus = _unit(rng, n, d)
    queries = _unit(rng, 3, d) * 0.5 + corpus[:3] * 0.5
    mask = rng.random(n) > 0.25
    js, ji = jsi.sharded_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), k,
                              jm)
    ts, ti = tsi.sharded_topk(torch.from_numpy(queries), torch.from_numpy(corpus),
                              torch.from_numpy(mask), k, tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    ws, wi = cosine_topk(torch.from_numpy(queries), torch.from_numpy(corpus),
                         torch.from_numpy(mask), k)
    np.testing.assert_array_equal(ti.numpy(), wi.numpy())


def test_sharded_topk_exact_ties_merge_in_jax_order(meshes):
    """Equal scores on several shards: the merge keeps ``lax.top_k``'s order
    (shard-major candidates, the lower position first), as JAX's does."""

    jm, tm = meshes
    n, d, k = 64, 8, 12
    base = np.zeros((n, d), np.float32)
    base[:, 0] = 1.0  # every row the same: every score ties
    base[5, :2] = [0.6, 0.8]
    base[40, :2] = [0.6, 0.8]
    queries = np.zeros((2, d), np.float32)
    queries[:, 0] = 1.0
    mask = np.ones(n, bool)
    mask[[3, 17, 60]] = False
    js, ji = jsi.sharded_topk(jnp.asarray(queries), jnp.asarray(base), jnp.asarray(mask), k, jm)
    ts, ti = tsi.sharded_topk(torch.from_numpy(queries), torch.from_numpy(base),
                              torch.from_numpy(mask), k, tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_sharded_topk_pads_past_the_shard_rows(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(3)
    corpus = _unit(rng, 16, 8)  # 2 rows a shard, k 20: fillers past the rows
    q = corpus[:2]
    mask = np.ones(16, bool)
    js, ji = jsi.sharded_topk(jnp.asarray(q), jnp.asarray(corpus), jnp.asarray(mask), 20, jm)
    ts, ti = tsi.sharded_topk(torch.from_numpy(q), torch.from_numpy(corpus),
                              torch.from_numpy(mask), 20, tm)
    assert ts.shape == (2, 20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_sharded_topk_rejects_ragged_rows(rng, meshes):
    jm, tm = meshes
    corpus = _unit(rng, 1001, 16)
    mask = np.ones(1001, bool)
    with pytest.raises(ValueError):
        jsi.sharded_topk(jnp.asarray(corpus[:2]), jnp.asarray(corpus), jnp.asarray(mask), 5, jm)
    with pytest.raises(ValueError, match="not divisible"):
        tsi.sharded_topk(torch.from_numpy(corpus[:2]), torch.from_numpy(corpus),
                         torch.from_numpy(mask), 5, tm)


def test_sharded_topk_int8_matches_jax(rng, meshes):
    from mmrag_tpu.ops.topk import quantize_rows_int8 as jquant
    from mmrag_tpu_torch.ops.topk import quantize_rows_int8

    jm, tm = meshes
    corpus = _unit(rng, 64 * 8, 64)
    cq, cs = quantize_rows_int8(torch.from_numpy(corpus))
    jq, jscale = jquant(jnp.asarray(corpus))
    np.testing.assert_array_equal(cq.numpy(), np.asarray(jq))
    mask = rng.random(512) > 0.1
    q = corpus[:3]
    js, ji = jsi.sharded_topk_int8(jnp.asarray(q), jq, jscale, jnp.asarray(mask), k=5, mesh=jm)
    ts, ti = tsi.sharded_topk_int8(torch.from_numpy(q), cq, cs, torch.from_numpy(mask), 5, tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    assert (ti.numpy()[:, 0] == np.arange(3))[mask[:3]].all()


def test_sharded_search_fns_match_jax_per_query_tenants(rng, meshes):
    """The index's sharded searches (dense, int8 and pq) with per-query
    tenant and document predicates evaluated per shard."""

    from mmrag_tpu.ops import pq as jpq

    jm, tm = meshes
    n, d = 1024, 64
    corpus = _unit(rng, n, d)
    users = rng.integers(0, 3, n).astype(np.int32)
    docs = rng.integers(0, 4, n).astype(np.int32)
    live = rng.random(n) > 0.1
    q = corpus[[1, 2, 3, 4]] + 0.1 * _unit(rng, 4, d)
    uids = np.array([0, 1, 2, -2], np.int32)
    dids = np.array([-1, 2, -1, -1], np.int32)
    jcols = [jnp.asarray(a) for a in (users, docs, live)]
    tcols = [tmesh.row_sharded(tm, a) for a in (users, docs, live)]
    jhead = (jnp.asarray(q), jnp.asarray(uids), jnp.asarray(dids))
    thead = (torch.from_numpy(q), torch.from_numpy(uids), torch.from_numpy(dids))

    js, ji = jsi.sharded_search_fn(jm, 10)(*jhead, jnp.asarray(corpus), *jcols)
    ts, ti = tsi.sharded_search_fn(tm, 10)(*thead, tmesh.row_sharded(tm, corpus), *tcols)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)

    books = jpq.train_pq(jnp.asarray(corpus), m=8)
    codes = np.asarray(jpq.pq_encode(jnp.asarray(corpus), books))
    js, ji = jsi.sharded_search_pq_fn(jm, 16)(*jhead, books, jnp.asarray(codes), *jcols)
    ts, ti = tsi.sharded_search_pq_fn(tm, 16)(
        *thead, torch.from_numpy(np.array(books)), tmesh.row_sharded(tm, codes), *tcols)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_merge_slices_host_matches_jax(rng):
    scores = -np.sort(-rng.standard_normal((3, 4, 6)).astype(np.float32), axis=-1)
    scores[1, 0, 0] = scores[0, 0, 0]  # a tie across slices: the smaller id wins
    ids = rng.permutation(72).reshape(3, 4, 6).astype(np.int64)
    js, ji = jsi.merge_slices_host(scores, ids, 6)
    ts, ti = tsi.merge_slices_host(scores, ids, 6)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)


def test_dp_minilm_embed_matches_jax(rng, meshes):
    from mmrag_tpu.models import bert as jbert
    from mmrag_tpu.parallel.inference import dp_minilm_embed as jdp
    from mmrag_tpu_torch.models.convert import flatten_params, params_from_jax
    from mmrag_tpu_torch.parallel.inference import dp_minilm_embed

    from tiny import TINY_BERT as JBERT
    from tiny_torch import TINY_BERT

    jm, tm = meshes
    jp = jbert.init_bert_params(jax.random.PRNGKey(0), JBERT)
    tp = params_from_jax(flatten_params(jax.tree_util.tree_map(np.asarray, jp)), "minilm",
                         TINY_BERT)
    ids = rng.integers(5, 30000, (16, 32)).astype(np.int32)
    mask = (np.arange(32)[None, :] < rng.integers(4, 33, 16)[:, None]).astype(np.int32)
    want = np.asarray(jdp(jm, JBERT, compute_dtype=jnp.float32)(jp, ids, mask))
    got = dp_minilm_embed(tm, TINY_BERT)(tp, ids, mask)
    assert got.shape == (16, TINY_BERT.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_dp_embed_rejects_ragged_batch(meshes):
    from mmrag_tpu_torch.parallel.inference import dp_minilm_embed

    from tiny_torch import TINY_BERT

    _, tm = meshes
    with pytest.raises(ValueError, match="not divisible"):
        dp_minilm_embed(tm, TINY_BERT)({}, np.zeros((5, 8), np.int32),
                                       np.ones((5, 8), np.int32))


def test_dp_clip_image_embed_matches_jax(rng, meshes):
    """uint8 HWC crops of a 256 canvas in, X2 and the vision tower per shard,
    L2-normalized rows out: the JAX package's ``dp_clip_image_embed``."""

    from mmrag_tpu.models import clip as jclip
    from mmrag_tpu.parallel.inference import dp_clip_image_embed as jdp
    from mmrag_tpu_torch.models.convert import flatten_params, params_from_jax
    from mmrag_tpu_torch.parallel.inference import dp_clip_image_embed

    from tiny import TINY_CLIP as JCLIP
    from tiny_torch import TINY_CLIP

    jm, tm = meshes
    jp = jclip.init_clip_params(jax.random.PRNGKey(1), JCLIP)
    tp = params_from_jax(flatten_params(jax.tree_util.tree_map(np.asarray, jp)), "clip",
                         TINY_CLIP)
    images = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    want = np.asarray(jdp(jm, JCLIP, compute_dtype=jnp.float32)(jp, jnp.asarray(images)))
    got = dp_clip_image_embed(tm, TINY_CLIP)(tp, images).numpy()
    assert got.shape == (8, TINY_CLIP.projection_dim)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("setting,count,want", [
    ("auto", 8, 8), ("auto", 1, None), ("auto", 0, None), ("off", 8, None),
    ("2", 8, 2), ("16", 4, 4), ("1", 8, None), ("0", 8, None)])
def test_engine_data_mesh_settings(setting, count, want, monkeypatch):
    """``TPU_DATA_PARALLEL`` counts distinct CUDA devices, as the JAX package
    counts devices; below 2 the engine stays single-device. The mesh is
    cached per count."""

    from mmrag_tpu.settings import load_settings as jload
    from mmrag_tpu_torch.settings import load_settings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(tmesh, "_engine_meshes", {})
    cfg = load_settings({"TPU_DATA_PARALLEL": setting})
    assert cfg.tpu.data_parallel == jload({"TPU_DATA_PARALLEL": setting}).tpu.data_parallel
    mesh = tmesh.engine_data_mesh(cfg)
    if want is None:
        assert mesh is None
        return
    assert mesh.n_data == want
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(want))
    assert tmesh.engine_data_mesh(cfg) is mesh


def test_data_parallel_setting_is_validated():
    from mmrag_tpu.settings import SettingsError as JError
    from mmrag_tpu.settings import load_settings as jload
    from mmrag_tpu_torch.settings import SettingsError, load_settings

    for raw in ("AUTO", "false", "no", "3"):
        assert load_settings({"TPU_DATA_PARALLEL": raw}).tpu.data_parallel == \
            jload({"TPU_DATA_PARALLEL": raw}).tpu.data_parallel
    with pytest.raises(SettingsError):
        load_settings({"TPU_DATA_PARALLEL": "many"})
    with pytest.raises(JError):
        jload({"TPU_DATA_PARALLEL": "many"})
    # the mesh has one axis, so its axis names are not read
    cfg = load_settings({"TPU_MESH_DATA_AXIS": "rows", "TPU_MESH_MODEL_AXIS": "tp"})
    assert not hasattr(cfg.tpu, "mesh_data_axis") and not hasattr(cfg.tpu, "mesh_model_axis")
