"""The port's fine-tuning against the JAX package's on the CPU.

The training forwards (``attention_impl="xla"``), the three losses and their
gradients, AdamW steps against ``optax.adamw``, the (data, model) mesh and
its parameter rules, and ``convert.params_to_jax``, at the tiny geometries
of ``tests/test_parallel.py`` (``tests/tiny_train.py``) with seeded numpy
inputs and JAX-initialized weights. Tolerances: losses 1e-6 relative;
gradients 1e-5 of each leaf's max-abs (q, k and v concatenated as the port's
``qkv``); five steps 1e-4 on the loss and 1e-5 on the parameters, except
where JAX's first gradient is below 1e-6 of its leaf's max-abs, where
Adam's step is lr times the gradient's sign and a sign may differ (2 lr);
bf16 3e-3 relative on the loss, set from a run on seeds 0-2 (MiniLM
8.6e-4 / 9.5e-4 / 5.3e-4, the cross-encoder up to 1.0e-5, CLIP 2.2e-7):
JAX's CPU compiler keeps excess precision, dropping some of the bf16 round
trips of the source, and MNR's temperature multiplies the embeddings' 1-2
ulp differences by 20.

Steps that are compared run at JAX's learning rates (``LR``); the "runs and
learns" cases at 1e-3, as ``tests/test_parallel.py``'s. At 1e-3 a few
elements whose gradient changes sign between steps move apart by up to 1e-4
after the second step (Adam divides by a root of a sum that is near 0), so
1e-5 holds only at the real rates.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.models import bert as jbert
from mmrag_tpu.models import clip as jclip
from mmrag_tpu.models import convert as jconv
from mmrag_tpu.parallel import mesh as jmesh
from mmrag_tpu.parallel import training as jtr
from mmrag_tpu_torch.models import bert as tbert
from mmrag_tpu_torch.models import convert as tconv
from mmrag_tpu_torch.parallel import mesh as tmesh
from mmrag_tpu_torch.parallel import training as ttr

from tiny_train import KINDS, TRAIN_BERT, TRAIN_CLIP, train_batch

JBERT = jbert.BertConfig(**dataclasses.asdict(TRAIN_BERT))
JCLIP = jclip.CLIPConfig(vision=jclip.CLIPVisionConfig(**dataclasses.asdict(TRAIN_CLIP.vision)),
                         text=jclip.CLIPTextConfig(**dataclasses.asdict(TRAIN_CLIP.text)),
                         projection_dim=TRAIN_CLIP.projection_dim)
LR = {"clip": 1e-5, "minilm": 2e-5, "cross": 2e-5}  # JAX's train_state_init defaults
# per kind: JAX loss, port loss, JAX config, port config, JAX init, JAX state
# init, JAX make_*_step, port state init, port make_*_step
SPEC = {
    "clip": (jtr.clip_contrastive_loss, ttr.clip_contrastive_loss, JCLIP, TRAIN_CLIP,
             lambda: jclip.init_clip_params(jax.random.PRNGKey(0), JCLIP),
             jtr.train_state_init, jtr.make_train_step,
             ttr.train_state_init, ttr.make_train_step),
    "minilm": (jtr.minilm_mnr_loss, ttr.minilm_mnr_loss, JBERT, TRAIN_BERT,
               lambda: jbert.init_bert_params(jax.random.PRNGKey(0), JBERT),
               jtr.minilm_train_state_init, jtr.make_minilm_train_step,
               ttr.minilm_train_state_init, ttr.make_minilm_train_step),
    "cross": (jtr.cross_encoder_loss, ttr.cross_encoder_loss, JBERT, TRAIN_BERT,
              lambda: jbert.init_cross_encoder_params(jax.random.PRNGKey(1), JBERT),
              jtr.cross_encoder_train_state_init, jtr.make_cross_encoder_train_step,
              ttr.cross_encoder_train_state_init, ttr.make_cross_encoder_train_step),
}
_RNG = {"clip": 0, "minilm": 0, "cross": 1}  # the PRNGKey of each JAX state init


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and the suite runs several
    test processes side by side, whose threads would contend."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_init_cached(kind: str):
    return _np_tree(SPEC[kind][4]())


def _jax_init(kind: str):
    """JAX's initial weights of ``kind`` (numpy), made once."""

    return jax.tree_util.tree_map(np.copy, _jax_init_cached(kind))


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in tconv.flatten_params(tree).items()}


def _port_flat(params, kind: str, grads: bool = False) -> dict:
    """A port tree (or its gradients) in the JAX layout's flat form, with
    q, k and v joined back into ``qkv`` so they are held as one leaf."""

    if grads:
        params = tmesh.map_with_path(
            lambda _, t: tmesh.Sharded([s.grad for s in t.shards], t.dim, t.blocks)
            if isinstance(t, tmesh.Sharded) else t.grad, params)
    return _flat(tmesh.gather_params(params))


def _as_port_layout(flat_jax: dict, kind: str) -> dict:
    """A flat JAX-layout tree in the port's layout (q, k, v concatenated)."""

    return _flat(tconv.params_from_jax(flat_jax, kind))


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(kind: str):
    n_batch = 3 if kind == "clip" else 4  # cfg and compute_dtype follow the batch
    return jax.jit(jax.value_and_grad(SPEC[kind][0]), static_argnums=(n_batch + 1, n_batch + 2))


def _jax_value_and_grad(kind: str, params, batch):
    return _jax_grad_fn(kind)(params, *(jnp.asarray(a) for a in batch), SPEC[kind][2],
                              jnp.float32)


def _port_params(kind: str, jax_params, mesh=None):
    init = tconv.params_from_jax(_flat(_np_tree(jax_params)), kind)
    return SPEC[kind][7](init, mesh, SPEC[kind][3], device="cpu")


def _assert_params(got: dict, want: dict, grad: dict, lr: float, atol: float = 1e-5) -> None:
    for key, w in want.items():
        g = np.abs(grad[key])
        tol = np.where(g < 1e-6 * g.max(), 2 * lr + atol, atol)
        err = np.abs(got[key] - w)
        assert (err <= tol).all(), (key, float(err.max()))


# ---------------------------------------------------------------------------
# convert: logit_scale and the inverse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_params_from_jax_carries_logit_scale_and_params_to_jax_inverts(kind):
    tree = _np_tree(_jax_init(kind))
    port = tconv.params_from_jax(tconv.flatten_params(tree), kind)
    if kind == "clip":
        assert port["logit_scale"].shape == () and port["logit_scale"].dtype == torch.float32
        assert float(port["logit_scale"]) == float(tree["logit_scale"])
    back = tconv.params_to_jax(port, kind)
    want = tconv.flatten_params(tree)
    got = tconv.flatten_params(back)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == np.float32 and np.array_equal(got[key], want[key]), key


def test_jax_package_serves_a_port_finetuned_minilm(tmp_path):
    """A MiniLM fine-tuned by the port, exported with ``params_to_jax`` and
    ``save_params``, loads into the JAX package, whose ``minilm_embed``
    gives the port's embeddings within 1e-5."""

    params, opt, _ = _port_params("minilm", _jax_init("minilm"))
    step = ttr.make_minilm_train_step(None, TRAIN_BERT)
    batch = train_batch("minilm", 8)
    for _ in range(2):
        params, opt, _ = step(params, opt, *batch)
    wdir = str(tmp_path / "sentence-transformers__all-MiniLM-L6-v2")
    tconv.save_params(tconv.params_to_jax(params, "minilm"), wdir, "model")
    jparams = jconv.load_params(wdir, "model")
    ids, mask = batch[0], batch[1]
    embed = jax.jit(jbert.minilm_embed, static_argnums=(3,))
    want = np.asarray(embed(jparams, jnp.asarray(ids), jnp.asarray(mask), JBERT))
    with torch.no_grad():
        for impl in ("xla", "fused"):
            got = tbert.minilm_embed(params, torch.from_numpy(ids), torch.from_numpy(mask),
                                     TRAIN_BERT, attention_impl=impl).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=impl)


# ---------------------------------------------------------------------------
# The losses, their gradients, AdamW steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_gradients_match_jax(kind):
    jparams = _jax_init(kind)
    batch = train_batch(kind, 8)
    want_loss, want_grad = _jax_value_and_grad(kind, jparams, batch)
    params, _, _ = _port_params(kind, jparams)
    loss = SPEC[kind][1](params, *(torch.from_numpy(a) for a in batch), SPEC[kind][3])
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    want = _as_port_layout(_flat(_np_tree(want_grad)), kind)
    got = _port_flat(params, kind, grads=True)
    assert set(got) == set(want)
    for key, w in want.items():
        scale = np.abs(w).max()
        assert np.abs(got[key] - w).max() <= 1e-5 * scale, (key, np.abs(got[key] - w).max(), scale)


@pytest.mark.parametrize("kind", KINDS)
def test_five_adamw_steps_match_optax(kind):
    jparams = _jax_init(kind)
    batch = train_batch(kind, 8)
    _, first_grad = _jax_value_and_grad(kind, jparams, batch)
    grad = _as_port_layout(_flat(_np_tree(first_grad)), kind)
    params, opt, tx = _port_params(kind, jparams)
    assert tx == ttr.AdamW(LR[kind]) and opt.defaults["weight_decay"] == 1e-4
    jmesh1 = jmesh.build_mesh(n_devices=1)
    jp, jopt, jtx = SPEC[kind][5](jax.random.PRNGKey(_RNG[kind]), jmesh1, SPEC[kind][2])
    jstep = SPEC[kind][6](jmesh1, jtx, SPEC[kind][2])
    step = SPEC[kind][8](None, SPEC[kind][3])
    for i in range(5):
        jp, jopt, jloss = jstep(jp, jopt, *(jnp.asarray(a) for a in batch))
        params, opt, loss = step(params, opt, *batch)
        assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss)), i
    _assert_params(_port_flat(params, kind), _as_port_layout(_flat(_np_tree(jp)), kind), grad,
                   LR[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_loss_matches_jax(kind):
    jparams = _jax_init(kind)
    batch = train_batch(kind, 8)
    n_batch = len(batch)
    loss = jax.jit(SPEC[kind][0], static_argnums=(n_batch + 1, n_batch + 2))
    want = loss(jparams, *(jnp.asarray(a) for a in batch), SPEC[kind][2], jnp.bfloat16)
    params, _, _ = _port_params(kind, jparams)
    with torch.no_grad():
        got = SPEC[kind][1](params, *(torch.from_numpy(a) for a in batch), SPEC[kind][3],
                            torch.bfloat16)
    assert abs(got.item() - float(want)) <= 3e-3 * abs(float(want))


@pytest.mark.parametrize("model_parallel", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_train_step_runs_and_learns(kind, model_parallel):
    """``tests/test_parallel.py``'s three "runs and learns" cases on the
    port's 8-device CPU mesh."""

    mesh = tmesh.build_mesh(model_parallel=model_parallel, devices=["cpu"] * 8)
    params, opt, _ = SPEC[kind][7](0, mesh, SPEC[kind][3], learning_rate=1e-3)
    step = SPEC[kind][8](mesh, SPEC[kind][3])
    batch = train_batch(kind, 8)
    losses = []
    for _ in range(15):
        params, opt, loss = step(params, opt, *batch)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert min(losses[-3:]) < losses[0]  # memorizes the fixed batch


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def _mesh_run(kind: str, jparams, shape, steps: int = 2):
    d, m = shape
    mesh = tmesh.build_mesh(model_parallel=m, devices=["cpu"] * (d * m))
    params, opt, _ = _port_params(kind, jparams, mesh)
    step = SPEC[kind][8](mesh, SPEC[kind][3])
    losses = []
    for i in range(steps):
        params, opt, loss = step(params, opt, *train_batch(kind, 8))
        losses.append(loss.item())
        if i == 0:
            grad = _port_flat(params, kind, grads=True)
    return losses, _port_flat(params, kind), grad


@pytest.fixture(scope="module")
def one_device_runs():
    return {kind: _mesh_run(kind, _jax_init(kind), (1, 1)) for kind in KINDS}


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_step_matches_one_device(kind, shape, one_device_runs):
    want_losses, want, grad = one_device_runs[kind]
    losses, got, _ = _mesh_run(kind, _jax_init(kind), shape)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    _assert_params(got, want, grad, LR[kind], atol=1e-6)


def test_mesh_step_matches_jax_model_parallel_2():
    """The port's (4, 2) CLIP step against JAX's ``make_train_step`` on its 8
    devices with ``model_parallel=2``, from the same weights."""

    jm = jmesh.build_mesh(model_parallel=2)
    jp, jopt, jtx = jtr.train_state_init(jax.random.PRNGKey(0), jm, JCLIP)
    init = _flat(_np_tree(jp))
    jstep = jtr.make_train_step(jm, jtx, JCLIP)
    tm = tmesh.build_mesh(model_parallel=2, devices=["cpu"] * 8)
    params, opt, _ = ttr.train_state_init(tconv.params_from_jax(init, "clip"), tm, TRAIN_CLIP)
    step = ttr.make_train_step(tm, TRAIN_CLIP)
    assert isinstance(params["vision"]["layers"][0]["qkv"]["kernel"], tmesh.Sharded)
    batch = train_batch("clip", 8)
    _, first_grad = _jax_value_and_grad("clip", _jax_init("clip"), batch)
    for i in range(2):
        jp, jopt, jloss = jstep(jp, jopt, *(jnp.asarray(a) for a in batch))
        params, opt, loss = step(params, opt, *batch)
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss)), i
    _assert_params(_port_flat(params, "clip"), _as_port_layout(_flat(_np_tree(jp)), "clip"),
                   _as_port_layout(_flat(_np_tree(first_grad)), "clip"), LR["clip"])


def test_ragged_batch_raises():
    mesh = tmesh.build_mesh(devices=["cpu"] * 4)
    params, opt, _ = ttr.minilm_train_state_init(0, mesh, TRAIN_BERT)
    with pytest.raises(ValueError, match="not divisible"):
        ttr.make_minilm_train_step(mesh, TRAIN_BERT)(params, opt, *train_batch("minilm", 6))


@pytest.mark.parametrize("kind", KINDS)
def test_param_sharding_rules_match_jax(kind):
    """Every leaf path of the tiny JAX trees gets JAX's spec; the port's
    fused ``qkv`` gets q's."""

    jm = jmesh.build_mesh(model_parallel=2)
    tm = tmesh.build_mesh(model_parallel=2, devices=["cpu"] * 8)
    flat = _flat(_np_tree(_jax_init(kind)))
    for key in flat:
        path = tuple(key.split("/"))
        want = tuple(jmesh.param_sharding_rules(path, jm).spec)
        assert tmesh.param_sharding_rules(path, tm) == want, key
        if len(path) > 1 and path[-2] == "q":
            qkv = path[:-2] + ("qkv", path[-1])
            assert tmesh.param_sharding_rules(qkv, tm) == want, key


def test_shard_params_splits_whole_heads_and_raises_on_a_ragged_dim():
    tm = tmesh.build_mesh(model_parallel=2, devices=["cpu"] * 2)
    params = tconv.params_from_jax(_flat(_jax_init("minilm")), "minilm")
    sharded = tmesh.shard_params(params, tm)
    qkv = sharded["layers"][0]["qkv"]["kernel"]
    full = params["layers"][0]["qkv"]["kernel"]
    h = TRAIN_BERT.hidden_size
    for j, shard in enumerate(qkv.shards):  # shard j holds heads 2j, 2j+1 of q, k and v
        want = torch.cat([full[:, i * h + j * h // 2:i * h + (j + 1) * h // 2] for i in range(3)], 1)
        assert torch.equal(shard, want)
    word = sharded["embeddings"]["word"]
    assert [s.shape for s in word.shards] == [(256, h)] * 2
    assert isinstance(sharded["layers"][0]["ffn_out"]["bias"], torch.Tensor)
    for key, val in _flat(tmesh.gather_params(sharded)).items():
        assert np.array_equal(val, _flat(params)[key]), key
    big = dict(params, embeddings=dict(params["embeddings"],
                                       word=torch.zeros(30522, h)))
    tmesh.shard_params(big, tm)  # 2 divides MiniLM's vocabulary
    with pytest.raises(ValueError, match="embeddings/word"):
        tmesh.shard_params(big, tmesh.build_mesh(model_parallel=4, devices=["cpu"] * 4))


def test_build_mesh_model_axis():
    mesh = tmesh.build_mesh(model_parallel=2, devices=["cpu"] * 8)
    assert mesh.shape == {tmesh.DATA_AXIS: 4, tmesh.MODEL_AXIS: 2}
    assert mesh.grid[1] == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        tmesh.build_mesh(n_devices=6, model_parallel=4, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="data-only"):
        mesh.devices  # a serving path handed a model axis
    from mmrag_tpu_torch.index.store import VectorIndex

    for grid in (mesh, tmesh.build_mesh(model_parallel=2, devices=["cpu"] * 2)):
        with pytest.raises(ValueError, match="data-only"):
            VectorIndex(8, device="cpu", mesh=grid)


def test_training_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.minilm_train_state_init(0, cfg=TRAIN_BERT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.train_state_init(0, tmesh.build_mesh(devices=["cuda:0"] * 2), TRAIN_CLIP)
