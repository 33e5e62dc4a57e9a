"""The port's train-state checkpoints and index snapshots
(``mmrag_tpu_torch/utils/checkpoint.py``), on the CPU.

Train state round-trips bit for bit in each tensor's dtype (bf16 too) with
its numbers and an AdamW ``state_dict()``; checkpoints are garbage-collected
to the newest ``keep``; a missing checkpoint raises ``FileNotFoundError``
and a mismatched target ``ValueError``; a MiniLM fine-tune saved at step 3,
restored into a fresh state and run 3 more steps gives the uninterrupted
run's losses and parameters exactly (the CPU sums in a fixed order). An
index written by the JAX package is snapshotted and restored by the port,
and loaded by both packages with the same rows and search results.
"""

import os

import numpy as np
import pytest
import torch

from mmrag_tpu.index.store import VectorIndex as JaxIndex
from mmrag_tpu.storage.records import VectorRow as JaxRow
from mmrag_tpu.utils import checkpoint as jckpt
from mmrag_tpu_torch.index.store import VectorIndex
from mmrag_tpu_torch.parallel import training as ttr
from mmrag_tpu_torch.utils import checkpoint as ckpt

from tiny_train import TRAIN_BERT, train_batch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and the suite runs several
    test processes side by side, whose threads would contend."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed: int = 0):
    params, opt, _ = ttr.minilm_train_state_init(seed, None, TRAIN_BERT, device="cpu")
    step = ttr.make_minilm_train_step(None, TRAIN_BERT)
    params, opt, _ = step(params, opt, *train_batch("minilm", 4))
    return params, opt


def _tree(seed: int = 0) -> dict:
    params, opt = _state(seed)
    gen = torch.Generator().manual_seed(seed)
    return {"params": params, "opt": opt.state_dict(), "step": 1, "tag": "minilm",
            "extra": [torch.randn(3, 2, generator=gen).bfloat16(), torch.arange(5),
                      (0.5, None, True)]}


def _same(a, b) -> None:
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a.detach(), b.detach())
    else:
        assert a == b


def test_round_trip_keeps_every_dtype_and_number(tmp_path):
    state = _tree(0)
    path = ckpt.save_train_state(str(tmp_path / "ck"), 1, state)
    assert path == os.path.join(str(tmp_path / "ck"), "step_00000001")
    target = _tree(1)  # same structure, other values
    got = ckpt.restore_train_state(str(tmp_path / "ck"), target)
    _same(got, state)
    assert got["extra"][0].dtype == torch.bfloat16
    assert isinstance(got["opt"]["param_groups"][0]["betas"], tuple)


def test_keeps_the_newest_and_replaces_a_step(tmp_path):
    root = str(tmp_path / "ck")
    for step in range(1, 6):
        ckpt.save_train_state(root, step, {"w": torch.full((2,), float(step))}, keep=3)
    assert sorted(os.listdir(root)) == ["step_00000003", "step_00000004", "step_00000005"]
    assert ckpt.latest_step(root) == 5
    ckpt.save_train_state(root, 5, {"w": torch.full((2,), 7.0)}, keep=3)  # force
    assert sorted(os.listdir(root)) == ["step_00000003", "step_00000004", "step_00000005"]
    target = {"w": torch.zeros(2)}
    assert ckpt.restore_train_state(root, target)["w"].tolist() == [7.0, 7.0]
    assert ckpt.restore_train_state(root, target, step=3)["w"].tolist() == [3.0, 3.0]
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_a_missing_checkpoint_raises(tmp_path):
    target = {"w": torch.zeros(2)}
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path / "none"), target)
    ckpt.save_train_state(str(tmp_path), 2, target)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path), target, step=9)


@pytest.mark.parametrize("target", [
    {"w": torch.zeros(3)},  # shape
    {"w": torch.zeros(2, dtype=torch.float64)},  # dtype
    {"w": torch.zeros(2), "b": torch.zeros(1)},  # a leaf the checkpoint lacks
    {"v": torch.zeros(2)},  # another path
    {"w": 1.0},  # a number where a tensor was
])
def test_a_mismatched_target_raises(tmp_path, target):
    ckpt.save_train_state(str(tmp_path), 0, {"w": torch.ones(2)})
    with pytest.raises(ValueError):
        ckpt.restore_train_state(str(tmp_path), target)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    batch = train_batch("minilm", 8, seed=3)
    step = ttr.make_minilm_train_step(None, TRAIN_BERT)
    params, opt, _ = ttr.minilm_train_state_init(0, None, TRAIN_BERT, device="cpu")
    losses = []
    for i in range(1, 7):
        params, opt, loss = step(params, opt, *batch)
        losses.append(loss.item())
        if i == 3:
            ckpt.save_train_state(str(tmp_path), i, {"params": params, "opt": opt.state_dict()})
    fresh, fresh_opt, _ = ttr.minilm_train_state_init(5, None, TRAIN_BERT, device="cpu")
    restored = ckpt.restore_train_state(str(tmp_path),
                                        {"params": fresh, "opt": fresh_opt.state_dict()})
    ttr.load_train_state(fresh, fresh_opt, restored)
    resumed = []
    for _ in range(3):
        fresh, fresh_opt, loss = step(fresh, fresh_opt, *batch)
        resumed.append(loss.item())
    assert resumed == losses[3:]
    for a, b in zip(ttr.param_leaves(fresh), ttr.param_leaves(params)):
        assert torch.equal(a, b)


def test_jax_index_is_snapshotted_and_restored_by_the_port(tmp_path):
    rng = np.random.default_rng(4)
    mat = rng.standard_normal((300, 32)).astype(np.float32)
    writer = JaxIndex(dim=32, dtype="bfloat16")
    writer.upsert([JaxRow(chunk_id=f"c{i}", user_id=f"u{i % 2}", document_id=f"d{i // 50}",
                          modality="text", embedding=mat[i]) for i in range(300)])
    live = tmp_path / "index"
    writer.save(str(live), "text_collection")
    snap = ckpt.snapshot_indexes(str(live), str(tmp_path / "ck"), label="pre")
    assert ckpt.list_index_snapshots(str(tmp_path / "ck")) == [os.path.basename(snap)]
    assert jckpt.list_index_snapshots(str(tmp_path / "ck")) == [os.path.basename(snap)]
    with pytest.raises(FileNotFoundError):
        ckpt.restore_indexes(str(tmp_path / "empty"), str(tmp_path / "other"))
    back = tmp_path / "restored"
    assert ckpt.restore_indexes(snap, str(back)) == ["text_collection.npz",
                                                     "text_collection.manifest.json"]
    port = VectorIndex.load(str(back), "text_collection", "bfloat16", device="cpu")
    ref = JaxIndex.load(str(back), "text_collection", "bfloat16")
    assert len(port) == len(ref) == 300
    queries = mat[:3] + 0.1 * rng.standard_normal((3, 32)).astype(np.float32)
    for user in ("u0", "u1"):
        got, want = port.search_batch(queries, user, 8), ref.search_batch(queries, user, 8)
        for g, w in zip(got, want):
            assert [c for c, _ in g] == [c for c, _ in w]
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-5)
