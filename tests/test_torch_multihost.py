"""The port's multi-process rendezvous (``parallel/mesh.py::
initialize_multihost``) and the fine-tuning step across processes.

Without a coordinator the call does nothing; with one, both counts are
required (torch has no auto-detection), and the card is the default device.
Two processes of a ``gloo`` group (``tests/torch_dcn_worker.py``), each
passing half of the global batch, give one process's loss and parameters
after a MiniLM MNR step and a CLIP step within 1e-5, and its gradients
within 1e-5 of each leaf's max-abs: the gradients are scaled once (Adam's
step alone would not show a gradient scaled by the world size). Each
worker's ``communicate`` has a 120 s timeout that fails the test.

The cross-process sharded search (``tests/dcn_worker.py`` part 1): two
processes, each holding half of the rows on a 2-shard mesh of its own, give
the ids and scores of one process searching the whole corpus (4 shards, and
the plain single-device top-k) and of JAX's ``sharded_topk`` over its
devices: ids equal, in order (an exact tie across the process boundary comes
out with the lower process's row first), scores within 1e-6. Without
``group=`` the same call inside the group searches the process's own rows
alone (ids local to them), as one process does.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmrag_tpu_torch.parallel import mesh as tmesh

import torch_dcn_worker as worker


@pytest.fixture()
def no_env(monkeypatch):
    for name in ("MMRAG_COORDINATOR", "MMRAG_NUM_PROCESSES", "MMRAG_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_initialize_multihost_noop_without_coordinator(no_env):
    assert tmesh.initialize_multihost() is False
    assert tmesh.initialize_multihost(num_processes=2, process_id=0) is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env", [{"MMRAG_NUM_PROCESSES": "2"}, {"MMRAG_PROCESS_ID": "0"}, {}])
def test_initialize_multihost_requires_both_counts(no_env, env):
    no_env.setenv("MMRAG_COORDINATOR", "127.0.0.1:1")
    for name, value in env.items():
        no_env.setenv(name, value)
    with pytest.raises(ValueError, match="MMRAG_NUM_PROCESSES and MMRAG_PROCESS_ID"):
        tmesh.initialize_multihost(device="cpu")
    assert not torch.distributed.is_initialized()


def test_initialize_multihost_refuses_a_missing_card(no_env):
    no_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.initialize_multihost("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_workers(tmp_path, mode: str):
    """Run the worker as ranks 0 and 1 of a fresh gloo group; returns the
    two output npz paths."""

    tests = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "MMRAG_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "MMRAG_NUM_PROCESSES": "2", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(tests),
                                          os.environ.get("PYTHONPATH", "")])}
    outs = [str(tmp_path / f"{mode}-rank{r}.npz") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, os.path.join(tests, "torch_dcn_worker.py"),
                               outs[r], mode], env={**env, "MMRAG_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=120))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the two-process gloo group timed out")
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0 and "TORCH_DCN_OK" in out, err[-2000:]
    return outs


def test_two_gloo_processes_match_one_process(tmp_path):
    outs = _two_workers(tmp_path, "train")
    want = {}
    for tower in worker.TOWERS:
        want.update(worker.run(*tower))
    for path in outs:
        with np.load(path) as got:
            assert set(got.files) == set(want)
            for key, w in want.items():
                if "/grads/" in key:
                    assert np.abs(got[key] - w).max() <= 1e-5 * np.abs(w).max(), key
                else:
                    np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5, err_msg=key)


def test_two_gloo_processes_sharded_search_matches_one_process_and_jax(tmp_path):
    import jax.numpy as jnp

    from mmrag_tpu.parallel import mesh as jmesh
    from mmrag_tpu.parallel import sharded_index as jsi
    from mmrag_tpu_torch.ops.topk import cosine_topk
    from mmrag_tpu_torch.parallel.sharded_index import sharded_topk

    outs = _two_workers(tmp_path, "search")
    corpus, queries, mask = worker.search_inputs()
    k = worker.SEARCH_K
    q, c, m = (torch.from_numpy(a) for a in (queries, corpus, mask))
    one_mesh = sharded_topk(q, c, m, k, tmesh.build_mesh(devices=["cpu"] * 4))
    one_device = cosine_topk(q, c, m, k)
    js, ji = jsi.sharded_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), k,
                              jmesh.build_mesh(n_devices=4))  # dcn_worker.py: 2 x 2 devices
    assert np.asarray(ji)[0, :2].tolist() == [3, 40]  # the tie: the lower process first
    rows = corpus.shape[0] // 2
    for rank, path in enumerate(outs):
        with np.load(path) as got:
            for ws, wi in (one_mesh, one_device, (js, ji)):
                np.testing.assert_array_equal(got["search/ids"], np.asarray(wi))
                np.testing.assert_allclose(got["search/scores"], np.asarray(ws), rtol=0,
                                           atol=1e-6)
            mine = slice(rank * rows, (rank + 1) * rows)
            ls, li = cosine_topk(q, c[mine], m[mine], k)
            np.testing.assert_array_equal(got["search/local_ids"], li.numpy())
            np.testing.assert_allclose(got["search/local_scores"], ls.numpy(), rtol=0, atol=1e-6)
