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


def test_two_gloo_processes_match_one_process(tmp_path):
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "MMRAG_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "MMRAG_NUM_PROCESSES": "2", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(tests),
                                          os.environ.get("PYTHONPATH", "")])}
    outs = [str(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, os.path.join(tests, "torch_dcn_worker.py"),
                               outs[r]], env={**env, "MMRAG_PROCESS_ID": str(r)},
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
