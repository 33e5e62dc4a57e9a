"""Whole runs on the CPU at tiny widths: a cell added only as files and
manifest entries runs through the harness (its look for a card skipped),
comes out correct, and comes out not correct when the timed path is
broken underneath."""

import json
import sys

import numpy as np
import pytest
import torch

from bench_port import run

from .tiny_root import make


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make(str(tmp_path_factory.mktemp("bench")))


def _run(root, capsys, cell, seed, trace=0, config=None):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "2", "--trace",
                   str(trace)], root=root, device="cpu", config=config)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell,trace", [("tiny-chat", 0), ("tiny-ingest", 1)])
def test_added_cell_runs_correct(root, capsys, cell, trace):
    res = _run(root, capsys, cell, 2**32 + 5, trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        assert "ingest.upsert_ms_per_kchunk" in res["metrics"]
    else:
        assert {"chat_p50_ms", "chat_qps", "setup_s"} == set(res["metrics"])


def _noisy_queries(monkeypatch):
    from mmrag_tpu_torch.models.runtime import EncoderRuntime

    orig = EncoderRuntime.embed_queries_device

    def altered(self, queries):
        t, i = orig(self, queries)
        t = t + 0.05 * torch.randn(t.shape, generator=torch.Generator().manual_seed(0))
        return torch.nn.functional.normalize(t, dim=-1), i

    monkeypatch.setattr(EncoderRuntime, "embed_queries_device", altered)


def _half_batch(monkeypatch):
    from mmrag_tpu_torch.rag import retrieve

    orig = retrieve.retrieve_batch

    def half(items, engine=None):
        items = list(items)
        kept = items[: max(1, len(items) // 2)]
        out = orig(kept, engine)
        return [out[i % len(out)] for i in range(len(items))]

    monkeypatch.setattr(retrieve, "retrieve_batch", half)


def _rerank_altered(monkeypatch):
    from mmrag_tpu_torch.models.runtime import EncoderRuntime

    orig = EncoderRuntime.rerank_pairs
    monkeypatch.setattr(EncoderRuntime, "rerank_pairs",
                        lambda self, q, p: orig(self, q, p) + np.float32(0.01))


def _upsert_dropped(monkeypatch):
    from mmrag_tpu_torch.index.store import VectorIndex

    monkeypatch.setattr(VectorIndex, "upsert", lambda self, rows: len(rows))


@pytest.mark.parametrize("cell,fault", [("tiny-chat", _noisy_queries),
                                        ("tiny-chat", _half_batch),
                                        ("tiny-chat", _rerank_altered),
                                        ("tiny-ingest", _upsert_dropped)])
def test_broken_timed_path_is_not_correct(root, capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = _run(root, capsys, cell, 2**31 + 99)
    assert res["correct"] is False, res["checks"]


@pytest.fixture
def jax_root(tmp_path, monkeypatch):
    """A tiny copy with a per-layer metric whose reader file loads a stub
    ``jax`` module, as a later reader that imported JAX would."""

    root = make(str(tmp_path))
    with open(f"{root}/BENCHMARK.json") as fh:
        bench = json.load(fh)
    bench["per_layer"].append({"name": "tiny.loads_jax", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "ingest",
                               "moves": "ingest_chunks_per_s", "workloads": ["tiny-ingest"]})
    with open(f"{root}/BENCHMARK.json", "w") as fh:
        json.dump(bench, fh)
    with open(f"{root}/bench_port/metrics/tiny.loads_jax.py", "w") as fh:
        fh.write("import sys\nimport types\n\nsys.modules['jax'] = types.ModuleType('jax')\n\n\n"
                 "def read(records):\n    return 1.0\n")
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "jax", None)  # restored or removed at teardown
    del sys.modules["jax"]
    return root


def test_reader_that_loads_jax_gives_no_result(jax_root, capsys):
    rc = run.main(["--workload", "tiny-ingest", "--seed", "7", "--seconds", "2", "--trace", "1"],
                  root=jax_root, device="cpu")
    captured = capsys.readouterr()
    assert rc == 3
    assert "jax" in captured.err
    assert not any(line.startswith("{") for line in captured.out.splitlines())
