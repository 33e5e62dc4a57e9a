"""The readers of the program's own spans: each returns a number on the
records of a tiny traced chat run and a tiny traced ingest run, and None
where the ring holds no record that ended in the window, or where the
program keeps no ring (as a program from before the ring does not)."""

import json

import pytest

from bench_port import run
from bench_port.harness.manifest import Manifest

from .tiny_root import REPO, make

CHAT = ("serving.handler_self_ms", "retrieve.tokenize_ms", "retrieve.enqueue_ms",
        "retrieve.device_wait_ms", "host.gc_ms_per_s.chat")
INGEST = ("host.gc_ms_per_s.ingest", "ingest.tokenize_ms_per_kchunk",
          "ingest.journal_ms_per_kchunk")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell,names", [("tiny-chat", CHAT), ("tiny-ingest", INGEST)])
def test_new_readers_read_a_traced_run(root, capsys, cell, names):
    rc = run.main(["--workload", cell, "--seed", str(2**33 + 17), "--seconds", "2",
                   "--trace", "1"], root=root, device="cpu")
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"], res["checks"]
    for name in names:
        value = res["metrics"][name]["value"]
        # a window may hold no collection; every other span has some length
        assert value >= 0.0 if name.startswith("host.gc") else value > 0.0, (name, value)


@pytest.mark.parametrize("name", CHAT + INGEST)
def test_new_reader_finds_nothing_outside_the_ring(name, monkeypatch):
    from mmrag_tpu_torch.utils import profiling

    read = Manifest(REPO).reader(name)
    assert read({"window": (-2.0, -1.0)}) is None
    monkeypatch.delattr(profiling, "records")
    assert read({"window": (0.0, 1e12)}) is None
