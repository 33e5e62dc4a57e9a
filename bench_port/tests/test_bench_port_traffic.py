"""The generator is deterministic per seed, and every seed asks for the
same multiset of work in another order."""

import json
import os
from collections import Counter

import numpy as np
import pytest

from bench_port.harness import corpus, traffic

from .tiny_root import BENCH, open_mix

TENANTS = [f"t{i:03d}" for i in range(32)]
DOCS = {t: [f"{t}-d{k}" for k in range(3)] for t in TENANTS}


def _mix(name):
    if name == "tiny-open":
        return open_mix()
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def _chat(seed, name="tiny-open"):
    rng = np.random.default_rng(seed)
    text = corpus.Text(np.random.default_rng(seed + 1), pool=64)
    return traffic.chat_requests(_mix(name), rng, text, TENANTS, DOCS, 400, 40.0)


@pytest.mark.parametrize("name", ["tiny-open", "chat-closed"])
def test_chat_deterministic(name):
    assert _chat(2**31 + 11, name) == _chat(2**31 + 11, name)
    assert _chat(2**31 + 11, name) != _chat(2**31 + 12, name)


def test_chat_same_work_each_seed():
    a, b = _chat(5), _chat(2**33 + 7)
    assert Counter(len(r["query"].split()) for r in a) == Counter(len(r["query"].split())
                                                                   for r in b)
    assert Counter(r["tenant"] for r in a) == Counter(r["tenant"] for r in b)
    assert sum(r["doc"] is not None for r in a) == sum(r["doc"] is not None for r in b)
    assert sorted(np.diff([r["at"] for r in a])) != []
    assert abs(a[-1]["at"] - b[-1]["at"]) < 1.0
    assert len({r["query"] for r in a}) == len(a)
    for r in a:
        assert 3 <= len(r["query"].split()) <= 30
        assert r["doc"] is None or r["doc"] in DOCS[r["tenant"]]


def test_ingest_deterministic_and_same_sizes():
    mix = _mix("ingest-docs")
    p1 = traffic.ingest_plan(mix, np.random.default_rng(9), TENANTS, 256)
    p2 = traffic.ingest_plan(mix, np.random.default_rng(2**40), TENANTS, 256)
    assert p1 == traffic.ingest_plan(mix, np.random.default_rng(9), TENANTS, 256)
    assert sorted(d["chunks"] for d in p1) == sorted(d["chunks"] for d in p2)
    assert all(4 <= d["chunks"] <= 512 for d in p1)
    sentences = corpus.Text(np.random.default_rng(1), pool=64).sentences
    doc = p1[0]
    nodes = traffic.ingest_nodes(mix, 123, doc, sentences)
    assert nodes == traffic.ingest_nodes(mix, 123, doc, sentences)
    assert len(nodes) == doc["chunks"]
    assert all(len(n["text"]) <= 1200 and n["text"] == n["text"].strip() for n in nodes)
    assert nodes[0]["text"][-200:].strip() in nodes[1]["text"][:220] or doc["chunks"] == 1


def test_chunks_pass_the_sentence_splitter_whole():
    """The system re-splits a node only past 512 words: a 1,200-character
    chunk comes back whole, so its catalogue text is the node's text."""

    from mmrag_tpu_torch.ingest.chunk import sentence_split

    text = corpus.Text(np.random.default_rng(4), pool=64)
    for _ in range(50):
        p = text.passage(1200)
        assert sentence_split(p, 512, 64) == [p]


def test_vocabularies_have_the_published_sizes(tmp_path):
    corpus.write_vocabularies([str(tmp_path / "bert")], str(tmp_path / "clip"))
    assert len(open(tmp_path / "bert" / "vocab.txt").read().splitlines()) == 30522
    vocab = json.load(open(tmp_path / "clip" / "vocab.json"))
    assert len(vocab) == 49408 and vocab["<|endoftext|>"] == 49407
    assert len(open(tmp_path / "clip" / "merges.txt").read().splitlines()) == 48894 + 1
