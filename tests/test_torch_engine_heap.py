"""The engine's long-lived heap and the cyclic collector (R15).

On the H100's host a full (generation 2) collection, traversing every
tracked object of the process, took 189 ms inside the int8 pass's coalesced
``retrieve_batch`` (``PERF.md`` §5). ``RagEngine`` now freezes what is alive
when it is built, so a later full collection sees only what was created
since; and since an engine holds no reference cycle, a closed engine is
still freed by refcounting alone, so freezing strands none of its memory."""

import gc
import weakref

import pytest

from mmrag_tpu_torch.cache import clear_all_caches
from mmrag_tpu_torch.models.runtime import EncoderRuntime
from mmrag_tpu_torch.rag import index_build as ib
from mmrag_tpu_torch.rag import retrieve as rv
from mmrag_tpu_torch.rag.engine import RagEngine
from mmrag_tpu_torch.settings import load_settings

from tiny_torch import TINY_BERT, TINY_CLIP, tiny_env, write_tiny_weights


@pytest.fixture(autouse=True)
def _clear_port_caches():
    clear_all_caches()
    yield
    clear_all_caches()


def _engine(tmp_path, window="0"):
    weights = write_tiny_weights(tmp_path / "weights")
    cfg = load_settings(tiny_env(tmp_path / f"engine{window}", weights,
                                 {"TPU_MICROBATCH_WINDOW_MS": window}))
    return RagEngine(cfg, EncoderRuntime(cfg, bert_cfg=TINY_BERT, clip_cfg=TINY_CLIP,
                                         device="cpu"))


def test_a_full_collection_after_the_engine_sees_only_newer_objects(tmp_path):
    eng = _engine(tmp_path)
    try:
        frozen = gc.get_freeze_count()
        assert frozen > 100_000  # the imports (torch's alone: about 170,000)
        ib.index_text_nodes("u1", [{"id": "d-c0", "text": "the cell's powerhouse",
                                    "metadata": {"document_id": "d"}}], eng)
        out = rv.retrieve_batch([("u1", "what powers the cell?", None)] * 4, eng)
        assert all(p["results"] for p in out)
        # what a full collection would traverse now: the objects created
        # since the engine was built, a small share of the frozen heap
        assert len(gc.get_objects()) < frozen // 10
    finally:
        eng.close()


@pytest.mark.parametrize("window", ["0", "4"])  # direct, and through the batchers
def test_a_closed_engine_is_freed_without_the_collector(tmp_path, window):
    eng = _engine(tmp_path, window)
    ib.index_text_nodes("u1", [{"id": "d-c0", "text": "hello world",
                                "metadata": {"document_id": "d"}}], eng)
    rv.retrieve("u1", "hello", eng)
    rv.retrieve_batch([("u1", "hello there", None)], eng)
    refs = [weakref.ref(o) for o in (eng, eng.runtime, eng.text_index, eng.image_index)]
    gc.disable()
    try:
        eng.close()
        del eng
        alive = [r() is not None for r in refs]
    finally:
        gc.enable()
    assert not any(alive), alive
