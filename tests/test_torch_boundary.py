"""The port's import boundary and its refusal to run silently on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from mmrag_tpu_torch.cache import clear_all_caches


@pytest.fixture(autouse=True)
def _clear_port_caches():
    clear_all_caches()
    yield
    clear_all_caches()


_CHECK = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now fails
import mmrag_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mmrag_tpu_torch.__path__, "mmrag_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "mmrag_tpu" or k.startswith("mmrag_tpu."))
print(len(names), leaked, " ".join(names))
assert not leaked, leaked
assert "triton" not in sys.modules
assert not [k for k in sys.modules if k.split(".")[0] in ("optax", "orbax")]
"""

# the native host runtime and the mesh modules, driven without jax: the
# library the port loads is its own build, never the JAX package's
_NATIVE = r"""
import sys
sys.modules["jax"] = None
import numpy as np
from mmrag_tpu_torch import native
from mmrag_tpu_torch.models.tokenizer import WordPieceTokenizer
from mmrag_tpu_torch.parallel import inference, mesh, sharded_index, sharded_ivf
tok = WordPieceTokenizer({"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "hi": 4})
assert tok._native is not None and tok.tokenize_ids("hi there") == [4, 1]
assert native.merge_topk(np.zeros((2, 1, 3), np.float32), np.zeros((2, 1, 3), np.int64), 3)
maps = open("/proc/self/maps").read()
assert "libmmrag_host.so" not in maps, "the JAX package's library was loaded"
assert native.library_path() in maps
assert not any(k == "mmrag_tpu" or k.startswith("mmrag_tpu.") for k in sys.modules)
print("ok")
"""

# the served path's modules (the ASR rung's too): each must be among those
# imported without jax
_SERVED = ("storage.kv", "utils.gemini", "rag.generate", "serving.batcher", "rag.stream",
           "ops.phash", "ingest.frames", "ingest.pdf", "ingest.youtube", "utils.note_builder",
           "serving.jobs", "serving.tasks", "utils.watchdog", "serving.http", "serving.console",
           "serving.__main__", "models.whisper", "models.align", "ingest.asr")
# this slice's modules: each must be among those imported without jax
_SLICE12 = ("native", "native.plain", "parallel.mesh", "parallel.sharded_index",
            "parallel.sharded_ivf", "parallel.inference")
# slice 13's fine-tuning modules
_SLICE13 = ("parallel.training", "utils.checkpoint")

# slice 16: the flagship forward and dry run, and the encoder op profiler
_SLICE16 = ("graft_entry", "tools", "tools.op_profile")

# slice 16's modules driven on the CPU with jax blocked: a 2-shard dry run
# and one profiled step
_SLICE16_RUN = r"""
import sys
sys.modules["jax"] = None
from mmrag_tpu_torch import graft_entry
from mmrag_tpu_torch.models.bert import BertConfig
from mmrag_tpu_torch.tools import op_profile
report = graft_entry.dryrun_multichip(2, devices=["cpu", "cpu"])
assert report["pq_hits"][0][0][0] == "c0" and report["model_parallel"] == 1
cfg = BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=32, max_position=512)
res = op_profile.profile("minilm", 1, "cpu", bert_cfg=cfg)
assert res["total_us_per_step"] > 0 and res["by_kernel"]
assert not [k for k in sys.modules if k == "mmrag_tpu" or k.startswith("mmrag_tpu.")]
print("ok")
"""

# the real-weights tools: every module of the port imports with jax
# and transformers blocked (validate / probe / cli import it inside the
# functions that load a checkpoint)
_TOOLS = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["transformers"] = None
import mmrag_tpu_torch
for m in pkgutil.walk_packages(mmrag_tpu_torch.__path__, "mmrag_tpu_torch."):
    importlib.import_module(m.name)
from mmrag_tpu_torch.models import cli, probe
assert probe.find_real_checkpoints() == {}
try:
    cli.main(["convert-minilm", "x"])
except SystemExit as exc:
    assert exc.code == 2, exc.code
print("ok")
"""

# a training step and a checkpoint on the CPU with jax, optax and orbax
# blocked: the port's optimizer is torch's, its checkpoints npz files
_TRAIN = r"""
import sys, tempfile
for name in ("jax", "optax", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None
import torch
from mmrag_tpu_torch.models.bert import BertConfig
from mmrag_tpu_torch.parallel import mesh, training
from mmrag_tpu_torch.utils import checkpoint
cfg = BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=32, max_position=8)
m = mesh.build_mesh(model_parallel=2, devices=["cpu"] * 4)
params, opt, tx = training.minilm_train_state_init(0, m, cfg)
ids = torch.randint(1, 64, (4, 8)); ones = torch.ones(4, 8, dtype=torch.int32)
params, opt, loss = training.make_minilm_train_step(m, cfg)(params, opt, ids, ones, ids, ones)
with tempfile.TemporaryDirectory() as d:
    checkpoint.save_train_state(d, 1, {"opt": opt.state_dict()})
    checkpoint.restore_train_state(d, {"opt": opt.state_dict()})
assert torch.isfinite(loss)
assert not [k for k in sys.modules if k == "mmrag_tpu" or k.startswith("mmrag_tpu.")]
print("ok")
"""


def test_port_imports_without_jax_or_mmrag_tpu():
    out = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 45  # every module of the package was imported
    imported = set(out.stdout.split()[2:])
    assert {f"mmrag_tpu_torch.{m}" for m in _SERVED} <= imported
    assert {f"mmrag_tpu_torch.{m}" for m in _SLICE12} <= imported
    assert {f"mmrag_tpu_torch.{m}" for m in _SLICE13} <= imported
    assert {f"mmrag_tpu_torch.{m}" for m in _SLICE16} <= imported


def test_port_imports_without_transformers(tmp_path):
    """The card's machine has no ``transformers``: the port imports without
    it, and the CLI exits 2 (a missing dependency) when a subcommand needs
    it."""

    env = {**os.environ, "HF_HOME": str(tmp_path / "hf")}
    env.pop("TPU_REAL_WEIGHTS_DIR", None)
    out = subprocess.run([sys.executable, "-c", _TOOLS], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert "missing dependency" in out.stderr


def test_training_and_checkpoints_run_without_jax_optax_or_orbax():
    out = subprocess.run([sys.executable, "-c", _TRAIN], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_native_and_mesh_modules_run_without_jax_on_the_ports_own_library():
    out = subprocess.run([sys.executable, "-c", _NATIVE], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["runtime", "engine", "index", "mesh"])
def test_entry_points_refuse_a_missing_card(entry, monkeypatch, tmp_path):
    """Without CUDA, an entry point not given device='cpu' raises."""

    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.parallel.mesh import build_mesh
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_settings({"TPU_INDEX_DIR": str(tmp_path / "i"), "TPU_MICROBATCH_WINDOW_MS": "0",
                         "NOTES_DB_PATH": str(tmp_path / "n.db")})
    make = {
        "runtime": lambda: EncoderRuntime(cfg),
        "engine": lambda: RagEngine(cfg),
        "index": lambda: VectorIndex(dim=8),
        # a mesh over the card, handed to an index with no device
        "mesh": lambda: VectorIndex(dim=8, mesh=build_mesh(devices=["cuda:0"] * 2)),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_engine_refuses_microbatching_and_snapshots(tmp_path):
    """Under the default settings (``TPU_MICROBATCH_WINDOW_MS=4``) a CPU
    engine builds both serving batchers and ``close()`` stops them (the
    engine refused a window above 0 until the batchers were ported); a
    snapshot it cannot read is still refused."""

    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings

    cfg = load_settings({"TPU_INDEX_DIR": str(tmp_path / "i"),
                         "NOTES_DB_PATH": str(tmp_path / "n.db")})
    assert cfg.tpu.microbatch_window_ms == 4.0 and cfg.tpu.microbatch_workers == 3
    engine = RagEngine(cfg, device="cpu")
    query, retrieval = engine.query_batcher, engine.retrieval_batcher
    assert query is not None and retrieval is not None
    assert retrieval._pool is not None and retrieval._thread.is_alive()
    engine.close()
    assert not retrieval._thread.is_alive() and not query._batcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        retrieval.submit(("u", "q", None))
    # a snapshot it cannot read is refused, never replaced by an empty index
    # that would hide its rows
    (tmp_path / "i").mkdir(exist_ok=True)
    (tmp_path / "i" / "text_collection.manifest.json").write_text('{"dim": 8, "rows": 3}')
    with pytest.raises(FileNotFoundError, match="text_collection.npz"):
        VectorIndex.load_or_create(str(tmp_path / "i"), "text_collection", 8, device="cpu")


def test_settings_share_env_names_with_the_jax_package():
    from dataclasses import asdict

    from mmrag_tpu.settings import load_settings as jload
    from mmrag_tpu_torch.settings import load_settings as tload

    env = {"INDEX_TOPK_TEXT": "7", "TPU_TEXT_BATCH_BUCKETS": "4,16", "TPU_COMPUTE_DTYPE": "float32"}
    j, t = jload(env), tload(env)
    assert asdict(t.retrieval) == asdict(j.retrieval)
    assert t.tpu.text_batch_buckets == j.tpu.text_batch_buckets == (4, 16)
    assert t.tpu.compute_dtype == "float32"
    # the TPU-only knobs are not read (compile cache, mesh axis names);
    # TPU_DATA_PARALLEL is, with the JAX package's value
    for knob in ("compile_cache_dir", "mesh_data_axis", "mesh_model_axis"):
        assert not hasattr(t.tpu, knob)
    assert t.tpu.data_parallel == j.tpu.data_parallel
    # TPU_TOPK_BACKEND is read under the JAX name, with the port's two values
    ivf = {**env, "TPU_TOPK_BACKEND": "ivf"}
    assert tload(ivf).tpu.topk_backend == jload(ivf).tpu.topk_backend == "ivf"
    assert t.tpu.topk_backend == j.tpu.topk_backend == "auto"


def test_int8_runtime_is_accepted_and_unknown_quant_refused(tmp_path):
    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.settings import load_settings

    env = {"TPU_INDEX_DIR": str(tmp_path / "i"), "NOTES_DB_PATH": str(tmp_path / "n.db")}
    rt = EncoderRuntime(load_settings({**env, "TPU_ENCODER_QUANT": "int8"}), device="cpu")
    assert rt.quant
    assert not EncoderRuntime(load_settings(env), device="cpu").quant
    with pytest.raises(ValueError, match="TPU_ENCODER_QUANT"):
        EncoderRuntime(load_settings({**env, "TPU_ENCODER_QUANT": "fp8"}), device="cpu")


def test_port_never_reads_the_kernel_overrides():
    """No env override can move the port off its kernels: the JAX package's
    ``MMRAG_ATTN_IMPL`` / ``MMRAG_LN_IMPL`` / ``MMRAG_ADC_IMPL`` appear nowhere
    in its sources."""

    import pathlib

    import mmrag_tpu_torch

    root = pathlib.Path(mmrag_tpu_torch.__file__).parent
    for path in root.rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh"):
            text = path.read_text()
            for name in ("MMRAG_ATTN_IMPL", "MMRAG_LN_IMPL", "MMRAG_ADC_IMPL"):
                assert name not in text, (name, path)


@pytest.mark.parametrize("backend,raises", [
    ("auto", None), ("ivf", None), ("xla", ValueError), ("pallas", ValueError),
    ("approx", None), ("bogus", ValueError)])
def test_topk_backend_takes_auto_and_ivf_only(backend, raises, tmp_path):
    """``xla`` and ``pallas`` would only move a search on the card off its
    kernel, so they raise; ``approx`` (X1, K-bmax's top-k form) is accepted
    beside ``auto`` and ``ivf``."""

    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.settings import load_settings

    env = {"TPU_INDEX_DIR": str(tmp_path / "i"), "TPU_TOPK_BACKEND": backend}
    if raises is None:
        assert load_settings(env).tpu.topk_backend == backend
        assert VectorIndex(8, backend=backend, device="cpu").use_ivf == (backend == "ivf")
        return
    with pytest.raises(raises):
        load_settings(env)
    with pytest.raises(raises):
        VectorIndex(8, backend=backend, device="cpu")


def test_storage_dtype_takes_int8_and_pq_and_refuses_unknown():
    from mmrag_tpu_torch.device import storage_dtype
    from mmrag_tpu_torch.index.store import VectorIndex

    assert storage_dtype("int8") == torch.int8
    assert storage_dtype("pq") == torch.bfloat16  # codes on the device, bf16 attribute
    index = VectorIndex(16, dtype="int8", device="cpu")
    assert index.is_int8 and not index.is_pq
    assert VectorIndex(16, dtype="pq", device="cpu").is_pq
    for bad in ("float16", "int4", None):
        with pytest.raises(NotImplementedError):
            storage_dtype(bad)


@pytest.mark.parametrize("kwargs", [{"dtype": "int8"}, {"dtype": "pq"}, {"backend": "ivf"}])
def test_new_index_layouts_refuse_a_missing_card(kwargs, monkeypatch):
    from mmrag_tpu_torch.index.store import VectorIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VectorIndex(dim=16, **kwargs)
    VectorIndex(dim=16, device="cpu", **kwargs)


def test_launch_counts_are_exact_across_threads():
    """The served path launches from several threads; 8 threads x 10,000
    counts give the exact total."""

    import threading

    from mmrag_tpu_torch.ops import kernels

    kernels.reset_launches()
    start = threading.Barrier(8)

    def count():
        start.wait()
        for _ in range(10_000):
            kernels.count_launch("B4")

    threads = [threading.Thread(target=count) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernels.LAUNCHES["B4"] == 80_000
    kernels.reset_launches()
    assert kernels.LAUNCHES["B4"] == 0


def test_serving_entry_point_refuses_a_missing_card(monkeypatch):
    """``get_engine`` (what ``python -m mmrag_tpu_torch.serving`` serves) is
    the card's unless ``cpu`` is asked for: without CUDA it raises."""

    from mmrag_tpu_torch.rag import engine as engine_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine_mod, "_engine", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine_mod.get_engine()
    assert engine_mod._engine is None


def test_dry_run_and_op_profile_run_without_jax(tmp_path):
    env = {**os.environ, "HF_HOME": str(tmp_path / "hf")}
    env.pop("TPU_REAL_WEIGHTS_DIR", None)
    out = subprocess.run([sys.executable, "-c", _SLICE16_RUN], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
