"""The port's import boundary and its refusal to run silently on the CPU."""

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
print(len(names), leaked)
assert not leaked, leaked
assert "triton" not in sys.modules
"""


def test_port_imports_without_jax_or_mmrag_tpu():
    out = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 30  # every module of the package was imported


@pytest.mark.parametrize("entry", ["runtime", "engine", "index"])
def test_entry_points_refuse_a_missing_card(entry, monkeypatch, tmp_path):
    """Without CUDA, an entry point not given device='cpu' raises."""

    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_settings({"TPU_INDEX_DIR": str(tmp_path / "i"), "TPU_MICROBATCH_WINDOW_MS": "0",
                         "NOTES_DB_PATH": str(tmp_path / "n.db")})
    make = {
        "runtime": lambda: EncoderRuntime(cfg),
        "engine": lambda: RagEngine(cfg),
        "index": lambda: VectorIndex(dim=8),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_engine_refuses_microbatching_and_snapshots(tmp_path):
    from mmrag_tpu_torch.index.store import VectorIndex
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings

    cfg = load_settings({"TPU_INDEX_DIR": str(tmp_path / "i"),
                         "NOTES_DB_PATH": str(tmp_path / "n.db")})
    with pytest.raises(NotImplementedError, match="TPU_MICROBATCH_WINDOW_MS"):
        RagEngine(cfg, device="cpu")
    (tmp_path / "i").mkdir()
    (tmp_path / "i" / "text_collection.manifest.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="snapshot"):
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
    # TPU-only knobs are not read: no compile cache or mesh
    for knob in ("compile_cache_dir", "data_parallel"):
        assert not hasattr(t.tpu, knob)
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
    ("approx", NotImplementedError), ("bogus", ValueError)])
def test_topk_backend_takes_auto_and_ivf_only(backend, raises, tmp_path):
    """``xla`` and ``pallas`` would only move a search on the card off its
    kernel, so they raise; ``approx`` is a TPU-only op, not ported."""

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
