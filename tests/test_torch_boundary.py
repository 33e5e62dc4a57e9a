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
    # TPU-only knobs are not read: no compile cache, mesh, or top-k backend choice
    for knob in ("compile_cache_dir", "data_parallel", "topk_backend"):
        assert not hasattr(t.tpu, knob)


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
    ``MMRAG_ATTN_IMPL`` / ``MMRAG_LN_IMPL`` appear nowhere in its sources."""

    import pathlib

    import mmrag_tpu_torch

    root = pathlib.Path(mmrag_tpu_torch.__file__).parent
    for path in root.rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh"):
            text = path.read_text()
            assert "MMRAG_ATTN_IMPL" not in text and "MMRAG_LN_IMPL" not in text, path
