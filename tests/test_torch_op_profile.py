"""The port's encoder op profiler (``mmrag_tpu_torch/tools/op_profile.py``)
on the CPU at tiny widths: every target of ``tools/op_profile.py`` builds
and profiles, both tables account for the whole profiled time, and an
unknown target raises, as JAX's does. On the CPU the tables hold each op's
own CPU time (the plain versions), never a device time."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mmrag_tpu_torch.models import bert, clip
from mmrag_tpu_torch.tools import op_profile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT = bert.BertConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                       intermediate_size=64, max_position=512)
CLIP = clip.CLIPConfig(
    vision=clip.CLIPVisionConfig(image_size=224, patch_size=32, hidden_size=32, num_layers=2,
                                 num_heads=2, intermediate_size=64),
    text=clip.CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                             intermediate_size=64, max_position=77),
    projection_dim=16,
)
# JAX's shapes, which the port keeps: (batch, seq) or the image batch
SHAPES = {"minilm": (512, 64), "minilm_q8": (512, 64), "minilm512": (64, 512),
          "minilm512_q8": (64, 512), "clip": (128, 224, 224, 3), "clip_text": (256, 77)}

# the building kernels each target's step calls (the W8A8 towers: B6 + B7)
WRAPPERS = {"minilm": {"K-gemm", "K-ln", "K-attn"}, "minilm512": {"K-gemm", "K-ln", "K-attn"},
            "minilm_q8": {"K-gemm-i8", "K-quant", "K-ln", "K-attn"},
            "minilm512_q8": {"K-gemm-i8", "K-quant", "K-ln", "K-attn"},
            "clip": {"K-gemm", "K-ln", "K-attn"}, "clip_text": {"K-attn"}}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_targets_are_jax_targets():
    spec = importlib.util.spec_from_file_location(
        "op_profile_jax", os.path.join(_REPO, "tools", "op_profile.py"))
    src = open(spec.origin).read()
    assert f"[{'|'.join(op_profile.TARGETS)}]" in src.replace("\n    ", "")
    assert op_profile.STEPS == 20


@pytest.mark.parametrize("target", op_profile.TARGETS)
def test_every_target_builds_and_tables_sum_to_the_total(target):
    step = op_profile.build(target, torch.device("cpu"), BERT, CLIP)
    out = step()
    width = CLIP.projection_dim if target.startswith("clip") else BERT.hidden_size
    assert out.shape == (SHAPES[target][0], width) and torch.isfinite(out).all()
    res = op_profile.profile(target, 1, "cpu", BERT, CLIP)
    assert res["device"] == "cpu" and res["clock"].startswith("cpu")
    total = res["total_us_per_step"]
    assert total > 0
    for table in ("by_kernel", "by_kernel_shape"):
        rows = res[table]
        np.testing.assert_allclose(sum(r["us_per_step"] for r in rows), total, rtol=1e-9)
        np.testing.assert_allclose(sum(r["share"] for r in rows), 1.0, rtol=1e-9)
        assert [r["us_per_step"] for r in rows] == sorted((r["us_per_step"] for r in rows),
                                                          reverse=True)
    # the wrappers of the hand-written kernels are named as in PERF.md
    names = {r["name"] for r in res["by_kernel"] if r["hand_written"]}
    assert names == WRAPPERS[target]
    shapes = [r["op"] for r in res["by_kernel_shape"] if r["hand_written"]]
    assert shapes and all("x" in op for op in shapes)
    text = op_profile.render(res)
    assert text.startswith(f"== {target} on cpu")


def test_labels_are_removed_after_profiling():
    from mmrag_tpu_torch.ops import kernels

    before = (kernels.gemm, kernels.DISPATCH.gemm, kernels.layer_norm)
    with op_profile.labelled_launches():
        assert kernels.gemm is not before[0] and kernels.DISPATCH.gemm is not before[1]
    assert (kernels.gemm, kernels.DISPATCH.gemm, kernels.layer_norm) == before


def test_unknown_target_raises_as_jax_does():
    spec = importlib.util.spec_from_file_location(
        "op_profile_jax", os.path.join(_REPO, "tools", "op_profile.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    with pytest.raises(SystemExit, match="unknown profile target"):
        jax_tool.build("nope")
    with pytest.raises(ValueError, match="unknown profile target"):
        op_profile.profile("nope", 1, "cpu")
    with pytest.raises(SystemExit) as exc:
        op_profile.main(["nope", "--platform", "cpu"])
    assert exc.value.code == 2


def test_profiler_takes_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        op_profile.profile("minilm", 1)


def _event(name, device, start, end, kernels=(), shapes=None):
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device == "cuda" else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), kernels=list(kernels),
        input_shapes=shapes, self_cpu_time_total=float(end - start))


def _kernel(name, us):
    from torch.autograd.profiler_util import Kernel

    return Kernel(name, 0, us)


def test_card_trace_charges_every_kernel_to_its_op_or_wrapper():
    """The card path of the tables on a trace built by hand: torch kernels
    are charged to the op the profiler links them to; the port's kernels,
    which it does not link, to their wrapper ranges in launch order (with
    the shapes); every kernel of the trace is counted once."""

    from types import SimpleNamespace

    gemm = "void (anonymous namespace)::gemm_bf16_kernel<128, 64, true>(...)"
    ln = "void (anonymous namespace)::row_kernel<bf16, 8, 4, 2, true, false, " \
         "(anonymous namespace)::StoreTail>(...)"
    quant = "void (anonymous namespace)::row_kernel<float, 4, 8, 1, false, false, " \
            "(anonymous namespace)::QuantTail>(...)"
    add = "void at::native::elementwise_kernel<128, 2, add>(int)"
    events = [
        _event(op_profile.STEP_RANGE, "cpu", 0, 100),
        _event("mm::K-gemm bfloat16 512x384 384x1152 1152", "cpu", 1, 2),
        _event("aten::add", "cpu", 3, 4, [_kernel(add, 5.0)], [[512, 384], [384]]),
        _event("mm::K-ln bfloat16 512x384", "cpu", 5, 6),
        _event("mm::K-gemm bfloat16 512x384 384x384 384", "cpu", 7, 8),
        _event("mm::K-quant float32 512x1536", "cpu", 9, 10),
        # the device side: the port's kernels unlinked, one range mirror
        _event(gemm, "cuda", 20, 30), _event(add, "cuda", 30, 35), _event(ln, "cuda", 35, 37),
        _event("mm::K-gemm bfloat16 512x384 384x384 384", "cuda", 37, 45),
        _event(gemm, "cuda", 37, 44), _event(quant, "cuda", 44, 47),
        _event("Memset (Device)", "cuda", 47, 48),
    ]
    prof = SimpleNamespace(events=lambda: events)
    records = op_profile._records(prof, on_cuda=True)
    assert records == [
        ("K-gemm", 10.0, "K-gemm bfloat16 512x384 384x1152 1152"),
        (add, 5.0, "aten::add [[512, 384], [384]]"),
        ("K-ln", 2.0, "K-ln bfloat16 512x384"),
        ("K-gemm", 7.0, "K-gemm bfloat16 512x384 384x384 384"),
        ("K-quant", 3.0, "K-quant float32 512x1536"),
        ("Memset (Device)", 1.0, "(no op linked)"),
    ]
    table = op_profile._table(records, lambda r: (r[0],), 1, 28.0)
    assert table[0] == {"name": "K-gemm", "us_per_step": 17.0, "share": 17.0 / 28.0,
                        "launches_per_step": 2.0, "hand_written": True}
    # a launch lost from the trace: names and times stay, the shapes go
    del events[10]
    records = op_profile._records(prof, on_cuda=True)
    assert [r[:2] for r in records] == [("K-gemm", 10.0), (add, 5.0), ("K-ln", 2.0),
                                        ("K-quant", 3.0), ("Memset (Device)", 1.0)]
    assert records[0][2] == "K-gemm (1 launches traced, 2 wrapper calls)"
    assert records[2][2] == "K-ln bfloat16 512x384"
