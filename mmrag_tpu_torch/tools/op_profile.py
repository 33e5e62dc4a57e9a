"""Profile one encoder step: device time by kernel, and by kernel and shapes.

Port of the repository's ``tools/op_profile.py``, the measurement loop
behind each fuse-or-revert decision of the encoders. The same six targets
at the same shapes, bf16 on the card:

* ``minilm`` (512 x 64 tokens, the query shape) and ``minilm512`` (64 x 512,
  the ingest chunk shape), and ``minilm_q8`` / ``minilm512_q8`` on the W8A8
  tower (B6 + B7);
* ``clip``: preprocess + the ViT-B/32 tower + L2 norm over 128 224 x 224
  uint8 images;
* ``clip_text``: the text tower over 256 x 77 tokens.

``torch.profiler`` with CUDA activity records 20 steps after a warm-up
step and two traced steps it discards.
Each kernel is charged to the operation that launched it: the port's
hand-written kernels to their building-kernel names (K-gemm, K-gemm-i8,
K-ln, K-quant, K-attn, as in ``PERF.md`` §6) with their tensors' shapes,
everything else to the torch op and its input shapes. On the CPU (the plain
versions, for the tests) the tables hold each op's own CPU time instead, and
say so.

Usage: ``python -m mmrag_tpu_torch.tools.op_profile [target] [--steps N]
[--platform cpu]`` (the card unless ``--platform cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import sys
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, working_dtype

TARGETS = ("minilm", "minilm_q8", "minilm512", "minilm512_q8", "clip", "clip_text")
STEPS = 20
WARMUP = 2  # profiled steps discarded before the window
STEP_RANGE = "op_profile.step"
LABEL = "mm::"  # prefix of the ranges around the hand-written kernels' wrappers

# the wrappers in ``ops/kernels.py`` that launch the encoders' building
# kernels, one launch a call (``attention`` calls ``attention_separate``)
KERNEL_NAMES = {
    "gemm": "K-gemm", "gemm_i8": "K-gemm-i8", "layer_norm": "K-ln", "row_quant": "K-quant",
    "attention_separate": "K-attn", "attention_full_bias": "K-attn",
}
# a fragment of each building kernel's symbol (``csrc/*.cu``) and its name;
# K-ln and K-quant are one row kernel told apart by its tail
SYMBOLS = (("gemm_i8_kernel", "K-gemm-i8"), ("gemm_bf16_kernel", "K-gemm"),
           ("gemm_f32_kernel", "K-gemm"), ("QuantTail", "K-quant"), ("row_kernel", "K-ln"),
           ("attention_mma_kernel", "K-attn"), ("attention_f32_kernel", "K-attn"))


def kernel_name(symbol: str) -> str:
    """The building kernel's name for one of its symbols, else the symbol."""

    return next((name for frag, name in SYMBOLS if frag in symbol), symbol)


def build(target: str, device: torch.device, bert_cfg=None,
          clip_cfg=None) -> Callable[[], torch.Tensor]:
    """The step of ``target`` on ``device`` with its seeded weights and
    inputs (bf16 on the card, f32 on the CPU)."""

    from ..models import bert, clip
    from ..models.convert import params_from_jax
    from ..ops.images import preprocess_batch

    if target not in TARGETS:
        raise ValueError(f"unknown profile target {target!r}: one of {TARGETS}")
    dtype = working_dtype("bfloat16", device)
    if target.startswith("clip"):
        cfg = clip_cfg or clip.CLIP_VIT_B32
        params = params_from_jax(clip.init_clip_params(1, cfg), "clip", cfg, device=device,
                                 dtype=dtype)
        if target == "clip":
            images = torch.from_numpy(np.random.default_rng(0).integers(
                0, 255, (128, 224, 224, 3), dtype=np.uint8)).to(device)
            return lambda: bert.l2_normalize(
                clip.clip_image_features(params, preprocess_batch(images), cfg))
        ids = torch.from_numpy(np.random.default_rng(0).integers(
            5, min(49000, cfg.text.vocab_size), (256, 77), dtype=np.int32)).to(device)
        mask = torch.ones_like(ids)
        return lambda: bert.l2_normalize(clip.clip_text_features(params, ids, mask, cfg))
    # minilm at the query shape (512 x 64) or the ingest chunk shape (64 x
    # 512); *_q8: the W8A8 tower
    cfg = bert_cfg or bert.MINILM_L6
    b, s = (64, 512) if target.startswith("minilm512") else (512, 64)
    tree = bert.init_bert_params(0, cfg)
    params = params_from_jax(tree, "minilm", cfg, device=device, dtype=dtype)
    q8 = (params_from_jax(tree, "minilm", cfg, device=device, q8=True)
          if target.endswith("_q8") else None)
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        5, min(30000, cfg.vocab_size), (b, s), dtype=np.int32)).to(device)
    mask = torch.ones_like(ids)
    return lambda: bert.minilm_embed(params, ids, mask, cfg, q8_layers=q8)


def _shapes(args) -> str:
    dims = ["x".join(map(str, a.shape)) for a in args if isinstance(a, torch.Tensor)]
    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
    dtype = str(first.dtype).replace("torch.", "") if first is not None else ""
    return f"{dtype} {' '.join(dims)}".strip()


@contextlib.contextmanager
def labelled_launches() -> Iterator[None]:
    """Run each wrapper of ``ops/kernels.py`` inside a profiler range named
    after its building kernel and its tensors' shapes, so the kernels it
    launches are charged to that name; restores the wrappers after."""

    from ..ops import kernels

    def labelled(fn, name):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"{LABEL}{name} {_shapes(args)}"):
                return fn(*args, **kwargs)
        return call

    saved = []
    for attr, name in KERNEL_NAMES.items():
        for owner in (kernels, kernels.DISPATCH):
            fn = getattr(owner, attr, None)
            if fn is not None:
                saved.append((owner, attr, fn))
                setattr(owner, attr, labelled(fn, name))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _records(prof, on_cuda: bool) -> List[tuple]:
    """``(name, us, op)``: on the card every kernel of the trace, charged to
    the op that launched it; on the CPU every op's own CPU time.

    The profiler links a torch kernel to its op, but not a kernel launched
    from the port's own libraries; so the building kernels (known by their
    symbols) are matched, in launch order, to the wrapper ranges of their
    name (one launch a range, one stream), which carry the shapes. Where
    the counts differ (an event lost from the trace) the kernel keeps its
    name and time, and its shapes are not given."""

    from torch.autograd import DeviceType

    cpu = sorted((e for e in prof.events() if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    if not on_cuda:
        return [(e.name[len(LABEL):].split()[0] if e.name.startswith(LABEL) else e.name,
                 float(e.self_cpu_time_total),
                 e.name[len(LABEL):] if e.name.startswith(LABEL)
                 else f"{e.name} {e.input_shapes}" if e.input_shapes else e.name)
                for e in cpu]
    ops: Dict[tuple, list] = defaultdict(list)  # a linked kernel -> its op
    ranges: Dict[str, list] = defaultdict(list)  # a building kernel -> its wrapper calls
    for e in cpu:
        if e.name.startswith(LABEL):
            label = e.name[len(LABEL):]
            ranges[label.split()[0]].append(label)
            continue
        for k in e.kernels:
            op = f"{e.name} {e.input_shapes}" if e.input_shapes else e.name
            ops[(k.name, k.duration)].append(op)
    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(LABEL) and e.name != STEP_RANGE),
                    key=lambda e: e.time_range.start)
    built = defaultdict(list)
    out = []
    for e in device:
        us = e.time_range.end - e.time_range.start
        name = kernel_name(e.name)
        if name in KERNEL_NAMES.values():
            built[name].append(len(out))
            out.append((name, float(us), None))
        else:
            linked = ops.get((e.name, us))
            out.append((name, float(us), linked.pop(0) if linked else "(no op linked)"))
    for name, idx in built.items():
        labels = ranges[name]
        if len(idx) != len(labels):  # a lost event would shift every label after it
            labels = [f"{name} ({len(idx)} launches traced, {len(labels)} wrapper calls)"] \
                * len(idx)
        for i, label in zip(idx, labels):
            out[i] = (name, out[i][1], label)
    return out


def _table(records: List[tuple], key, steps: int, total: float) -> List[dict]:
    acc: Dict[tuple, list] = defaultdict(lambda: [0.0, 0])
    for rec in records:
        row = acc[key(rec)]
        row[0] += rec[1]
        row[1] += 1
    rows = [{"name": k[0], **({"op": k[1]} if len(k) > 1 else {}),
             "us_per_step": us / steps, "share": us / total if total else 0.0,
             "launches_per_step": n / steps,
             "hand_written": k[0] in KERNEL_NAMES.values()}
            for k, (us, n) in acc.items()]
    return sorted(rows, key=lambda r: -r["us_per_step"])


def profile(target: str = "minilm", steps: int = STEPS, device: DeviceLike = None,
            bert_cfg=None, clip_cfg=None) -> dict:
    """Profile ``steps`` steps of ``target`` after one warm-up step on
    ``device`` (the card unless ``"cpu"``). Returns ``{"target", "device",
    "clock", "steps", "total_us_per_step", "by_kernel", "by_kernel_shape",
    "hand_written_share"}``: on the card the tables hold device time a step
    by kernel (all of them, sorted; each sums to the total), on the CPU each
    op's own CPU time (``clock`` says which)."""

    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    step = build(target, dev, bert_cfg, clip_cfg)
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    step()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    # traced but discarded steps first, as the profiler's own schedule
    # advises; each step ends on a sync, so a window holds whole steps
    schedule = torch.profiler.schedule(wait=0, warmup=WARMUP, active=steps, repeat=1)
    with labelled_launches(), torch_profile(activities=activities, record_shapes=True,
                                            schedule=schedule) as prof:
        for _ in range(WARMUP + steps):
            with record_function(STEP_RANGE):
                step()
            sync()
            prof.step()
    records = _records(prof, on_cuda)
    total = sum(r[1] for r in records)
    by_kernel = _table(records, lambda r: (r[0],), steps, total)
    return {
        "target": target, "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
        "clock": "device time" if on_cuda else "cpu self time (plain versions)",
        "steps": steps, "total_us_per_step": total / steps,
        "by_kernel": by_kernel,
        "by_kernel_shape": _table(records, lambda r: (r[0], r[2]), steps, total),
        "hand_written_share": sum(r["share"] for r in by_kernel if r["hand_written"]),
    }


def render(result: dict, top: int = 12, top_shapes: int = 20) -> str:
    lines = [f"== {result['target']} on {result['device']} ({result['clock']}): "
             f"{result['total_us_per_step'] / 1e3:.3f} ms/step, hand-written kernels "
             f"{100 * result['hand_written_share']:.1f}%"]
    for r in result["by_kernel"][:top]:
        lines.append(f"{r['us_per_step']:10.1f} us/step {100 * r['share']:5.1f}%  "
                     f"n={r['launches_per_step']:5.1f}/step  {r['name'][:90]}")
    lines.append("-- by kernel + shapes:")
    for r in result["by_kernel_shape"][:top_shapes]:
        lines.append(f"{r['us_per_step']:10.1f} us/step {100 * r['share']:5.1f}%  "
                     f"n={r['launches_per_step']:5.1f}/step  {r['name'][:50]} <- {r['op'][:90]}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mmrag_tpu_torch.tools.op_profile")
    ap.add_argument("target", nargs="?", default="minilm", choices=TARGETS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print(render(profile(args.target, args.steps, args.platform)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
