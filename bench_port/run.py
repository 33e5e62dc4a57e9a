"""Run one cell of the benchmark of ``mmrag_tpu_torch`` once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints the set-up's parts and the check's
numbers on standard error, and as its last line on standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks`` (each number the
check compared, with its limit). Exits 2 without a result when the cell's
CUDA devices are not there, 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "mmrag_tpu")


class Run:
    """One run's parameters and state, shared by the harness's parts."""

    def __init__(self, args, spec: Dict, tmp: str, device: str) -> None:
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.name = spec["name"]
        self.cfg, self.mix, self.cell = spec["config"], spec["traffic"], spec["cell"]
        self.tmp, self.device = tmp, device
        self.window_start = 0.0
        self.data = None


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _number(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def main(argv: Optional[List[str]] = None, root: str = ROOT, device: Optional[str] = None,
         t0: float = T0, config: Optional[str] = None) -> int:
    """``device`` None looks for the cell's CUDA devices; the CPU tests pass
    ``"cpu"``, and ``root`` a copy of the benchmark with cells of their own;
    ``config`` runs the cell on another configuration (a control run)."""

    from bench_port.harness.manifest import Manifest

    args = parse(argv)
    manifest = Manifest(root)
    spec = manifest.cell(args.workload, config)
    import torch

    if device is None:
        chips = spec["entry"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"bench_port: {args.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    tmp = tempfile.mkdtemp(prefix="bench_port_")  # under the run's TMPDIR
    try:
        return _run(Run(args, spec, tmp, device), manifest, t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def prepare(run: Run, t0: float):
    """The cell's data and traffic, and the system under test, set up."""

    from bench_port.harness import cells, system

    run.data = system.Dataset(run.cfg, run.seed)
    data_s = time.monotonic()
    os.environ.update(system.settings_env(run.cfg, run.tmp, run.data.tenants))
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("GEMINI_API_KEY", None)
    cell = (cells.ChatCell if run.mix["kind"] == "chat" else cells.IngestCell)(run)
    sut = system.build(run.cfg, run.data, run.seed, run.tmp, run.device, cell.warm,
                       serve=cell.kind == "chat", t0=data_s)
    sut.parts = {"data": data_s - t0, **sut.parts}
    return cell, sut


def _run(run: Run, manifest, t0: float) -> int:
    import torch

    from bench_port.harness import judge, weights
    from bench_port.harness.trace import DeviceTrace, Recorder, breakdown

    cell, sut = prepare(run, t0)
    retrieval_cfg = run.cfg["retrieval"]
    recorder = dtrace = None
    if run.trace:
        recorder = Recorder()
        (recorder.install_serving() if cell.kind == "chat"
         else recorder.install_ingest(sut.engine))
        if run.device == "cuda":
            dtrace = DeviceTrace()
            dtrace.warm()
    out = cell.drive(sut, recorder, dtrace)
    setup_s = run.window_start - t0
    on_cuda = run.device == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    state = cell.collect(sut)
    if recorder is not None:
        recorder.uninstall()
    if dtrace is not None:
        dtrace.collect()
    wdir = os.environ["WEIGHTS_DIR"]
    models = run.cfg["models"]
    vocab_dirs = {"text": weights.model_dir(wdir, models["text"]["id"]),
                  "clip": weights.model_dir(wdir, models["clip"]["id"])}
    flat, parts = sut.flat, dict(sut.parts)
    sut.close()
    del sut
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    print("setup " + json.dumps({"setup_s": setup_s, "parts": parts}), file=sys.stderr)
    ref = judge.Reference(run.cfg, flat, vocab_dirs, run.device)
    limits = run.cell["limits"]
    if cell.kind == "chat":
        checks = judge.chat(state, run.data, ref, retrieval_cfg, limits)
    else:
        checks = judge.ingest(cell.acked, state, ref, limits)

    device = {"platform": "gpu" if on_cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": checks.ok, "attempted": out["attempted"], "failed": out["failed"]}
    units = {m["name"]: m["unit"] for m in manifest.metrics(run.name, run.trace)}
    if run.trace:
        window = (dtrace.window if dtrace is not None
                  else (run.window_start, run.window_start + run.seconds))
        records = {"recorder": recorder, "trace": dtrace, "window": window, "config": run.cfg,
                   "reference": ref}
        metrics = {}
        for name in units:
            value = manifest.reader(name)(records)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
        if dtrace is not None:
            from bench_port.harness.trace import union_length

            lo, hi = dtrace.window
            device["busy_s"] = union_length([(s, e) for _, s, e in dtrace.events], lo, hi)
            device["window_s"] = hi - lo
            result["breakdown"] = breakdown(dtrace, recorder)
    else:
        values = {**out["metrics"], "setup_s": setup_s}
        metrics = {name: {"value": _number(values[name]), "unit": units[name]}
                   for name in units}
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = checks.table()
    if not checks.ok or out["failed"]:
        result["correct"] = False
    bad = loaded_forbidden()  # after the window, the check and every reader
    if bad:
        print(f"bench_port: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("diagnostics " + json.dumps(checks.diagnostics()), file=sys.stderr)
    for name, row in checks.table().items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
