"""The lower-precision control of a cell: it has to come out not correct.

    python3 bench_port/control.py --workload <cell> --seeds <a,b,c> --seconds <s>

The configuration lists its controls under ``control``:

* ``{"program_config": <name>}``: the system's own lower-precision path
  (the bf16 configuration's control is the system with W8A8 towers): the
  cell runs on that configuration, judged by the cell's limits;
* ``{"reference_bits": {...}}``: the plain reference with each tower's
  linear layers rounded to the format given (``fp8`` for the bf16 towers,
  ``int4`` for W8A8's int8 ones), put in the system's place for a seeded
  sample of the cell's requests (as many as a run checks, the longest query
  in it) and judged against the float32 reference.

Each seed prints the numbers with their limits and whether they pass;
the benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def reference_control(spec: dict, seed: int, seconds: float, device: str) -> dict:
    """The quantised reference's answers to the cell's requests, judged."""

    import numpy as np

    from bench_port.harness import cells, corpus, judge, system, weights

    cfg, mix, cell = spec["config"], spec["traffic"], spec["cell"]

    class _Run:
        pass

    run = _Run()
    run.seed, run.seconds, run.mix, run.cell = seed, seconds, mix, cell
    run.data = system.Dataset(cfg, seed)
    requests = cells.ChatCell(run).requests
    rng = np.random.default_rng([seed % (1 << 63), 3])
    longest = max(range(len(requests)), key=lambda i: len(requests[i]["query"].split()))
    pick = set(rng.permutation(len(requests))[: cell["check_sample"] - 1].tolist()) | {longest}
    sample = [requests[i] for i in sorted(pick)]
    with tempfile.TemporaryDirectory(prefix="bench_port_control_") as tmp:
        flat = weights.make_all(cfg["models"], seed, device, tmp)
        dirs = {r: weights.model_dir(tmp, cfg["models"][r]["id"]) for r in ("text", "clip")}
        corpus.write_vocabularies([dirs["text"]], dirs["clip"])
        rcfg = cfg["retrieval"]
        bits = next(c["reference_bits"] for c in cfg["control"] if "reference_bits" in c)
        low = judge.Reference(cfg, flat, dirs, device, bits=bits)
        served = judge.reference_serve(sample, run.data, low, rcfg)
        del low
        ref = judge.Reference(cfg, flat, dirs, device)
        checks = judge.chat(served, run.data, ref, rcfg, cell["limits"])
    return {"correct": checks.ok, "checks": checks.table(), "diagnostics": checks.diagnostics()}


def main(argv=None) -> int:
    import argparse

    from bench_port import run as bench_run
    from bench_port.harness.manifest import Manifest

    ap = argparse.ArgumentParser(prog="bench_port/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    manifest = Manifest(ROOT)
    spec = manifest.cell(args.workload)
    kind = spec["traffic"]["kind"]
    for seed, control in ((int(s), c) for s in args.seeds.split(",")
                          for c in spec["config"]["control"]):
        t = time.monotonic()
        if "reference_bits" in control and kind != "chat":
            continue  # an ingest cell's control is the system's own path
        if "program_config" in control:
            rc = bench_run.main(["--workload", args.workload, "--seed", str(seed), "--seconds",
                                 str(args.seconds), "--trace", "0"],
                                config=control["program_config"], t0=time.monotonic())
            print(json.dumps({"control": control, "seed": seed, "rc": rc}))
        else:
            out = reference_control(spec, seed, args.seconds, "cuda")
            print(json.dumps({"control": control, "seed": seed, **out,
                              "seconds": time.monotonic() - t}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
