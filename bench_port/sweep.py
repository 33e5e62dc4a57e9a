"""Find the knee of a chat configuration under open-loop traffic, on the chip.

    python3 bench_port/sweep.py --workload <cell> --rates 30,40,50 --seconds 15 --seed <n>

One set-up of the cell's configuration, then the cell's own open-loop
traffic at each rate in turn (each with its warm-up and its own queries). A rate is sustained when at least 99% of the
window's requests are answered, the answers completed in the window keep
up with the offered rate (97% of it or more), and neither the p50 nor the
p95 of the window's second half is more than 25% above its first half's
(no growing queue). Prints one JSON line a rate and the knee, the highest
rate below the first one not sustained. An open-loop cell runs at about
four fifths of it (``rate_rps`` in its file) and records it (``knee_rps``).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse

    import numpy as np

    from bench_port import run as bench_run
    from bench_port.harness import cells
    from bench_port.harness.manifest import Manifest

    ap = argparse.ArgumentParser(prog="bench_port/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    spec = Manifest(ROOT).cell(args.workload)
    if spec["traffic"].get("arrival") != "poisson":
        print(f"bench_port: {args.workload} has no open-loop traffic", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="bench_port_sweep_")
    run_args = bench_run.parse(["--workload", args.workload, "--seed", str(args.seed),
                                "--seconds", str(args.seconds)])
    run = bench_run.Run(run_args, spec, tmp, "cuda")
    knee, broken = None, False
    try:
        _, sut = bench_run.prepare(run, time.monotonic())
        for salt, rate in enumerate(float(r) for r in args.rates.split(",")):
            cell = cells.ChatCell(run, rate=rate, salt=salt + 1)  # no query repeats a rate's
            out = cell.drive(sut, None, None)
            mid = run.window_start + args.seconds / 2
            first = [lat for t, lat in cell.window_latency if t < mid]
            second = [lat for t, lat in cell.window_latency if t >= mid]
            answered = 1 - out["failed"] / max(out["attempted"], 1)
            p50, p95 = ([float(np.percentile(x, q)) if x else float("inf") for x in (first, second)]
                        for q in (50, 95))
            keeps_up = out["metrics"]["chat_qps"] >= 0.97 * rate
            ok = (answered >= 0.99 and keeps_up and p50[1] <= 1.25 * p50[0]
                  and p95[1] <= 1.25 * p95[0])
            if ok and not broken:  # the highest rate below the first unsustained one
                knee = rate
            broken = broken or not ok
            print(json.dumps({"rate_rps": rate, "sustained": ok, "answered": answered,
                              "p50_halves_ms": p50, "p95_halves_ms": p95,
                              **{k: v for k, v in out["metrics"].items()}}), flush=True)
        sut.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"workload": args.workload, "knee_rps": knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
