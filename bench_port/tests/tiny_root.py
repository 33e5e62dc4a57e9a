"""A copy of the benchmark with one tiny configuration and two cells added
the way a later change adds them: files, and entries in ``BENCHMARK.json``."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

TINY_LIMITS = {"text_embed": 1e-4, "image_embed": 1e-4, "topk_gap": 5e-3, "score_err": 5e-3,
               "rerank_err": 1e-4, "final_gap": 0.5, "faults": 0}


def _shrink(m: dict) -> None:
    m.update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64)


def tiny_config(base: str = "minilm-clip-bf16") -> dict:
    with open(os.path.join(BENCH, "configs", f"{base}.json")) as fh:
        cfg = json.load(fh)
    for role in ("text", "reranker"):
        _shrink(cfg["models"][role])
    _shrink(cfg["models"]["clip"]["text_config"])
    _shrink(cfg["models"]["clip"]["vision_config"])
    cfg["models"]["clip"]["projection_dim"] = 16
    cfg["index"].update(text_rows=8192, image_rows=2048, idle_tenants=64)
    cfg["index"]["active"].update(tenants=16, text_rows=1024, image_rows=128, chunks_per_doc=16)
    return cfg


def open_mix() -> dict:
    """An open-loop chat mix, as a later change adds one: ``chat-closed``'s
    requests at Poisson arrivals over 64 keep-alive connections."""

    with open(os.path.join(BENCH, "traffic", "chat-closed.json")) as fh:
        mix = json.load(fh)
    mix.update(arrival="poisson", clients=64, coalesce_max=16, why="open-loop chat")
    del mix["pool"]
    return mix


def make(root: str) -> str:
    """``root`` holds ``BENCHMARK.json`` and ``bench_port/`` with the tiny
    configuration ``tiny`` and its control's ``tiny-w8a8`` (a file only), the traffic mixes
    ``tiny-open`` and ``tiny-ingest``, and the cells ``tiny-chat`` (open
    loop) and ``tiny-ingest``."""

    shutil.copytree(BENCH, os.path.join(root, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for name, base in (("tiny", "minilm-clip-bf16"), ("tiny-w8a8", "minilm-clip-w8a8")):
        cfg = tiny_config(base)
        cfg["name"] = name
        cfg["control"] = [{"program_config": "tiny-w8a8"} if "program_config" in c else c
                          for c in cfg["control"]]
        with open(os.path.join(root, "bench_port", "configs", f"{name}.json"), "w") as fh:
            json.dump(cfg, fh)
        if name == "tiny":  # the control's configuration is a file only, as W8A8's is
            bench["configs"].append({"name": name, "source": cfg["source"],
                                     "file": f"bench_port/configs/{name}.json", "reduced": [],
                                     "why": "tiny widths for the CPU tests"})
    with open(os.path.join(BENCH, "traffic", "ingest-docs.json")) as fh:
        mix = json.load(fh)
    mix.update(doc_chunks={"median": 6, "sigma": 0.8, "min": 2, "max": 40}, warm_batches=[8, 32])
    with open(os.path.join(root, "bench_port", "traffic", "tiny-ingest.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(root, "bench_port", "traffic", "tiny-open.json"), "w") as fh:
        json.dump(open_mix(), fh)
    cells = {"tiny-chat": ("tiny-open", {"rate_rps": 8.0, "check_sample": 8,
                                         "limits": TINY_LIMITS}),
             "tiny-ingest": ("tiny-ingest", {"check_sample": 16,
                                             "limits": {"ingest_embed": 1e-4, "faults": 0}})}
    for name, (mix_name, cell) in cells.items():
        with open(os.path.join(root, "bench_port", "workloads", f"{name}.json"), "w") as fh:
            json.dump(cell, fh)
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": mix_name,
                                   "chips": 1, "why": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            chat_metric = m.get("moves", m["name"]).startswith("chat")
            if "workloads" in m and ("chat" in name) == chat_metric:
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root
