"""The two kinds of cell: served chat and ingest.

A chat cell starts the system's own HTTP server in this process and a load
generator in a child process that imports nothing but the standard
library; the requests of the warm-up and of the window come from the
cell's traffic. An ingest cell drives ``index_text_nodes`` from closed-loop
uploader threads. Both return the end-to-end numbers, what the check
needs of the system's outputs, and (traced) the records the per-layer
readers take their numbers from.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from . import traffic
from .trace import DeviceTrace, Recorder

LOADGEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loadgen.py")
GRACE_S = 60.0


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return float("inf")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _profile_window(lo: float, seconds: float, trace: Optional[DeviceTrace]) -> None:
    """Start and stop the device trace over a steady stretch of the window."""

    if trace is None:
        return
    time.sleep(max(lo + max(1.0, 0.3 * seconds) - time.monotonic(), 0.0))
    trace.start()
    time.sleep(min(4.0, 0.4 * seconds))
    trace.stop()


class ChatCell:
    kind = "chat"

    def __init__(self, run, rate: Optional[float] = None, salt: int = 0) -> None:
        self.run = run
        mix, cell = run.mix, run.cell
        self.rate = rate or cell.get("rate_rps")
        self.open = mix["arrival"] == "poisson"
        warm = mix["warmup_s"]
        count = (int(np.ceil(self.rate * (warm + run.seconds))) if self.open
                 else mix["pool"])
        rng = np.random.default_rng([run.seed % (1 << 63), 2, salt])
        self.requests = traffic.chat_requests(mix, rng, run.data.text, run.data.tenants,
                                              run.data.docs, count, self.rate)

    def warm(self, engine) -> None:
        engine.warmup_serving(max_coalesce=self.run.mix["coalesce_max"])

    def drive(self, system, recorder: Optional[Recorder], trace: Optional[DeviceTrace]) -> Dict:
        run, mix = self.run, self.run.mix
        warm = mix["warmup_s"]
        t0 = time.monotonic() + 1.0
        lo, hi = t0 + warm, t0 + warm + run.seconds
        plan = {"host": "127.0.0.1", "port": system.server.server_address[1],
                "loop": "open" if self.open else "closed", "clients": mix["clients"],
                "t0": t0, "stop_s": warm + run.seconds, "grace_s": GRACE_S,
                "timeout_s": GRACE_S + run.seconds,
                "requests": [{**r, "key": f"key-{r['tenant']}"} for r in self.requests]}
        plan_path = os.path.join(run.tmp, "plan.json")
        out_path = os.path.join(run.tmp, "served.json")
        with open(plan_path, "w") as fh:
            json.dump(plan, fh)
        gc_before = [g["collections"] for g in gc.get_stats()]
        child = subprocess.Popen([sys.executable, LOADGEN, plan_path, out_path],
                                 stdout=subprocess.DEVNULL)
        run.window_start = lo
        try:
            _profile_window(lo, run.seconds, trace)
            rc = child.wait(timeout=warm + run.seconds + GRACE_S + 60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        if rc != 0:
            raise RuntimeError(f"the load generator exited with {rc}")
        with open(out_path) as fh:
            served = json.load(fh)
        batcher = system.engine.retrieval_batcher
        print(f"serving: batch sizes {dict(sorted(batcher.batch_sizes.items()))}, "
              f"collections by generation "
              f"{[g['collections'] - b for g, b in zip(gc.get_stats(), gc_before)]}",
              file=sys.stderr)
        records = served["records"]
        window = []
        for req, rec in zip(self.requests, records):
            if rec is None:
                continue
            start = rec["due"] if self.open else rec["sent"]
            if lo <= start < hi:
                window.append((req, rec))
        lat = [(rec["done"] - (rec["due"] if self.open else rec["sent"])) * 1e3
               if rec["status"] == 200 else float("inf") for _, rec in window]
        never = sum(1 for req, rec in zip(self.requests, records)
                    if rec is None and self.open and lo <= t0 + req["at"] < hi)
        lat += [float("inf")] * never
        late = [(rec["sent"] - rec["due"]) * 1e3 for _, rec in window]
        done_in = sum(1 for rec in records if rec is not None and rec["status"] == 200
                      and lo <= rec["done"] < hi)
        failed = sum(1 for _, rec in window if rec["status"] != 200) + never
        print(f"loadgen: {len(window) + never} requests in the window, {failed} failed, "
              f"p50 {_percentile(lat, 50):.3f} ms p95 {_percentile(lat, 95):.3f} ms, "
              f"lateness p99 {_percentile(late, 99):.3f} ms max {max(late, default=0):.3f} ms, "
              f"{served['unfinished']} clients unfinished", file=sys.stderr)
        self.window_requests = [(req, rec) for req, rec in window if rec["status"] == 200]
        self.window_latency = [(rec["due"] if self.open else rec["sent"], lat_ms)
                               for (_, rec), lat_ms in zip(window, lat)]
        return {"attempted": len(window) + never, "failed": failed,
                "metrics": {"chat_p50_ms": _percentile(lat, 50),
                            "chat_p95_ms": _percentile(lat, 95),
                            "chat_qps": done_in / run.seconds}}

    def collect(self, system) -> List[Dict]:
        """What the check reads of the system: a seeded sample of the
        window's answered requests (the longest query always in it), with
        the query embeddings and hit lists the served path cached."""

        from mmrag_tpu_torch import cache

        engine = system.engine
        ok = self.window_requests
        if not ok:
            return []
        rng = np.random.default_rng([self.run.seed % (1 << 63), 3])
        longest = max(range(len(ok)), key=lambda i: len(ok[i][0]["query"].split()))
        pick = set(rng.permutation(len(ok))[: self.run.cell["check_sample"] - 1].tolist())
        pick.add(longest)
        out = []
        for i in sorted(pick):
            req, rec = ok[i]
            emb = cache.get_query_embeddings(req["query"])
            doc_tag = req["doc"].encode().hex() if req["doc"] else "None"
            key = f"{cache.normalize_query(req['query'])}\x00doc={doc_tag}"
            payload = cache.get_retrieval_results(req["tenant"], key,
                                                  engine.versions.get(req["tenant"]))
            if emb is None or payload is None:
                raise RuntimeError(f"the served path's caches lost request {i}")
            out.append({"tenant": req["tenant"], "query": req["query"], "doc": req["doc"],
                        "text_emb": np.asarray(emb["text"], np.float32),
                        "image_emb": np.asarray(emb["image"], np.float32),
                        "text": payload["text"], "images": payload["images"],
                        "final": rec["results"]})
        return out


class IngestCell:
    kind = "ingest"

    def __init__(self, run) -> None:
        self.run = run
        rng = np.random.default_rng([run.seed % (1 << 63), 4])
        self.plan = traffic.ingest_plan(run.mix, rng, run.data.tenants, run.mix["plan_docs"])
        self.acked: List[Dict] = []

    def warm(self, engine) -> None:
        """Each batch bucket the documents' chunk counts reach, at the
        chunks' sequence bucket."""

        text = self.run.data.text
        size = self.run.mix["chunk_chars"]
        for n in self.run.mix["warm_batches"]:
            engine.runtime.embed_text_batch([text.passage(size) for _ in range(n)])

    def drive(self, system, recorder: Optional[Recorder], trace: Optional[DeviceTrace]) -> Dict:
        from mmrag_tpu_torch.rag.index_build import index_text_nodes

        run, mix = self.run, self.run.mix
        engine = system.engine
        sentences = run.data.text.sentences
        lock = threading.Lock()
        cursor = iter(self.plan)
        t0 = time.monotonic()
        lo, hi = t0 + mix["warmup_s"], t0 + mix["warmup_s"] + run.seconds
        run.window_start = lo
        done: List[tuple] = []
        errors: List[BaseException] = []

        def uploader():
            while time.monotonic() < hi:
                with lock:
                    doc = next(cursor, None)
                if doc is None:
                    errors.append(RuntimeError("the ingest plan ran out of documents"))
                    return
                nodes = traffic.ingest_nodes(mix, run.seed, doc, sentences)
                try:
                    index_text_nodes(doc["tenant"], nodes, engine)
                except BaseException as exc:  # a failed upload fails the run
                    errors.append(exc)
                    return
                end = time.monotonic()
                with lock:
                    done.append((end, len(nodes)))
                    self.acked.extend({**n, "tenant": doc["tenant"]} for n in nodes)

        threads = [threading.Thread(target=uploader, daemon=True) for _ in range(mix["uploaders"])]
        for t in threads:
            t.start()
        _profile_window(lo, run.seconds, trace)
        for t in threads:
            t.join(run.seconds + GRACE_S + mix["warmup_s"])
        if any(t.is_alive() for t in threads):
            raise RuntimeError("an uploader did not finish")
        if errors:
            raise errors[0]
        chunks = sum(n for end, n in done if lo <= end < hi)
        return {"attempted": len(done), "failed": 0,
                "metrics": {"ingest_chunks_per_s": chunks / run.seconds}}

    def collect(self, system) -> Dict:
        engine = system.engine
        index = engine.text_index
        rng = np.random.default_rng([self.run.seed % (1 << 63), 5])
        n = len(self.acked)
        longest = max(range(n), key=lambda i: len(self.acked[i]["text"])) if n else 0
        sample = sorted(set(rng.permutation(n)[: self.run.cell["check_sample"] - 1].tolist())
                        | ({longest} if n else set()))
        wanted = {self.acked[i]["id"] for i in sample}
        state = {}
        for node in self.acked:
            cid = node["id"]
            row = index._chunk_to_row.get(cid)
            if row is None:
                continue
            vec = index._slab[row].float().cpu().numpy() if cid in wanted else None
            state[cid] = (index._row_user[row], index._row_doc[row], bool(index._row_live[row]),
                          vec)
        cat = engine.metadata.get_chunks_batch([node["id"] for node in self.acked])
        catalogue = {c: (ch.user_id, ch.document_id, ch.text) for c, ch in cat.items()}
        return {"index": state, "catalogue": catalogue, "sample": sample}
