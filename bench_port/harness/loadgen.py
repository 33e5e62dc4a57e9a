"""The load generator: a process of its own, standard library only.

``python3 loadgen.py PLAN.json OUT.json``. The plan names the server, the
loop (``open``: each request is sent when it is due, by whichever of
``clients`` keep-alive connections is free; ``closed``: each client sends
its next request when the last one returned), the start time on the
system's monotonic clock (which the parent process shares), and the
requests. Each request's latency is timed from when it was due (open loop)
or sent (closed loop) to its last byte; how late each send was is written
too. The served final hits of every answer go back for the check.
"""

from __future__ import annotations

import http.client
import json
import queue
import sys
import threading
import time


def _post(conn, body: bytes, key: str):
    conn.request("POST", "/chat_pro", body=body,
                 headers={"Content-Type": "application/json", "X-API-Key": key})
    resp = conn.getresponse()
    return resp.status, resp.read()


def _connect(plan):
    return http.client.HTTPConnection(plan["host"], plan["port"], timeout=plan["timeout_s"])


def _serve_one(conn, plan, req, due: float, out: list, i: int):
    body = json.dumps({"query": req["query"], **({"video_id": req["doc"]} if req["doc"]
                                                  else {})}).encode()
    sent = time.monotonic()
    try:
        status, data = _post(conn, body, req["key"])
    except (OSError, http.client.HTTPException) as exc:
        conn.close()
        out[i] = {"due": due, "sent": sent, "done": time.monotonic(), "status": -1,
                  "error": repr(exc)}
        return _connect(plan)
    done = time.monotonic()
    rec = {"due": due, "sent": sent, "done": done, "status": status}
    if status == 200:
        payload = json.loads(data)
        rec["results"] = [{k: h.get(k) for k in ("chunk_id", "user_id", "document_id",
                                                 "modality", "score", "rerank_score",
                                                 "combined_score")}
                          for h in payload.get("results", [])]
    else:
        rec["error"] = data[:200].decode(errors="replace")
    out[i] = rec
    return conn


def run(plan) -> dict:
    reqs = plan["requests"]
    out = [None] * len(reqs)
    t0, stop_at = plan["t0"], plan["t0"] + plan["stop_s"]
    if plan["loop"] == "open":
        work: "queue.Queue" = queue.Queue()

        def client():
            conn = _connect(plan)
            while True:
                item = work.get()
                if item is None:
                    conn.close()
                    return
                i, due = item
                conn = _serve_one(conn, plan, reqs[i], due, out, i)

        threads = [threading.Thread(target=client, daemon=True) for _ in range(plan["clients"])]
        for t in threads:
            t.start()
        for i, req in enumerate(reqs):
            due = t0 + req["at"]
            if due >= stop_at:
                break
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            work.put((i, due))
        for _ in threads:
            work.put(None)
    else:
        cursor = iter(range(len(reqs)))
        lock = threading.Lock()

        def client():
            conn = _connect(plan)
            wait = t0 - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            while time.monotonic() < stop_at:
                with lock:
                    i = next(cursor, None)
                if i is None:
                    break
                conn = _serve_one(conn, plan, reqs[i], time.monotonic(), out, i)
            conn.close()

        threads = [threading.Thread(target=client, daemon=True) for _ in range(plan["clients"])]
        for t in threads:
            t.start()
    deadline = stop_at + plan["grace_s"]
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    return {"records": out, "unfinished": sum(t.is_alive() for t in threads)}


def main(argv) -> int:
    with open(argv[1]) as fh:
        plan = json.load(fh)
    result = run(plan)
    with open(argv[2], "w") as fh:
        json.dump(result, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
