"""Recall@k of the approximate top-k (X1) against the exact one, by document
length and by the number of rows kept a 128-row bucket: the measurement
behind ``mmrag_tpu_torch.ops.kernels.APPROX_TOP``.

Rows are ``chip_smoke.py``'s ``TopicGeometry`` fill, each document's chunks a
cloud in contiguous rows, as ingest appends them, three tenants: 16-chunk
documents aligned to the buckets, and documents of 8-24, 16-48 and 32-96
chunks (means 16, 32 and 64; at the port's 1200-character chunks with 200
of overlap a 10-page PDF gives about 30), which straddle bucket edges. 16
queries near sampled rows, each with its tenant's mask; the mean and the
least recall over the queries. Plain torch on the CPU: the algorithm, not
the kernel.

    python tools/approx_recall.py [ROWS]   # default 65536
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mmrag_tpu_torch.ops.topk import topk_first  # noqa: E402

DOCS = {"16 aligned": None, "8-24": (8, 24), "16-48": (16, 48), "32-96": (32, 96)}


def main(n: int) -> None:
    d, q = 384, 16
    nb = n // 128
    for name, doc_rows in DOCS.items():
        rng = np.random.default_rng(0)
        geo = cs.TopicGeometry(rng, n, d, doc_rows=doc_rows)
        rows = torch.from_numpy(geo.rows(0, n))
        tenants = geo.doc_of % 3
        sel = rng.choice(n, q, replace=False)
        queries = torch.from_numpy(cs._near_queries(rng, rows.numpy(), sel))
        mask = torch.from_numpy(tenants[None, :] == tenants[sel][:, None])
        scores = torch.where(mask, queries @ rows.T, -1e30)
        for k in (12, 50):
            exact = topk_first(scores, k).indices
            for t in (1, 8, 16, 32, 48):
                top = topk_first(scores.reshape(q, nb, 128), t)
                ids = top.indices + torch.arange(nb)[:, None] * 128
                pick = topk_first(top.values.reshape(q, -1), k).indices
                got = torch.gather(ids.reshape(q, -1), 1, pick)
                per = [len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(got, exact)]
                print(f"rows {n} documents {name} k {k} kept a bucket {t}: "
                      f"recall {np.mean(per):.4f} least {min(per):.4f}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 65536)
