"""The general traffic generator: every mix is a data file of parameters.

Each seed gets the same sizes, tenants and gaps in another order, with
other words: the sequence is cut into blocks of ``block`` items, and every
block is the same multiset (quantiles of the mix's distributions) in an
order of its own. So any stretch of whole blocks asks for the same work
whatever the seed, and a run's spread is the system's, not the draw's.

* ``kind: chat`` -- ``/chat_pro`` requests: tenants by a Zipf law over the
  active tenants, query lengths lognormal in words, a share of requests
  with a document filter, every query unique. ``arrival: poisson`` is an
  open loop at the cell's rate (gaps are exponential quantiles), ``arrival:
  closed`` sends back to back from ``clients`` clients.
* ``kind: ingest`` -- documents for ``index_text_nodes``: tenants by a Zipf
  law, chunk counts lognormal, chunks cut from the document's text by a
  sliding window; documents' texts are made when an uploader takes them,
  from a generator seeded by the run's seed and the document's place.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

from .corpus import Text, sliding_chunks


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def zipf_counts(n_items: int, n_draws: int, s: float) -> np.ndarray:
    """How many of ``n_draws`` fall on each of ``n_items`` under Zipf(s),
    by largest remainders."""

    p = 1.0 / np.arange(1, n_items + 1) ** s
    exact = p / p.sum() * n_draws
    counts = np.floor(exact).astype(np.int64)
    rest = n_draws - counts.sum()
    counts[np.argsort(-(exact - counts), kind="stable")[:rest]] += 1
    return counts


def blocked(rng, block_values: np.ndarray, count: int) -> np.ndarray:
    """``count`` values: each block a new permutation of ``block_values``."""

    reps = -(-count // len(block_values))
    return np.concatenate([rng.permutation(block_values) for _ in range(reps)])[:count]


def zipf_block(n_items: int, block: int, s: float) -> np.ndarray:
    return np.repeat(np.arange(n_items), zipf_counts(n_items, block, s))


def chat_requests(mix: Dict, rng, text: Text, tenants: List[str], docs: Dict[str, List[str]],
                  count: int, rate: Optional[float]) -> List[Dict]:
    """``count`` requests in sending order, each ``{"at", "tenant", "query",
    "doc"}``; ``at`` (seconds from the first send) only for an open loop."""

    q, n = mix["query_words"], mix["block"]
    lengths = blocked(rng, lognormal_quantiles(n, q["median"], q["sigma"], q["min"], q["max"]),
                      count)
    who = blocked(rng, zipf_block(len(tenants), n, mix["tenant_zipf"]), count)
    filtered = blocked(rng, np.arange(n) < int(round(mix["doc_filter_share"] * n)), count)
    if mix["arrival"] == "poisson":
        gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)]) / rate
        at = np.concatenate([[0.0], np.cumsum(blocked(rng, gaps, count))[:-1]])
    else:
        at = np.zeros(count)
    seen, out = set(), []
    for i in range(count):
        tenant = tenants[who[i]]
        query = text.query(int(lengths[i]))
        while query in seen:
            query = text.query(int(lengths[i]))
        seen.add(query)
        doc = None
        if filtered[i]:
            own = docs[tenant]
            doc = own[int(rng.integers(len(own)))]
        out.append({"at": float(at[i]), "tenant": tenant, "query": query, "doc": doc})
    return out


def ingest_plan(mix: Dict, rng, tenants: List[str], count: int) -> List[Dict]:
    """``count`` documents in upload order: ``{"index", "tenant", "chunks"}``."""

    c, n = mix["doc_chunks"], mix["block"]
    sizes = blocked(rng, lognormal_quantiles(n, c["median"], c["sigma"], c["min"], c["max"]),
                    count)
    who = blocked(rng, zipf_block(len(tenants), n, mix["tenant_zipf"]), count)
    return [{"index": i, "tenant": tenants[who[i]], "chunks": int(sizes[i])}
            for i in range(count)]


def ingest_nodes(mix: Dict, seed: int, doc: Dict, sentences: List[str]) -> List[Dict]:
    """The nodes of one planned document, as an uploader sends them."""

    text = Text(np.random.default_rng([seed % (1 << 63), 7, doc["index"]]),
                sentences=sentences)
    size, overlap = mix["chunk_chars"], mix["overlap_chars"]
    body = text.passage((size - overlap) * (doc["chunks"] - 1) + size)
    chunks = sliding_chunks(body, size, overlap)[: doc["chunks"]]
    did = f"{doc['tenant']}-up{doc['index']:05d}"
    title = text.title()
    per_page = mix.get("chunks_per_page", 3)
    return [{"id": f"{did}-c{i}", "text": t,
             "metadata": {"document_id": did, "page": i // per_page + 1, "title": title}}
            for i, t in enumerate(chunks)]

