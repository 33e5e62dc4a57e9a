"""The check that decides ``correct``: what the timed path served, against
the plain reference.

Chat, for a sample drawn from the seed of the requests the window answered
(the one with the longest query always in it), layer by layer:

* ``text_embed`` / ``image_embed``: ``1 - cos`` of the query embeddings the
  served path made (MiniLM, CLIP text; read back from the system's
  embedding cache) against the reference's, over the reference's own
  tokenisation; the widest over the sample;
* ``topk_gap``: for every hit the system returned, how far the reference's
  score of that row lies below the reference's k-th best over the asking
  tenant's (and document's) rows; the widest, in cosine;
* ``score_err`` / ``score_rms``: the widest and the root-mean-square gap
  between a returned hit's score and the reference's score of its row;
* ``rerank_err`` / ``rerank_rms``: the same for the served rerank logits
  against the reference cross-encoder's logits of the same pairs;
* ``final_gap``: the reference runs the whole pipeline (its own top-k,
  rerank, resort and fusion); for each served final hit, how far the
  reference's combined score of it lies below the reference's last final
  hit, in z units (a hit outside the reference's candidates counts 1000);
* ``faults``: a count that must be 0: a hit of another tenant or document,
  a hit list shorter than ``min(k, rows the predicate keeps)``, a repeated
  hit, a rerank set that is not the head by score, and served final hits
  that differ from the fusion of the system's own lists.

A cell's ``limits`` name the numbers it compares (those whose control
reading lies three times or more above the sound runs' readings); the
rest are printed as diagnostics.

Ingest: every acknowledged chunk is in the index under its tenant and
document and in the catalogue with its text; for a sample, ``ingest_embed``
is ``1 - cos`` of the row the index holds against the reference's MiniLM
embedding of the text the ingest embeds.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..reference import encoders, retrieval
from ..reference.tokenizers import ClipBPE, WordPiece

ABSENT = 1000.0


class Reference:
    """The three reference towers on ``device`` and their tokenizers."""

    def __init__(self, cfg: Dict, flat: Dict, vocab_dirs: Dict[str, str], device: str,
                 bits: Optional[Dict[str, int]] = None) -> None:
        import os

        from . import weights

        encoders.exact_float32()
        self.device = device
        self.models = cfg["models"]
        self.bits = bits or {}
        self.text = encoders.to_torch(weights.nest(flat["text"]), device)
        self.cross = encoders.to_torch(weights.nest(flat["reranker"]), device)
        clip = weights.nest(flat["clip"])
        self.clip = encoders.to_torch({"text": clip["text"],
                                       "text_projection": clip["text_projection"]}, device)
        self.wp = WordPiece.from_file(os.path.join(vocab_dirs["text"], "vocab.txt"))
        self.bpe = ClipBPE.from_files(os.path.join(vocab_dirs["clip"], "vocab.json"),
                                      os.path.join(vocab_dirs["clip"], "merges.txt"))

    def _t(self, a):
        import torch

        return torch.as_tensor(a, device=self.device)

    def embed_text(self, texts: List[str], block: int = 64) -> np.ndarray:
        import torch

        cap = self.models["text"]["max_seq_length"]
        heads = self.models["text"]["num_attention_heads"]
        out = []
        with torch.no_grad():
            for i in range(0, len(texts), block):
                ids, mask = self.wp.single(texts[i:i + block], cap)
                out.append(encoders.minilm_embed(self.text, self._t(ids), self._t(mask), heads,
                                                 self.bits.get("text")).cpu().numpy())
        return np.concatenate(out)

    def embed_query_image(self, texts: List[str]) -> np.ndarray:
        import torch

        t = self.models["clip"]["text_config"]
        ids, mask = self.bpe.encode(texts, t["max_position_embeddings"])
        with torch.no_grad():
            emb = encoders.clip_text_embed(self.clip, self._t(ids), self._t(mask),
                                           heads=t["num_attention_heads"],
                                           bits=self.bits.get("clip"))
        return emb.cpu().numpy()

    def rerank(self, queries: List[str], passages: List[str], block: int = 64) -> np.ndarray:
        import torch

        m = self.models["reranker"]
        out = []
        with torch.no_grad():
            for i in range(0, len(passages), block):
                ids, mask, tt = self.wp.pairs(queries[i:i + block], passages[i:i + block],
                                              m["max_length"])
                out.append(encoders.cross_logits(self.cross, self._t(ids), self._t(mask),
                                                 self._t(tt), m["num_attention_heads"],
                                                 self.bits.get("reranker")).cpu().numpy())
        return np.concatenate(out) if out else np.zeros(0, np.float32)


class Checks:
    """The numbers of a check. Those the cell's ``limits`` name are
    compared, each with its limit (``ok`` when none is above it); the others
    are printed as diagnostics only."""

    def __init__(self, limits: Dict[str, float]) -> None:
        self.limits = limits
        self.values: Dict[str, float] = {"faults": 0.0}
        self._squares: Dict[str, List[float]] = {}

    def worst(self, name: str, value: float) -> None:
        self.values[name] = max(self.values.get(name, 0.0), float(value))

    def spread(self, name: str, value: float) -> None:
        """One error of a root-mean-square number (and of its widest)."""

        self._squares.setdefault(name, []).append(float(value) ** 2)
        self.values[name] = float(np.sqrt(np.mean(self._squares[name])))

    def fault(self) -> None:
        self.values["faults"] += 1

    @property
    def ok(self) -> bool:
        return all(np.isfinite(self.values.get(k, 0.0)) and self.values.get(k, 0.0) <= lim
                   for k, lim in self.limits.items())

    def table(self) -> Dict[str, Dict[str, float]]:
        return {k: {"value": self.values.get(k, 0.0), "limit": lim}
                for k, lim in self.limits.items()}

    def diagnostics(self) -> Dict[str, float]:
        return {k: v for k, v in self.values.items() if k not in self.limits}


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


class _Slabs:
    """The active tenants' rows as installed (float32, unit), with owners."""

    def __init__(self, data, device) -> None:
        import torch

        self.rows = {"text": data.active_rows("text", device),
                     "images": data.active_rows("image", device)}
        self.tenant = {"text": np.asarray(data.text_tenant), "images": np.asarray(data.image_tenant)}
        self.doc = {"text": np.asarray(data.text_doc), "images": np.asarray(data.image_doc)}
        self.ids = {"text": data.text_ids, "images": data.image_ids}
        self.row = {"text": data.text_row, "images": data.image_row}
        self.device = device
        self._torch = torch

    def scores(self, kind: str, query: np.ndarray, tenant: str, doc: Optional[str]):
        keep = self.tenant[kind] == tenant
        if doc:
            keep &= self.doc[kind] == doc
        keep_t = self._torch.as_tensor(keep, device=self.device)
        q = self._torch.as_tensor(np.asarray(query, np.float32), device=self.device)
        return retrieval.masked_scores(q, self.rows[kind], keep_t), int(keep.sum())


def reference_serve(requests: List[Dict], data, ref: Reference, rcfg: Dict,
                    slabs: Optional[_Slabs] = None) -> List[Dict]:
    """The reference's own answers to ``requests`` (each ``tenant``,
    ``query``, ``doc``), in the shape :func:`chat` reads the system's in:
    embeddings, the top-k lists, the rerank of the head, resort, fusion."""

    import torch

    slabs = slabs or _Slabs(data, ref.device)
    queries = [r["query"] for r in requests]
    q_text, q_image = ref.embed_text(queries), ref.embed_query_image(queries)
    k_of = {"text": rcfg["index_topk_text"], "images": rcfg["index_topk_image"]}
    out, pairs_q, pairs_p, heads = [], [], [], []
    for i, r in enumerate(requests):
        item = {"tenant": r["tenant"], "query": r["query"], "doc": r["doc"],
                "text_emb": q_text[i], "image_emb": q_image[i]}
        for kind, q in (("text", q_text[i]), ("images", q_image[i])):
            scores, n_keep = slabs.scores(kind, q, r["tenant"], r["doc"])
            k = min(k_of[kind], n_keep)
            top = torch.topk(scores, k)
            item[kind] = [{"chunk_id": slabs.ids[kind][j], "user_id": r["tenant"],
                           "document_id": str(slabs.doc[kind][j]), "score": v,
                           "rerank_score": None}
                          for j, v in zip(top.indices.tolist(), top.values.tolist())]
        for h in item["text"][: rcfg["rerank_topk"]]:
            pairs_q.append(r["query"])
            pairs_p.append(data.text_body[data.text_row[h["chunk_id"]]])
            heads.append(h)
        out.append(item)
    for h, logit in zip(heads, ref.rerank(pairs_q, pairs_p)):
        h["rerank_score"] = float(logit)
    for item in out:
        item["text"] = retrieval.resort(item["text"])
        item["fused"] = retrieval.fuse(item["text"], item["images"], 10 ** 6)
        item["final"] = item["fused"][: rcfg["final_n"]]
    return out


def chat(served: List[Dict], data, ref: Reference, rcfg: Dict,
         limits: Dict[str, float]) -> Checks:
    """``served``: one dict a sampled request: ``tenant``, ``query``,
    ``doc``, ``text_emb``, ``image_emb``, ``text`` and ``images`` (the
    system's hit lists, in its order), ``final`` (the served hits)."""

    checks = Checks(limits)
    slabs = _Slabs(data, ref.device)
    want = reference_serve(served, data, ref, rcfg, slabs)
    k_of = {"text": rcfg["index_topk_text"], "images": rcfg["index_topk_image"]}
    head, final_n = rcfg["rerank_topk"], rcfg["final_n"]
    pairs_q, pairs_p, served_logits = [], [], []
    for s, w in zip(served, want):
        checks.worst("text_embed", 1.0 - _cos(s["text_emb"], w["text_emb"]))
        checks.worst("image_embed", 1.0 - _cos(s["image_emb"], w["image_emb"]))
        for kind, q in (("text", w["text_emb"]), ("images", w["image_emb"])):
            scores, n_keep = slabs.scores(kind, q, s["tenant"], s["doc"])
            k = min(k_of[kind], n_keep)
            kth = min((h["score"] for h in w[kind]), default=float("-inf"))
            ids = [h["chunk_id"] for h in s[kind]]
            if len(ids) != k or len(set(ids)) != len(ids):
                checks.fault()
            for h in s[kind]:
                r = slabs.row[kind].get(h["chunk_id"])
                if (r is None or slabs.tenant[kind][r] != s["tenant"]
                        or h["user_id"] != s["tenant"]
                        or (s["doc"] and slabs.doc[kind][r] != s["doc"])):
                    checks.fault()
                    continue
                ref_score = float(scores[r])
                checks.worst("topk_gap", kth - ref_score)
                checks.worst("score_err", abs(h["score"] - ref_score))
                checks.spread("score_rms", h["score"] - ref_score)
        reranked = [h for h in s["text"] if h.get("rerank_score") is not None]
        plain = [h for h in s["text"] if h.get("rerank_score") is None]
        if (len(reranked) != min(head, len(s["text"]))
                or (plain and reranked and max(h["score"] for h in plain)
                    > min(h["score"] for h in reranked))):
            checks.fault()
        for h in reranked:
            if h["chunk_id"] in data.text_row:
                pairs_q.append(s["query"])
                pairs_p.append(data.text_body[data.text_row[h["chunk_id"]]])
                served_logits.append(h["rerank_score"])
        own = retrieval.fuse(s["text"], s["images"], final_n)
        if ([h["chunk_id"] for h in own] != [h["chunk_id"] for h in s["final"]]
                or any(a["combined_score"] != b["combined_score"]
                       for a, b in zip(own, s["final"]))):
            checks.fault()
        combined = {h["chunk_id"]: h["combined_score"] for h in w["fused"]}
        if len(w["fused"]) >= final_n:
            last = w["fused"][final_n - 1]["combined_score"]
            for h in s["final"]:
                c = combined.get(h["chunk_id"])
                checks.worst("final_gap", ABSENT if c is None else last - c)
    for got, logit in zip(served_logits, ref.rerank(pairs_q, pairs_p)):
        checks.worst("rerank_err", abs(got - float(logit)))
        checks.spread("rerank_rms", got - float(logit))
    return checks


def ingest(acked: List[Dict], program: Dict, ref: Reference,
           limits: Dict[str, float]) -> Checks:
    """``acked``: every acknowledged node with its tenant; ``program``: the
    system's state after the window: ``index`` ``{chunk_id: (tenant, doc,
    live, row or None)}``, ``catalogue`` ``{chunk_id: (tenant, doc,
    text)}``, and ``sample``, the indices of ``acked`` whose rows it holds."""

    sample = program["sample"]

    checks = Checks(limits)
    index, catalogue = program["index"], program["catalogue"]
    for node in acked:
        cid, doc = node["id"], node["metadata"]["document_id"]
        got = index.get(cid)
        if got is None or got[0] != node["tenant"] or got[1] != doc or not got[2]:
            checks.fault()
        cat = catalogue.get(cid)
        if cat is None or cat != (node["tenant"], doc, node["text"]):
            checks.fault()
    texts = [retrieval.metadata_text(acked[i]["text"], acked[i]["metadata"]) for i in sample]
    want = ref.embed_text(texts) if texts else np.zeros((0, 1))
    for i, w in zip(sample, want):
        got = index.get(acked[i]["id"])
        if got is None or got[3] is None:
            continue
        checks.worst("ingest_embed", 1.0 - _cos(got[3], w))
    return checks
