"""The deployment a configuration file describes, built around the system.

:class:`Dataset` is the benchmark's own data, made from the seed: the
active tenants (a Zipf law over their rows), their documents, chunk texts
and unit rows, and the idle tenants' filler rows. :func:`build` turns it
into the system under test: settings, the runtime with the configuration's
towers, the engine, the two slabs, the catalogue, the warm-up and the
server, timing each part of the set-up.
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from . import corpus, traffic, weights

BLOCK = 131072  # filler rows made and installed at a time


def _gen_seed(seed: int, *keys: int) -> int:
    return int(np.random.SeedSequence([seed % (1 << 63), *keys]).generate_state(1, np.uint64)[0]
               >> 1)


def unit_rows(seed: int, key: int, n: int, d: int, device):
    """``n`` seeded unit rows (float32, on ``device``)."""

    import torch

    gen = torch.Generator(device=device).manual_seed(_gen_seed(seed, key))
    x = torch.randn(n, d, generator=gen, device=device, dtype=torch.float32)
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


class Dataset:
    def __init__(self, cfg: Dict, seed: int) -> None:
        ix = cfg["index"]
        act = ix["active"]
        self.seed = seed
        self.tenants = [f"t{i:03d}" for i in range(act["tenants"])]
        counts = traffic.zipf_counts(len(self.tenants), act["text_rows"], act["zipf"])
        img_counts = traffic.zipf_counts(len(self.tenants), act["image_rows"], act["zipf"])
        per_doc = act["chunks_per_doc"]
        rng = np.random.default_rng([seed % (1 << 63), 1])
        self.text = corpus.Text(rng)
        self.text_ids: List[str] = []
        self.text_tenant: List[str] = []
        self.text_doc: List[str] = []
        self.text_meta: List[Dict] = []
        self.docs: Dict[str, List[str]] = {}
        self.titles: Dict[str, str] = {}
        for t, n in zip(self.tenants, counts):
            n_docs = max(1, -(-int(n) // per_doc))
            self.docs[t] = [f"{t}-d{k:03d}" for k in range(n_docs)]
            for j in range(int(n)):
                doc = self.docs[t][j // per_doc]
                if doc not in self.titles:
                    self.titles[doc] = self.text.title()
                self.text_ids.append(f"{t}-t{j}")
                self.text_tenant.append(t)
                self.text_doc.append(doc)
                self.text_meta.append({"page": j % per_doc // 3 + 1,
                                       "title": self.titles[doc]})
        self.text_body = self.text.passages(len(self.text_ids), act["chunk_chars"])
        self.image_ids, self.image_tenant, self.image_doc = [], [], []
        for t, n in zip(self.tenants, img_counts):
            for j in range(int(n)):
                self.image_ids.append(f"{t}-i{j}")
                self.image_tenant.append(t)
                self.image_doc.append(self.docs[t][j % len(self.docs[t])])
        self.text_row = {c: i for i, c in enumerate(self.text_ids)}
        self.image_row = {c: i for i, c in enumerate(self.image_ids)}
        self.idle = ix["idle_tenants"]
        self.text_rows, self.image_rows = ix["text_rows"], ix["image_rows"]
        self.text_dim = cfg["models"]["text"]["hidden_size"]
        self.image_dim = cfg["models"]["clip"]["projection_dim"]

    def active_rows(self, modality: str, device):
        """The active tenants' unit rows, as installed (float32)."""

        if modality == "text":
            return unit_rows(self.seed, 11, len(self.text_ids), self.text_dim, device)
        return unit_rows(self.seed, 12, len(self.image_ids), self.image_dim, device)

    def filler(self, modality: str, start: int, n: int, device):
        """Rows ``[start, start + n)`` of the idle tenants' filler."""

        d = self.text_dim if modality == "text" else self.image_dim
        key = (13 if modality == "text" else 14) * 1_000_003 + start // BLOCK
        return unit_rows(self.seed, key, n, d, device)


def settings_env(cfg: Dict, tmp: str, tenants: List[str]) -> Dict[str, str]:
    keys = {f"key-{t}": t for t in tenants}
    env = {
        "TPU_INDEX_DIR": os.path.join(tmp, "index"),
        "NOTES_DB_PATH": os.path.join(tmp, "notes.db"),
        "WEIGHTS_DIR": os.path.join(tmp, "weights"),
        "INGEST_CACHE_DIR": os.path.join(tmp, "cache"),
        "MEDIA_DIR": os.path.join(tmp, "media"),
        "THUMBS_DIR": os.path.join(tmp, "thumbs"),
        "CHECKPOINT_DIR": os.path.join(tmp, "checkpoints"),
        "API_KEYS": json.dumps(keys),
        "MODEL_TEXT": cfg["models"]["text"]["id"],
        "MODEL_CLIP": cfg["models"]["clip"]["id"],
        "RERANKER_MODEL": cfg["models"]["reranker"]["id"],
    }
    env.update({k: str(v) for k, v in cfg["env"].items()})
    return env


def bert_config(m: Dict):
    from mmrag_tpu_torch.models.bert import BertConfig

    return BertConfig(vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
                      num_layers=m["num_hidden_layers"], num_heads=m["num_attention_heads"],
                      intermediate_size=m["intermediate_size"],
                      max_position=m["max_position_embeddings"],
                      type_vocab_size=m["type_vocab_size"], layer_norm_eps=m["layer_norm_eps"],
                      gelu_approximate=m["hidden_act"] != "gelu")


def clip_config(m: Dict):
    from mmrag_tpu_torch.models.clip import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

    v, t = m["vision_config"], m["text_config"]
    return CLIPConfig(
        vision=CLIPVisionConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                                hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
                                num_heads=v["num_attention_heads"],
                                intermediate_size=v["intermediate_size"],
                                layer_norm_eps=v["layer_norm_eps"]),
        text=CLIPTextConfig(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                            num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                            intermediate_size=t["intermediate_size"],
                            max_position=t["max_position_embeddings"],
                            layer_norm_eps=t["layer_norm_eps"]),
        projection_dim=m["projection_dim"])


class System:
    """The engine, its server and the set-up times of a run."""

    def __init__(self) -> None:
        self.parts: Dict[str, float] = {}
        self.engine = None
        self.server = None
        self.thread: Optional[threading.Thread] = None
        self.flat: Dict = {}

    def timed(self, part: str, t0: float) -> float:
        now = time.monotonic()
        self.parts[part] = now - t0
        return now

    def close(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.thread.join(30)
            ctx = self.server.ctx
            ctx.queue.shutdown(wait=True)
            self.server.server_close()
            self.server = None
        if self.engine is not None:
            self.engine.close()
            self.engine = None


def build(cfg: Dict, data: Dataset, seed: int, tmp: str, device: str, warm, serve: bool,
          t0: float) -> System:
    """The system under test, with every part of its set-up timed; ``warm``
    runs the shapes of the cell's traffic once; ``serve`` starts the HTTP
    server on an ephemeral port of 127.0.0.1."""

    import torch

    from mmrag_tpu_torch.models.runtime import EncoderRuntime
    from mmrag_tpu_torch.ops import kernels
    from mmrag_tpu_torch.rag.engine import RagEngine
    from mmrag_tpu_torch.settings import load_settings
    from mmrag_tpu_torch.storage.records import Chunk, VectorRow

    sys_ = System()
    t = sys_.timed("imports", t0)
    if device == "cuda":
        kernels.build_all()
        from mmrag_tpu_torch import native

        native.load()  # the host library: built at the first run of a checkout
    t = sys_.timed("kernel_load", t)

    env = settings_env(cfg, tmp, data.tenants)
    settings = load_settings(env)
    models = cfg["models"]
    sys_.flat = weights.make_all(models, seed, device, env["WEIGHTS_DIR"])
    corpus.write_vocabularies(
        [weights.model_dir(env["WEIGHTS_DIR"], models[r]["id"]) for r in ("text", "reranker")],
        weights.model_dir(env["WEIGHTS_DIR"], models["clip"]["id"]))
    t = sys_.timed("weights_made", t)

    runtime = EncoderRuntime(settings, bert_cfg=bert_config(models["text"]),
                             clip_cfg=clip_config(models["clip"]), device=device)
    engine = RagEngine(settings, runtime)
    sys_.engine = engine
    runtime._ensure_minilm(), runtime._ensure_clip(), runtime._ensure_cross()
    t = sys_.timed("weights_loaded", t)

    # the slabs: the active tenants' rows first, then the idle tenants'
    # filler, installed as a restored snapshot installs its rows (applied
    # to the index, not appended to the journal)
    for modality, index, ids, tenant, doc, total in (
            ("text", engine.text_index, data.text_ids, data.text_tenant, data.text_doc,
             data.text_rows),
            ("image", engine.image_index, data.image_ids, data.image_tenant, data.image_doc,
             data.image_rows)):
        rows = data.active_rows(modality, device).cpu().numpy()
        index._apply_upsert([VectorRow(chunk_id=c, user_id=u, document_id=d, modality=modality,
                                       embedding=r) for c, u, d, r in zip(ids, tenant, doc, rows)])
        start = 0
        while len(ids) + start < total:
            n = min(BLOCK, total - len(ids) - start)
            rows = data.filler(modality, start, n, device).cpu().numpy()
            index._apply_upsert([
                VectorRow(chunk_id=f"{modality[0]}f{start + i}",
                          user_id=f"idle{(start + i) % data.idle:04d}",
                          document_id=f"idle{(start + i) % data.idle:04d}-d{(start + i) // data.idle % 16}",
                          modality=modality, embedding=rows[i]) for i in range(n)])
            start += n
    if device == "cuda":
        torch.cuda.synchronize()
    t = sys_.timed("slab_fill", t)

    for tnt, docs in data.docs.items():
        for d in docs:
            engine.metadata.ensure_document(d, tnt)
    engine.metadata.upsert_chunks(
        [Chunk(chunk_id=c, document_id=d, user_id=u, modality="text", text=body,
               page=meta["page"], meta=meta)
         for c, u, d, body, meta in zip(data.text_ids, data.text_tenant, data.text_doc,
                                        data.text_body, data.text_meta)]
        + [Chunk(chunk_id=c, document_id=d, user_id=u, modality="image", media_path=f"{c}.png")
           for c, u, d in zip(data.image_ids, data.image_tenant, data.image_doc)])
    t = sys_.timed("catalogue", t)

    # a deployment's engine loads its slabs inside RagEngine(), before it
    # freezes its heap (RagEngine._freeze_heap); the benchmark installs them
    # after, so it freezes once more, for the same heap a boot would leave
    gc.collect()
    gc.freeze()

    warm(engine)
    if device == "cuda":
        torch.cuda.synchronize()
    t = sys_.timed("warmup", t)

    if serve:
        from mmrag_tpu_torch.serving.http import make_server

        sys_.server = make_server("127.0.0.1", 0, cfg=settings, engine=engine)
        sys_.thread = threading.Thread(target=sys_.server.serve_forever, daemon=True)
        sys_.thread.start()
    sys_.timed("server_start", t)
    return sys_
