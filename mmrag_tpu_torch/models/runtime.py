"""Encoder runtime: lazy params, bucketed static-shape batching, one device.

Port of ``mmrag_tpu/models/runtime.py``. Every public call pads its batch to a
configured bucket (``TPU_TEXT_BATCH_BUCKETS`` etc.) and its sequence length to
a bucket, so the kernels see a few fixed shapes.

Weights resolve in order: converted ``.npz`` under ``WEIGHTS_DIR/<model>/``
(the JAX package's layout, carried across by
:func:`~mmrag_tpu_torch.models.convert.params_from_jax`) -> deterministic
seeded init (offline mode). The runtime runs on ``cuda`` unless it is given
``device="cpu"``; bf16 on CUDA, f32 on the CPU.

``TPU_ENCODER_QUANT=int8`` (and only that value) engages the W8A8 towers as
the JAX runtime does: the MiniLM embed, the cross-encoder trunk and the CLIP
vision blocks run as B6 + B7 from int8 weights quantized once, from the f32
tree, when each model loads, and held on the device. The CLIP text tower is
never quantized.

Data-parallel mode (``mesh=``, by default
:func:`~mmrag_tpu_torch.parallel.mesh.engine_data_mesh`: every distinct CUDA
device when there are several and ``TPU_DATA_PARALLEL`` is not ``off``):
each bucket is padded to a multiple of the data axis, the params (and the
int8 blocks) are replicated once per distinct device, and each shard runs
the full forward on its rows through the same kernels
(:func:`~mmrag_tpu_torch.parallel.inference.shard_batch_fn`); the outputs
land on the mesh's first device. A runtime given an explicit ``device`` and
no mesh runs on that one device.

Not carried over: the XLA compile cache.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, synchronize, working_dtype
from ..settings import Settings, settings as _default_settings
from ..utils.profiling import stage
from . import bert, clip, convert, tokenizer as tok

logger = logging.getLogger(__name__)

TEXT_EMBED_DIM = 384
CLIP_EMBED_DIM = 512


def _sanitize(model_id: str) -> str:
    return model_id.replace("/", "__")


# max padded tokens (batch x seq) per encoder dispatch: 512 rows at the
# 512-token splitter shape
_DISPATCH_TOKEN_CAP = 512 * 512


def _assemble_bert_inputs(buf, lengths, btok, seq: int):
    """``[CLS] body [SEP]`` ids + attention mask from a tokenize_matrix
    block, entirely in numpy."""

    n = lengths.shape[0]
    body_len = np.minimum(lengths, seq - 2)
    width = min(buf.shape[1], seq - 2)
    cols = np.arange(width)
    ids = np.full((n, seq), btok.pad_id, dtype=np.int32)
    ids[:, 1 : width + 1] = np.where(
        cols[None, :] < body_len[:, None], buf[:, :width], btok.pad_id
    )
    ids[:, 0] = btok.cls_id
    ids[np.arange(n), body_len + 1] = btok.sep_id
    mask = (np.arange(seq)[None, :] < (body_len + 2)[:, None]).astype(np.int32)
    return ids, mask


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def _capped_batch(buckets: Sequence[int], seq: int) -> int:
    """Largest batch bucket whose (rows x seq) padded-token dispatch stays
    under ``_DISPATCH_TOKEN_CAP`` — every bucketed text path chunks by this."""

    return max(
        (b for b in buckets if b * seq <= _DISPATCH_TOKEN_CAP),
        default=buckets[0],
    )


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    if arr.shape[0] == rows:
        return arr
    pad = np.zeros((rows - arr.shape[0], *arr.shape[1:]), dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


class EncoderRuntime:
    """Holds MiniLM + CLIP + cross-encoder params and their forwards."""

    def __init__(
        self,
        cfg: Optional[Settings] = None,
        bert_cfg: bert.BertConfig = bert.MINILM_L6,
        clip_cfg: clip.CLIPConfig = clip.CLIP_VIT_B32,
        device: DeviceLike = None,
        mesh=None,
    ) -> None:
        self.cfg = cfg or _default_settings
        if mesh is None and device is None:
            from ..parallel.mesh import engine_data_mesh

            mesh = engine_data_mesh(self.cfg)
        self.mesh = mesh
        self._n_data = mesh.n_data if mesh is not None else 1
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.devices[0])
        if mesh is not None and self.device != resolve_device(mesh.devices[0]):
            raise ValueError(f"device {self.device} is not the mesh's first device "
                             f"{mesh.devices[0]}")
        self._replicas: dict = {}  # id of a param tree -> (tree, its Replicated copies)
        self.bert_cfg = bert_cfg
        self.clip_cfg = clip_cfg
        self.text_dim = bert_cfg.hidden_size
        self.clip_dim = clip_cfg.projection_dim
        tpu = self.cfg.tpu
        if tpu.encoder_quant not in ("", "int8"):
            raise ValueError(f"TPU_ENCODER_QUANT={tpu.encoder_quant!r}: expected '' or 'int8'")
        self.quant = tpu.encoder_quant == "int8"
        self.compute_dtype = working_dtype(tpu.compute_dtype, self.device)
        # RLock: _ensure_cross reuses _ensure_minilm's tokenizer under the lock
        self._lock = threading.RLock()
        self._minilm = None
        self._clip = None
        self._cross = None
        # the W8A8 blocks (None unless TPU_ENCODER_QUANT=int8), built with
        # their model in _load
        self._minilm_q8 = None
        self._clip_q8 = None
        self._cross_q8 = None
        self._bert_tok = None
        self._clip_tok = None

    # -- lazy loading -------------------------------------------------------

    def _weights_dir(self, model_id: str) -> str:
        return os.path.join(self.cfg.paths.weights_dir, _sanitize(model_id))

    def _load(self, model_id: str, kind: str, model_cfg, seeded):
        """``(params, q8)``: the model in the working dtype, and its int8
        blocks quantized from the same f32 tree under int8 (else None)."""

        wdir = self._weights_dir(model_id)
        if convert.params_available(wdir, "model"):
            logger.info("loading %s weights from %s", kind, wdir)
            tree = convert.load_params(wdir, "model")
        else:
            logger.warning("no converted weights for %s — using seeded init", model_id)
            tree = seeded()
        params = convert.params_from_jax(
            tree, kind, model_cfg, device=self.device, dtype=self.compute_dtype
        )
        q8 = None
        if self.quant:
            q8 = convert.params_from_jax(tree, kind, model_cfg, device=self.device, q8=True)
        return params, q8

    def _ensure_minilm(self):
        with self._lock:
            if self._minilm is None:
                self._minilm, self._minilm_q8 = self._load(
                    self.cfg.models.text, "minilm", self.bert_cfg,
                    lambda: bert.init_bert_params(0, self.bert_cfg),
                )
                self._bert_tok = tok.load_bert_tokenizer(
                    self._weights_dir(self.cfg.models.text))
        return self._minilm

    def _ensure_clip(self):
        with self._lock:
            if self._clip is None:
                self._clip, self._clip_q8 = self._load(
                    self.cfg.models.clip, "clip", self.clip_cfg,
                    lambda: clip.init_clip_params(1, self.clip_cfg),
                )
                self._clip_tok = tok.load_clip_tokenizer(
                    self._weights_dir(self.cfg.models.clip))
        return self._clip

    def _ensure_cross(self):
        with self._lock:
            if self._cross is None:
                self._cross, self._cross_q8 = self._load(
                    self.cfg.models.reranker, "cross", self.bert_cfg,
                    lambda: bert.init_cross_encoder_params(2, self.bert_cfg),
                )
                if self._bert_tok is None:
                    self._ensure_minilm()
        return self._cross

    def _ensure_minilm_q8(self):
        """The device-resident int8 MiniLM blocks; None unless int8."""

        self._ensure_minilm()
        return self._minilm_q8

    def _ensure_clip_q8(self):
        """The device-resident int8 CLIP vision blocks; None unless int8."""

        self._ensure_clip()
        return self._clip_q8

    def _ensure_cross_q8(self):
        """The device-resident int8 cross-encoder trunk; None unless int8."""

        self._ensure_cross()
        return self._cross_q8

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, non_blocking=True)

    def _round_batch(self, bsz: int) -> int:
        """Pad a bucket size up to a multiple of the data axis so the batch
        splits evenly (one device: the identity)."""

        if bsz % self._n_data:
            bsz += self._n_data - bsz % self._n_data
        return bsz

    def _run(self, fn, params, *batches: np.ndarray) -> torch.Tensor:
        """``fn(params, *tensors)`` on the runtime's device, or split over the
        mesh's data axis with the params' per-device copies, made once per
        param tree."""

        if self.mesh is None:
            return fn(params, *(self._tensor(b) for b in batches))
        from ..parallel.inference import shard_batch_fn
        from ..parallel.mesh import replicated

        key = tuple(id(p) for p in params) if isinstance(params, tuple) else id(params)
        with self._lock:
            held = self._replicas.get(key)
            if held is None:
                # the tree is held beside its copies, so its id stays its own
                held = self._replicas[key] = (params, replicated(self.mesh, params))
        return shard_batch_fn(self.mesh, fn, len(batches))(held[1], *batches)

    # -- forwards ------------------------------------------------------------

    @torch.inference_mode()
    def _minilm_fn(self, params, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        def fwd(p, ids, mask):
            return bert.minilm_embed(p[0], ids, mask, self.bert_cfg, q8_layers=p[1])

        return self._run(fwd, (params, self._ensure_minilm_q8()), ids, mask)

    @torch.inference_mode()
    def _clip_image_fn(self, params, images_u8: np.ndarray) -> torch.Tensor:
        from ..ops.images import preprocess_batch

        def fwd(p, images):
            feats = clip.clip_image_features(p[0], preprocess_batch(images), self.clip_cfg,
                                             q8_layers=p[1])
            return bert.l2_normalize(feats)

        return self._run(fwd, (params, self._ensure_clip_q8()), images_u8)

    @torch.inference_mode()
    def _clip_text_fn(self, params, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        def fwd(p, ids, mask):
            return bert.l2_normalize(clip.clip_text_features(p, ids, mask, self.clip_cfg))

        return self._run(fwd, params, ids, mask)

    @torch.inference_mode()
    def _cross_fn(self, params, ids, mask, tt) -> torch.Tensor:
        def fwd(p, ids, mask, tt):
            return bert.cross_encoder_score(p[0], ids, mask, tt, self.bert_cfg, q8_layers=p[1])

        return self._run(fwd, (params, self._ensure_cross_q8()), ids, mask, tt)

    # -- public API (reference embed_* signatures) --------------------------

    def embed_text_batch(self, texts: Sequence[str]) -> np.ndarray:
        """(n, 384) L2-normalized MiniLM sentence embeddings
        (reference ``embed_text_batch``, ``app/ml/embeddings.py:52-70``)."""

        if not texts:
            return np.zeros((0, self.text_dim), dtype=np.float32)
        params = self._ensure_minilm()
        tpu = self.cfg.tpu
        buckets = tpu.text_batch_buckets
        btok = self._bert_tok
        pending: List = []

        def padded(ids, mask, n):
            # padded rows are all-pad-token; mean_pool guards div-by-zero
            bsz = self._round_batch(_bucket(n, buckets))
            return _pad_rows(ids, bsz), _pad_rows(mask, bsz), n

        scan = buckets[-1]
        for start in range(0, len(texts), scan):
            chunk = list(texts[start : start + scan])
            batches = []
            with stage("runtime.tokenize", items=len(chunk), model="minilm"):
                if hasattr(btok, "tokenize_matrix"):
                    buf, lengths = btok.tokenize_matrix(chunk)
                    if tpu.text_embed_max_len:
                        # reference parity: SentenceTransformer caps MiniLM
                        # embeds at max_seq_length — clamp BEFORE bucket selection
                        lengths = np.minimum(lengths, tpu.text_embed_max_len - 2)
                    seq_all = _bucket(int(lengths.max(initial=0)) + 2, tpu.text_seq_buckets)
                    rows = _capped_batch(buckets, seq_all)
                    for g in range(0, len(chunk), rows):
                        glen = lengths[g : g + rows]
                        seq = _bucket(int(glen.max(initial=0)) + 2, tpu.text_seq_buckets)
                        ids, mask = _assemble_bert_inputs(buf[g : g + rows], glen, btok, seq)
                        batches.append(padded(ids, mask, len(glen)))
                else:  # HashTokenizer keeps the list path
                    tokenized = [btok.tokenize_ids(t) for t in chunk]
                    if tpu.text_embed_max_len:
                        cap = tpu.text_embed_max_len - 2
                        tokenized = [t[:cap] for t in tokenized]
                    longest = max((len(t) for t in tokenized), default=1) + 2
                    seq_all = _bucket(longest, tpu.text_seq_buckets)
                    rows = _capped_batch(buckets, seq_all)
                    for g in range(0, len(chunk), rows):
                        sub = tokenized[g : g + rows]
                        seq = _bucket(
                            max((len(t) for t in sub), default=1) + 2, tpu.text_seq_buckets
                        )
                        seqs = [[btok.cls_id, *t[: seq - 2], btok.sep_id] for t in sub]
                        ids, mask = tok._pad_batch(seqs, seq, btok.pad_id)
                        batches.append(padded(ids, mask, len(sub)))
            # the readback waits until every chunk is in flight
            with stage("runtime.launch", items=len(chunk), model="minilm"):
                for ids, mask, n in batches:
                    pending.append((self._minilm_fn(params, ids, mask), n))
        with stage("runtime.wait", items=len(texts), model="minilm"):
            synchronize(self.device)
        return np.concatenate(
            [emb[:n].float().cpu().numpy() for emb, n in pending], axis=0
        )

    def embed_images_batch(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """(n, 512) L2-normalized CLIP image embeddings from uint8 RGB arrays
        (reference ``embed_images_batch``, ``app/ml/embeddings.py:73-91``)."""

        if not images:
            return np.zeros((0, self.clip_dim), dtype=np.float32)
        out = [dev[:n].float().cpu().numpy() for dev, n in self.embed_images_async(images)]
        return np.concatenate(out, axis=0)

    def embed_images_async(self, images: Sequence[np.ndarray]):
        """Yield ``(device_embeddings, n_valid)`` per bucket without forcing a
        readback; ``dev[:n].cpu()`` later synchronizes."""

        from ..ops.images import CLIP_IMAGE_SIZE, stack_square_crops

        params = self._ensure_clip()
        tpu = self.cfg.tpu
        max_batch = tpu.image_batch_buckets[-1]
        for start in range(0, len(images), max_batch):
            chunk = images[start : start + max_batch]
            n = len(chunk)
            batch = stack_square_crops(chunk, canvas=CLIP_IMAGE_SIZE)
            batch = _pad_rows(batch, self._round_batch(_bucket(n, tpu.image_batch_buckets)))
            yield self._clip_image_fn(params, batch), n

    def embed_image_files(self, paths: Sequence[str]) -> np.ndarray:
        """Decode image files on the host (PIL, else cv2) and embed them."""

        return self.embed_images_batch([_decode_rgb(p) for p in paths])

    def embed_query_for_images(self, query: str) -> np.ndarray:
        """(512,) L2-normalized CLIP text embedding
        (reference ``embed_query_for_images``, ``app/ml/embeddings.py:94-105``)."""

        return self.embed_queries_for_images([query])[0]

    def embed_queries_for_images(self, queries: Sequence[str]) -> np.ndarray:
        """(n, 512) CLIP text embeddings in bucketed dispatches."""

        if not queries:
            return np.zeros((0, self.clip_dim), dtype=np.float32)
        params = self._ensure_clip()
        buckets = self.cfg.tpu.text_batch_buckets
        out = []
        max_batch = _capped_batch(buckets, 77)  # CLIP text is fixed seq-77
        for start in range(0, len(queries), max_batch):
            chunk = list(queries[start : start + max_batch])
            with stage("runtime.tokenize", items=len(chunk), model="clip_text"):
                ids, mask = self._clip_tok.encode(chunk, max_len=77)
                bsz = self._round_batch(_bucket(len(chunk), buckets))
                ids, mask = _pad_rows(ids, bsz), _pad_rows(mask, bsz)
            with stage("runtime.launch", items=len(chunk), model="clip_text"):
                emb = self._clip_text_fn(params, ids, mask)[: len(chunk)].float()
            with stage("runtime.wait", items=len(chunk), model="clip_text"):
                synchronize(self.device)
            out.append(emb.cpu().numpy())
        return np.concatenate(out, axis=0)

    def embed_queries_device(self, queries: Sequence[str]):
        """Dual query embed (MiniLM + CLIP text towers) with NO host sync:
        returns ``((n, 384), (n, 512))`` f32 device tensors with both
        forwards in flight, so the search can consume them on the device.
        Shapes and buckets are those of :meth:`embed_text_batch` /
        :meth:`embed_queries_for_images`."""

        n = len(queries)
        tpu = self.cfg.tpu
        max_batch = tpu.text_batch_buckets[-1]
        if n == 0 or n > max_batch:  # beyond one bucket: host path chunks
            return self._host_pair(queries)
        bparams = self._ensure_minilm()
        cparams = self._ensure_clip()
        bsz = self._round_batch(_bucket(n, tpu.text_batch_buckets))
        btok = self._bert_tok
        with stage("runtime.tokenize", items=n, model="minilm"):
            tokenized = [btok.tokenize_ids(t) for t in queries]
            if tpu.text_embed_max_len:
                tokenized = [t[: tpu.text_embed_max_len - 2] for t in tokenized]
            longest = max((len(t) for t in tokenized), default=1) + 2
            seq = _bucket(longest, tpu.text_seq_buckets)
            if bsz * seq > _DISPATCH_TOKEN_CAP:  # long queries at a wide bucket
                return self._host_pair(queries)
            seqs = [[btok.cls_id, *t[: seq - 2], btok.sep_id] for t in tokenized]
            ids, mask = tok._pad_batch(seqs, seq, btok.pad_id)
            ids, mask = _pad_rows(ids, bsz), _pad_rows(mask, bsz)
        with stage("runtime.launch", items=n, model="minilm"):
            temb = self._minilm_fn(bparams, ids, mask)[:n].float()
        with stage("runtime.tokenize", items=n, model="clip_text"):
            cids, cmask = self._clip_tok.encode(list(queries), max_len=77)
            cids, cmask = _pad_rows(cids, bsz), _pad_rows(cmask, bsz)
        with stage("runtime.launch", items=n, model="clip_text"):
            cemb = self._clip_text_fn(cparams, cids, cmask)[:n].float()
        return temb, cemb

    def _host_pair(self, queries):
        return (
            self._tensor(self.embed_text_batch(queries)),
            self._tensor(self.embed_queries_for_images(queries)),
        )

    def rerank_scores(self, query: str, passages: Sequence[str]) -> np.ndarray:
        """(n,) cross-encoder relevance logits for (query, passage) pairs
        (reference CrossEncoder.predict, ``app/ml/retrieve.py:148``)."""

        return self.rerank_pairs([query] * len(passages), passages)

    def _rerank_chunks(self, n_pairs: int) -> list:
        """The (start, length, padded_batch) decomposition a rerank call over
        ``n_pairs`` pairs dispatches."""

        tpu = self.cfg.tpu
        max_batch = _capped_batch(tpu.text_batch_buckets, tpu.rerank_seq_len)
        chunks = []
        for start in range(0, max(n_pairs, 1), max_batch):
            length = min(max_batch, n_pairs - start) if n_pairs else 1
            chunks.append((start, length,
                           self._round_batch(_bucket(length, tpu.text_batch_buckets))))
        return chunks

    def rerank_bucket_sizes(self, n_pairs: int) -> tuple:
        """The padded batch sizes a ``rerank_pairs`` call over ``n_pairs``
        pairs would run, from the one definition in :meth:`_rerank_chunks`
        (the serving warmup runs the cross-encoder only for new sizes)."""

        return tuple(bsz for _, _, bsz in self._rerank_chunks(n_pairs))

    def rerank_pairs(self, queries: Sequence[str], passages: Sequence[str]) -> np.ndarray:
        """(n,) logits for arbitrary (query_i, passage_i) pairs in bucketed
        dispatches (every coalesced request's candidates together)."""

        if not passages:
            return np.zeros((0,), dtype=np.float32)
        if len(queries) != len(passages):
            raise ValueError(f"{len(queries)} queries for {len(passages)} passages")
        params = self._ensure_cross()
        seq = self.cfg.tpu.rerank_seq_len
        out = []
        for start, length, bsz in self._rerank_chunks(len(passages)):
            qs = list(queries[start : start + length])
            ps = list(passages[start : start + length])
            with stage("runtime.tokenize", items=length, model="cross"):
                ids, mask, tt = self._bert_tok.encode_pairs(qs, ps, seq)
                ids, mask, tt = _pad_rows(ids, bsz), _pad_rows(mask, bsz), _pad_rows(tt, bsz)
            with stage("runtime.launch", items=length, model="cross"):
                scores = self._cross_fn(params, ids, mask, tt).float()
            with stage("runtime.wait", items=length, model="cross"):
                synchronize(self.device)
            out.append(scores.cpu().numpy()[: len(ps)])
        return np.concatenate(out, axis=0)


def _decode_rgb(path: str) -> np.ndarray:
    """(h, w, 3) uint8 RGB from an image file, with PIL or else cv2."""

    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            "decoding image files needs PIL or cv2, and neither is installed; "
            "embed decoded arrays with embed_images_batch instead"
        ) from None
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError(f"cannot decode image {path!r}")
    return np.ascontiguousarray(bgr[:, :, ::-1])


_runtime: Optional[EncoderRuntime] = None
_runtime_lock = threading.Lock()


def get_runtime(cfg: Optional[Settings] = None, device: DeviceLike = None) -> EncoderRuntime:
    """Process-wide lazy singleton (reference lazy-global pattern)."""

    global _runtime
    with _runtime_lock:
        if _runtime is None or (cfg is not None and _runtime.cfg is not cfg):
            _runtime = EncoderRuntime(cfg, device=device)
    return _runtime


def reset_runtime() -> None:
    """Test hook: drop the process runtime."""

    global _runtime
    with _runtime_lock:
        _runtime = None
