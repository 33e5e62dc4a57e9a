"""The flagship forward and the multi-device dry run of the port.

Port of the repository's ``__graft_entry__.py``, with the same names, shapes,
seeds and assertions:

``entry(device=None)``
    ``(forward, (params, images))``: CLIP ViT-B/32 at full width over eight
    224 x 224 uint8 images from ``np.random.default_rng(0)``. ``forward``
    preprocesses the images (X2, :func:`~mmrag_tpu_torch.ops.images.
    preprocess_batch`), runs the vision tower in the params' dtype (bf16 on
    the card: B1 pre-LN and B3, that is K-ln, K-gemm and K-attn, with the
    LayerNorms outside the blocks plain, as in JAX; f32 on the CPU, the
    plain versions) and L2-normalizes the 512-d features.

``dryrun_multichip(n_devices, devices=None)``
    The production paths on an ``n_devices`` mesh, at tiny widths: (1) a
    ``RagEngine`` over a data-parallel ``EncoderRuntime`` (row-sharded
    slabs, encoder batches split over the data axis) ingests three text
    nodes and answers one ``retrieve``; (1b) a row-sharded ``pq`` index;
    (1c) the sharded ``ivf`` layouts over f32 and ``pq`` buckets; (2) one
    sharded CLIP contrastive training step on a (data, model) mesh. Returns
    a report: the final ids, the pq and ivf hits, the loss and the kernels
    each part launched (``ops/kernels.py``'s counts).

``devices`` defaults to every CUDA device; a device may repeat, so one card
holds ``["cuda:0"] * n`` shards and the CPU ``["cpu"] * n``. One deviation
from the JAX function: the port's ``engine_data_mesh`` gives one card no
mesh, so the runtime is handed the mesh itself where JAX relies on
``TPU_DATA_PARALLEL=auto``. Run both on the card with ``python -m
mmrag_tpu_torch.graft_entry``.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device, working_dtype

logger = logging.getLogger(__name__)

TEXTS = (
    "The mitochondria is the powerhouse of the cell.",
    "Photosynthesis converts light energy into chemical energy.",
    "Newton's laws of motion describe classical mechanics.",
)


def entry(device: DeviceLike = None) -> Tuple[Callable, tuple]:
    """The flagship forward and its inputs: ``forward(params, images_u8)``
    -> (8, 512) unit features. The params are the port's seeded CLIP
    ViT-B/32 (seed 0) on ``device`` (the card unless ``"cpu"``), bf16 on the
    card and f32 on the CPU."""

    from .models import clip
    from .models.bert import l2_normalize
    from .models.convert import params_from_jax
    from .ops.images import preprocess_batch

    dev = resolve_device(device)
    cfg = clip.CLIP_VIT_B32
    params = params_from_jax(clip.init_clip_params(0, cfg), "clip", cfg, device=dev,
                             dtype=working_dtype("bfloat16", dev))

    def forward(params, images_u8: torch.Tensor) -> torch.Tensor:
        pixels = preprocess_batch(images_u8)
        return l2_normalize(clip.clip_image_features(params, pixels, cfg))

    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 255, (8, 224, 224, 3), dtype=np.uint8)
    ).to(dev)
    return forward, (params, images)


# -- the dry run's seeded data, drawn in the JAX function's order -------------


def pq_rows(rng: np.random.Generator) -> np.ndarray:
    """(1b): 64 x 64 rows."""

    return rng.standard_normal((64, 64)).astype(np.float32)


def ivf_rows(rng: np.random.Generator) -> np.ndarray:
    """(1c): 1024 rows around 8 unit centroids."""

    cents = rng.standard_normal((8, 64)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    return (cents[rng.integers(0, 8, 1024)]
            + 0.2 * rng.standard_normal((1024, 64))).astype(np.float32)


def clip_batch(rng: np.random.Generator, b: int) -> tuple:
    """(2): ``b`` 32 x 32 images of normal pixels, token ids in [1, 500)
    at length 16, every token attended."""

    images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 500, (b, 16)).astype(np.int32)
    return images, ids, np.ones((b, 16), np.int32)


def train_clip_config():
    from .models.clip import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

    return CLIPConfig(
        vision=CLIPVisionConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
                                num_heads=2, intermediate_size=64),
        text=CLIPTextConfig(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
                            intermediate_size=64, max_position=16),
        projection_dim=32,
    )


def clip_train_step(mesh, batch: tuple, init=0) -> float:
    """One sharded CLIP training step at :func:`train_clip_config` on
    ``mesh`` from ``init`` (a seed of the port's init or a port tree of f32
    tensors); returns the loss, which must be finite."""

    from .parallel.training import make_train_step, train_state_init

    cfg = train_clip_config()
    params, opt, _ = train_state_init(init, mesh, cfg)
    step = make_train_step(mesh, cfg)
    dev = mesh.grid[0][0]
    images, ids, attn = (torch.from_numpy(a).to(dev) for a in batch)
    _, _, loss = step(params, opt, images, ids, attn)
    loss = float(loss)
    _check(np.isfinite(loss), f"non-finite loss {loss}")
    return loss


# -- the dry run ---------------------------------------------------------------


def _check(ok, what) -> None:
    """The dry run's assertions (JAX's ``assert`` lines), kept under ``-O``."""

    if not ok:
        raise AssertionError(what)


def _mesh_devices(n_devices: int, devices: Optional[Sequence[DeviceLike]]) -> List[torch.device]:
    if devices is None:
        resolve_device(None)  # raises without CUDA
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices][:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
    return devices


def _counts() -> Dict[str, int]:
    from .ops import kernels

    return {**kernels.LAUNCHES, **kernels.KERNEL_LAUNCHES}


def _launched(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def _engine_part(td: str, mesh, n_devices: int) -> dict:
    """(1): the production engine in multi-device mode, through the public
    ``RagEngine`` / ``retrieve`` API a server calls."""

    from .models import bert, clip
    from .models.probe import REAL_WEIGHT_FAMILIES, convert_found_into, find_real_checkpoints
    from .models.runtime import EncoderRuntime, _sanitize
    from .parallel.mesh import DATA_AXIS
    from .rag import index_build as ib
    from .rag import retrieve as rv
    from .rag.engine import RagEngine
    from .settings import load_settings
    from .storage import Document

    tiny_bert = bert.BertConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
    tiny_clip = clip.CLIPConfig(
        vision=clip.CLIPVisionConfig(hidden_size=64, num_layers=2, num_heads=2,
                                     intermediate_size=128),
        text=clip.CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64),
        projection_dim=512,
    )
    env = {
        "TPU_INDEX_DIR": f"{td}/index",
        "NOTES_DB_PATH": f"{td}/notes.db",
        "WEIGHTS_DIR": f"{td}/weights",
        "MEDIA_DIR": f"{td}/media",
        "INGEST_CACHE_DIR": f"{td}/cache",
        "TPU_COMPUTE_DTYPE": "float32",
        "TPU_TEXT_BATCH_BUCKETS": "4,16",
        "TPU_TEXT_SEQ_BUCKETS": "32,128",
        "TPU_IMAGE_BATCH_BUCKETS": "4,8",
        "TPU_MICROBATCH_WINDOW_MS": "0",
        "TPU_DATA_PARALLEL": "auto",
    }
    cfg = load_settings(env)
    # real weights, where any of the reference's checkpoints is provisioned:
    # converted with their checkpoint-derived configs, so the runtime below
    # loads them in place of seeded init
    bert_cfg, clip_cfg, converted, reranker_seeded = tiny_bert, tiny_clip, {}, False
    real_found = find_real_checkpoints()
    if real_found:
        converted = convert_found_into(f"{td}/weights", real_found)
        bert_cfg = converted.get("minilm", tiny_bert)
        clip_cfg = converted.get("clip", tiny_clip)
        # one BERT config serves the text encoder and the cross-encoder's
        # trunk: a reranker whose arch differs from it stays seeded
        rr_cfg = converted.get("reranker")
        if rr_cfg is not None and rr_cfg != bert_cfg:
            shutil.rmtree(os.path.join(f"{td}/weights",
                                       _sanitize(REAL_WEIGHT_FAMILIES["reranker"])),
                          ignore_errors=True)
            reranker_seeded = True
            logger.info("reranker checkpoint arch != text-encoder config; "
                        "keeping the seeded cross-encoder")
    eng = RagEngine(cfg, EncoderRuntime(cfg, bert_cfg=bert_cfg, clip_cfg=clip_cfg, mesh=mesh))
    try:
        _check(eng.mesh is not None and eng.mesh.shape[DATA_AXIS] == n_devices,
               f"engine mesh {eng.mesh}, expected {n_devices} data shards")
        _check(eng.text_index._sharded, "slab must be row-sharded")
        eng.metadata.upsert_document(
            Document(document_id="doc1", user_id="u1", doc_type="pdf", title="T"))
        nodes = [{"id": f"doc1-c{i}", "text": t, "metadata": {"document_id": "doc1", "page": i + 1}}
                 for i, t in enumerate(TEXTS)]
        _check(ib.index_text_nodes("u1", nodes, eng) == 3, "3 text nodes not indexed")
        out = rv.retrieve("u1", "what powers the cell?", eng)
        _check(out["results"], "sharded engine retrieval returned no hits")
        _check(all(h["user_id"] == "u1" for h in out["results"]), f"another tenant's hit: {out}")
    finally:
        eng.close()
    return {"final_ids": [h["chunk_id"] for h in out["results"]],
            "real_weights": sorted(converted), "reranker_seeded": reranker_seeded}


def _rows(VectorRow, mat: np.ndarray, prefix: str) -> list:
    return [VectorRow(chunk_id=f"{prefix}{i}", user_id="u1", document_id="d1",
                      modality="text", embedding=mat[i]) for i in range(len(mat))]


def dryrun_multichip(n_devices: int, devices: Optional[Sequence[DeviceLike]] = None) -> dict:
    """Run the four parts on an ``n_devices`` mesh of ``devices`` (default:
    every CUDA device; raises without CUDA unless devices are given); see the
    module docstring. Returns the report."""

    from .index.store import VectorIndex
    from .parallel.mesh import build_mesh
    from .parallel.sharded_ivf import ShardedIVFData
    from .storage.records import VectorRow

    devs = _mesh_devices(n_devices, devices)
    rng = np.random.default_rng(0)
    report: dict = {"n_devices": n_devices, "devices": sorted({str(d) for d in devs}),
                    "launches": {}, "seconds": {}}

    def part(name: str, fn):
        before, t0 = _counts(), time.perf_counter()
        out = fn()
        if devs[0].type == "cuda":
            torch.cuda.synchronize()
        report["seconds"][name] = time.perf_counter() - t0
        report["launches"][name] = _launched(before)
        return out

    # 1) the production engine in multi-device mode
    with tempfile.TemporaryDirectory() as td:
        report.update(part("engine", lambda: _engine_part(td, build_mesh(devices=devs),
                                                          n_devices)))

    # 1b) pq storage, row-sharded: the m-byte code slab over the data axis,
    #     per-shard ADC, the candidates merged, the exact host refine on the
    #     merged global row ids
    def pq_part():
        vecs = pq_rows(rng)
        pq_ix = VectorIndex(dim=64, dtype="pq", mesh=build_mesh(devices=devs))
        pq_ix.upsert(_rows(VectorRow, vecs, "c"))
        _check(pq_ix._sharded, "pq code slab must be row-sharded")
        pq_hits = pq_ix.search_batch(vecs[:2], "u1", k=4)
        _check(pq_hits[0] and pq_hits[0][0][0] == "c0", pq_hits)
        return pq_hits

    report["pq_hits"] = part("pq", pq_part)

    # 1c) the partitioned layout on the mesh: per-shard buckets around shared
    #     centroids, the candidates merged; over f32 rows and residual pq
    #     codes. Clustered rows, so the structure gate passes.
    cl = ivf_rows(rng)

    def ivf_part(ivf_dtype: str):
        ivf_ix = VectorIndex(dim=64, dtype=ivf_dtype, backend="ivf",
                             mesh=build_mesh(devices=devs), ivf_min_rows=10)
        ivf_ix.ivf_build_async = False
        ivf_ix.upsert(_rows(VectorRow, cl, "v"))
        hits = ivf_ix.search_batch(cl[:2], "u1", k=4)
        _check(isinstance(ivf_ix._ivf, ShardedIVFData),
               f"{ivf_dtype}: sharded ivf layout must build on the mesh")
        _check(ivf_ix._ivf.n_shards == n_devices, f"{ivf_ix._ivf.n_shards} ivf shards")
        _check(hits[0] and hits[0][0][0] == "v0", hits)
        return hits

    report["ivf_hits"] = {d: part(f"ivf {d}", lambda d=d: ivf_part(d))
                          for d in ("float32", "pq")}

    # 2) one sharded training step (data x model) on a tiny CLIP
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = build_mesh(n_devices, model_parallel=model_parallel, devices=devs)
    batch = clip_batch(rng, max(n_devices, 4))
    report["model_parallel"] = model_parallel
    report["loss"] = part("train", lambda: clip_train_step(mesh, batch))
    return report


if __name__ == "__main__":
    import json

    # every card of the machine, or four shards of the one card
    count = torch.cuda.device_count()
    n, devices = (count, None) if count >= 2 else (4, ["cuda:0"] * 4)
    print(json.dumps({"dryrun_multichip": dryrun_multichip(n, devices)}))
    print(f"dryrun_multichip({n}) ok")
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape), out.dtype)
