"""Frozen default configuration for the PyTorch/CUDA port.

The same tree of frozen dataclasses as ``mmrag_tpu.config``, consumed by the
typed env loader in :mod:`mmrag_tpu_torch.settings`. The env names (and so the
``.env`` files) are shared with the JAX package; knobs that only the TPU
build reads (the XLA compile cache, the device mesh) are left out.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelDefaults:
    """Model identifiers (reference ``config.py:7-12``).

    Identifiers name architectures + converted-weight directories under
    ``WEIGHTS_DIR``; when no converted weights exist the encoders run with
    deterministic seeded init (offline mode).
    """

    text: str = "sentence-transformers/all-MiniLM-L6-v2"
    clip: str = "openai/clip-vit-base-patch32"
    reranker: str = "cross-encoder/ms-marco-MiniLM-L-6-v2"
    asr: str = "openai/whisper-base"
    asr_language: str = "auto"
    asr_timestamps: bool = True
    asr_word_align: bool = False


@dataclass(frozen=True)
class GeminiDefaults:
    """Grounded-generation backend (reference ``config.py:16-19``)."""

    model: str = "gemini-pro-vision"


@dataclass(frozen=True)
class PathDefaults:
    """Artifact locations (reference ``config.py:23-31``)."""

    index_dir: str = "output/tpu_index"
    lancedb_dir: str = "output/lance_db"  # kept for env compat; aliases index_dir
    media_dir: str = "output/media"
    thumbs_dir: str = "output/thumbs"
    ingest_cache_dir: str = "output/cache"
    notes_db_path: str = "output/notes.db"
    checkpoint_dir: str = "output/checkpoints"
    weights_dir: str = "output/weights"  # converted weight dirs keyed by model id


@dataclass(frozen=True)
class RateLimitDefaults:
    """HTTP rate limit (reference ``config.py:35-38``)."""

    per_minute: int = 60


@dataclass(frozen=True)
class RetrievalDefaults:
    """Retrieval hyperparameters (reference ``config.py:42-50``)."""

    use_rerank: bool = True
    index_topk_text: int = 50
    index_topk_image: int = 12
    rerank_topk: int = 8
    final_n: int = 4
    confidence_tau: float = 0.25


@dataclass(frozen=True)
class YouTubeDefaults:
    """YouTube ingestion tuning (reference ``config.py:54-67``)."""

    prefer_transcript: bool = True
    frame_scene_threshold: float = 0.4
    max_frames: int = 120
    frame_dedup_delta: int = 6
    frame_stride_sec: int = 5
    lazy_frames: bool = True
    frame_extractor: str = "auto"
    max_duration_min: int = 40
    download_format: str = "bv*[height<=360]+ba/b[height<=360]"
    retries: int = 2
    timeout_sec: int = 120


@dataclass(frozen=True)
class ApiDefaults:
    """API/auth defaults (reference ``config.py:71-75``)."""

    api_keys: str = '{"test-key": "test-user"}'
    redis_url: str = "redis://localhost:6379/0"


@dataclass(frozen=True)
class UploadDefaults:
    """Upload constraints (reference ``config.py:79-82``)."""

    allowed_exts: str = ".pdf"


@dataclass(frozen=True)
class ChunkDefaults:
    """Character chunking (reference ``config.py:86-90``)."""

    size_chars: int = 1200
    overlap_chars: int = 200
    split_tokens: int = 512
    split_overlap_tokens: int = 64


@dataclass(frozen=True)
class NotesDefaults:
    """Study notes/quiz generation (reference ``config.py:94-98``)."""

    context_chars: int = 4000
    quiz_questions: int = 5


@dataclass(frozen=True)
class CacheDefaults:
    """TTL caches (reference ``app/cache/__init__.py:17-19``)."""

    embed_ttl_sec: float = 300.0
    retrieval_ttl_sec: float = 120.0
    chat_ttl_sec: float = 60.0
    job_result_ttl_sec: float = 3600.0
    dedup_ttl_sec: float = 86400.0


@dataclass(frozen=True)
class TpuDefaults:
    """Execution knobs under their shared ``TPU_*`` env names.

    Batches are padded to static buckets so the shapes a kernel sees stay
    few; the index is a device-resident slab scored by the bucket-max top-k
    kernel (``ops/pallas_topk.py``), or an int8 / pq / ivf layout
    (``index/store.py``).
    """

    compute_dtype: str = "bfloat16"  # bf16 on CUDA; the CPU path runs f32
    index_dtype: str = ""  # bfloat16|float32|int8|pq ("" = compute_dtype)
    topk_backend: str = "auto"  # auto (dense B4 / pq scan) | ivf (partitioned)
    # W8A8 encoder towers ("" = off, "int8"): the MiniLM embed, the
    # cross-encoder trunk and the CLIP vision blocks run as B6 + B7 on the
    # card's int8 tensor cores (ops/quant.py); the CLIP text tower stays bf16
    encoder_quant: str = ""
    param_dtype: str = "float32"
    text_batch_buckets: str = "8,32,128,512,2048"
    image_batch_buckets: str = "8,32,128"
    text_seq_buckets: str = "64,128,256,384,512"
    # MiniLM text-embed truncation (tokens incl. [CLS]/[SEP]): 256 matches
    # SentenceTransformer's max_seq_length for all-MiniLM-L6-v2; 0 = no cap
    text_embed_max_len: int = 256
    # cross-encoder pair length: the ms-marco tokenizer truncates at 512
    rerank_seq_len: int = 512
    ivf_nprobe: int = 64
    ivf_min_rows: int = 65536
    ivf_min_structure: float = 1.5
    pq_m: int = 16
    pq_refine: int = 16
    pq_residual: bool = True
    pq_min_quality: float = 0.8
    index_shard_rows: int = 131072
    index_growth_factor: int = 2
    profile_dir: str = ""
    microbatch_window_ms: float = 4.0  # cross-request coalescing (0 = off)
    microbatch_max: int = 16
    microbatch_workers: int = 3
    index_journal: bool = True
    journal_poll_sec: float = 0.25
    job_workers: int = 1
    serving_warmup: bool = True
    device_watchdog_sec: float = 60.0


@dataclass(frozen=True)
class AppDefaults:
    """Aggregate of all defaults (reference ``config.py:101-115``)."""

    models: ModelDefaults = field(default_factory=ModelDefaults)
    gemini: GeminiDefaults = field(default_factory=GeminiDefaults)
    paths: PathDefaults = field(default_factory=PathDefaults)
    rate_limit: RateLimitDefaults = field(default_factory=RateLimitDefaults)
    retrieval: RetrievalDefaults = field(default_factory=RetrievalDefaults)
    youtube: YouTubeDefaults = field(default_factory=YouTubeDefaults)
    api: ApiDefaults = field(default_factory=ApiDefaults)
    uploads: UploadDefaults = field(default_factory=UploadDefaults)
    chunks: ChunkDefaults = field(default_factory=ChunkDefaults)
    notes: NotesDefaults = field(default_factory=NotesDefaults)
    cache: CacheDefaults = field(default_factory=CacheDefaults)
    tpu: TpuDefaults = field(default_factory=TpuDefaults)
    app_name: str = "Multimodal RAG SaaS (GPU)"


DEFAULTS = AppDefaults()
