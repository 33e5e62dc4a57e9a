"""Typed environment loader producing frozen per-domain settings.

Keeps the reference's env-var contract 1:1 (names validated against
``app/settings.py:13-252``): ``MODEL_TEXT``, ``LANCEDB_DIR``,
``INDEX_TOPK_TEXT``, ``YT_*``, ``API_KEYS`` … all behave identically, and the
execution knobs keep the ``TPU_*`` names of ``mmrag_tpu.settings`` so one
``.env`` drives both packages. The knobs only the TPU build reads (the XLA
compile cache, the mesh's axis names) are not read here, and
``TPU_TOPK_BACKEND`` takes only the port's three values (``auto``, ``ivf``, ``approx``). ``TPU_DATA_PARALLEL`` is validated as
the JAX package validates it (``auto`` / ``off`` / a device count).

Design: ``load_settings(env)`` is injectable for tests (reference
``app/settings.py:171``); the module-level ``settings`` singleton is built at
import time from ``os.environ`` (reference ``app/settings.py:256``) but can be
swapped via :func:`reload_settings`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

from .config import DEFAULTS
from .device import topk_backend


class SettingsError(ValueError):
    """Raised when an env var fails typed validation."""


def _read_env(env: Mapping[str, str], key: str, default: str) -> str:
    val = env.get(key)
    if val is None or val == "":
        return default
    return val


def _read_int(env: Mapping[str, str], key: str, default: int) -> int:
    raw = env.get(key)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError as exc:
        raise SettingsError(f"{key} must be an integer, got {raw!r}") from exc


def _read_float(env: Mapping[str, str], key: str, default: float) -> float:
    raw = env.get(key)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError as exc:
        raise SettingsError(f"{key} must be a float, got {raw!r}") from exc


_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}


def _read_data_parallel(env: Mapping[str, str], default: str) -> str:
    """``auto`` | ``off`` | a device count above 1 (``0``/``1`` and the
    false words mean ``off``), as ``mmrag_tpu/settings.py:102-114``."""

    raw = (env.get("TPU_DATA_PARALLEL") or default).strip().lower()
    if raw == "auto":
        return "auto"
    if raw in _FALSY:
        return "off"
    try:
        n = int(raw)
    except ValueError as exc:
        raise SettingsError(
            f"TPU_DATA_PARALLEL must be auto/off/<device count>, got {raw!r}"
        ) from exc
    return "off" if n <= 1 else str(n)


def _read_bool(env: Mapping[str, str], key: str, default: bool) -> bool:
    raw = env.get(key)
    if raw is None or raw == "":
        return default
    lowered = raw.strip().lower()
    if lowered in _TRUTHY:
        return True
    if lowered in _FALSY:
        return False
    raise SettingsError(f"{key} must be a boolean (1/0/true/false), got {raw!r}")


def _read_json_dict(env: Mapping[str, str], key: str, default: str) -> dict:
    raw = env.get(key) or default
    try:
        parsed = json.loads(raw)
    except json.JSONDecodeError as exc:
        raise SettingsError(f"{key} must be a JSON object, got {raw!r}") from exc
    if not isinstance(parsed, dict):
        raise SettingsError(f"{key} must be a JSON object, got {type(parsed).__name__}")
    return {str(k): str(v) for k, v in parsed.items()}


def _read_csv(env: Mapping[str, str], key: str, default: str) -> Tuple[str, ...]:
    raw = env.get(key) or default
    items = tuple(part.strip().lower() for part in raw.split(",") if part.strip())
    if not items:
        raise SettingsError(f"{key} must contain at least one entry")
    return items


def _read_int_csv(env: Mapping[str, str], key: str, default: str) -> Tuple[int, ...]:
    raw = env.get(key) or default
    try:
        items = tuple(int(p) for p in raw.split(",") if p.strip())
    except ValueError as exc:
        raise SettingsError(f"{key} must be comma-separated ints, got {raw!r}") from exc
    if not items or any(i <= 0 for i in items):
        raise SettingsError(f"{key} must be positive ints, got {raw!r}")
    return tuple(sorted(items))


# ---------------------------------------------------------------------------
# Per-domain frozen settings (reference app/settings.py:58-168)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelSettings:
    text: str
    clip: str
    reranker: str
    asr: str
    asr_language: str
    asr_timestamps: bool
    asr_word_align: bool


@dataclass(frozen=True)
class GeminiSettings:
    api_key: Optional[str]
    model: str


@dataclass(frozen=True)
class PathSettings:
    index_dir: str
    media_dir: str
    thumbs_dir: str
    ingest_cache_dir: str
    notes_db_path: str
    checkpoint_dir: str
    weights_dir: str


@dataclass(frozen=True)
class RateLimitSettings:
    per_minute: int


@dataclass(frozen=True)
class RetrievalSettings:
    use_rerank: bool
    index_topk_text: int
    index_topk_image: int
    rerank_topk: int
    final_n: int
    confidence_tau: float


@dataclass(frozen=True)
class YouTubeSettings:
    prefer_transcript: bool
    frame_scene_threshold: float
    max_frames: int
    frame_dedup_delta: int
    frame_stride_sec: int
    lazy_frames: bool
    frame_extractor: str
    max_duration_min: int
    download_format: str
    retries: int
    timeout_sec: int


@dataclass(frozen=True)
class ApiSettings:
    api_keys: Mapping[str, str]  # api key -> tenant/user id
    redis_url: str


@dataclass(frozen=True)
class UploadSettings:
    allowed_exts: Tuple[str, ...]


@dataclass(frozen=True)
class ChunkSettings:
    size_chars: int
    overlap_chars: int
    split_tokens: int
    split_overlap_tokens: int


@dataclass(frozen=True)
class NotesSettings:
    context_chars: int
    quiz_questions: int


@dataclass(frozen=True)
class CacheSettings:
    embed_ttl_sec: float
    retrieval_ttl_sec: float
    chat_ttl_sec: float
    job_result_ttl_sec: float
    dedup_ttl_sec: float


@dataclass(frozen=True)
class TpuSettings:
    compute_dtype: str
    param_dtype: str
    index_dtype: str  # "" follows compute_dtype; int8 affects ONLY the index
    topk_backend: str  # auto | ivf | approx (validated: the others raise)
    encoder_quant: str  # "" | "int8" — W8A8 encoder blocks (ops/quant.py)
    text_batch_buckets: Tuple[int, ...]
    image_batch_buckets: Tuple[int, ...]
    text_seq_buckets: Tuple[int, ...]
    rerank_seq_len: int
    text_embed_max_len: int  # ST max_seq_length parity cap (0 = uncapped)
    ivf_nprobe: int
    ivf_min_rows: int
    ivf_min_structure: float
    pq_m: int  # PQ subvectors (TPU_INDEX_DTYPE=pq; bytes per device row)
    pq_refine: int  # exact-rescore shortlist factor (k * refine candidates)
    pq_residual: bool  # ivf+pq: residual-encode bucket codes (FAISS convention)
    pq_min_quality: float  # reconstruction-cosine gate; below -> int8 demote
    index_shard_rows: int
    index_growth_factor: int
    data_parallel: str  # "auto" | "off" | device count (multi-device engine mode)
    profile_dir: str
    microbatch_window_ms: float  # 0 disables cross-request query batching
    microbatch_max: int
    microbatch_workers: int  # pipelined batch runners (1 = serial)
    index_journal: bool  # cross-process index mutation replication
    journal_poll_sec: float
    job_workers: int  # 0 = enqueue-only api (dedicated worker process)
    serving_warmup: bool  # pre-compile query-path buckets at server start
    device_watchdog_sec: float  # device-health probe period (0 = off)


@dataclass(frozen=True)
class Settings:
    app_name: str
    models: ModelSettings
    gemini: GeminiSettings
    paths: PathSettings
    rate_limit: RateLimitSettings
    retrieval: RetrievalSettings
    youtube: YouTubeSettings
    api: ApiSettings
    uploads: UploadSettings
    chunks: ChunkSettings
    notes: NotesSettings
    cache: CacheSettings
    tpu: TpuSettings


def load_settings(env: Optional[Mapping[str, str]] = None) -> Settings:
    """Build a :class:`Settings` tree from ``env`` (default ``os.environ``)."""

    env = os.environ if env is None else env
    d = DEFAULTS

    retrieval = RetrievalSettings(
        use_rerank=_read_bool(env, "RERANK_ENABLED", d.retrieval.use_rerank),
        index_topk_text=_read_int(env, "INDEX_TOPK_TEXT", d.retrieval.index_topk_text),
        index_topk_image=_read_int(env, "INDEX_TOPK_IMG", d.retrieval.index_topk_image),
        rerank_topk=_read_int(env, "RERANK_TOPK", d.retrieval.rerank_topk),
        final_n=_read_int(env, "FINAL_N", d.retrieval.final_n),
        confidence_tau=_read_float(env, "CONFIDENCE_TAU", d.retrieval.confidence_tau),
    )
    if retrieval.final_n <= 0 or retrieval.rerank_topk <= 0:
        raise SettingsError("FINAL_N and RERANK_TOPK must be positive")

    # LANCEDB_DIR is honored as an alias for the index root so reference .envs
    # keep working; TPU_INDEX_DIR wins when both are set.
    index_dir = _read_env(
        env, "TPU_INDEX_DIR", _read_env(env, "LANCEDB_DIR", d.paths.index_dir)
    )

    return Settings(
        app_name=_read_env(env, "APP_NAME", d.app_name),
        models=ModelSettings(
            text=_read_env(env, "MODEL_TEXT", d.models.text),
            clip=_read_env(env, "MODEL_CLIP", d.models.clip),
            reranker=_read_env(env, "RERANKER_MODEL", d.models.reranker),
            asr=_read_env(env, "MODEL_ASR", d.models.asr),
            asr_language=_read_env(env, "MODEL_ASR_LANGUAGE", d.models.asr_language),
            asr_timestamps=_read_bool(env, "MODEL_ASR_TIMESTAMPS", d.models.asr_timestamps),
            asr_word_align=_read_bool(
                env, "MODEL_ASR_WORD_ALIGN", d.models.asr_word_align),
        ),
        gemini=GeminiSettings(
            api_key=env.get("GEMINI_API_KEY") or None,
            model=_read_env(env, "GEMINI_MODEL", d.gemini.model),
        ),
        paths=PathSettings(
            index_dir=index_dir,
            media_dir=_read_env(env, "MEDIA_DIR", d.paths.media_dir),
            thumbs_dir=_read_env(env, "THUMBS_DIR", d.paths.thumbs_dir),
            ingest_cache_dir=_read_env(env, "INGEST_CACHE_DIR", d.paths.ingest_cache_dir),
            notes_db_path=_read_env(env, "NOTES_DB_PATH", d.paths.notes_db_path),
            checkpoint_dir=_read_env(env, "CHECKPOINT_DIR", d.paths.checkpoint_dir),
            weights_dir=_read_env(env, "WEIGHTS_DIR", d.paths.weights_dir),
        ),
        rate_limit=RateLimitSettings(
            per_minute=_read_int(env, "RATE_LIMIT_PER_MIN", d.rate_limit.per_minute),
        ),
        retrieval=retrieval,
        youtube=YouTubeSettings(
            prefer_transcript=_read_bool(env, "YT_PREFER_TRANSCRIPT", d.youtube.prefer_transcript),
            frame_scene_threshold=_read_float(
                env, "YT_FRAME_SCENE_THRESH", d.youtube.frame_scene_threshold
            ),
            max_frames=_read_int(env, "YT_MAX_FRAMES", d.youtube.max_frames),
            frame_dedup_delta=_read_int(env, "YT_FRAME_DEDUP_DELTA", d.youtube.frame_dedup_delta),
            frame_stride_sec=_read_int(env, "YT_FRAME_STRIDE_SEC", d.youtube.frame_stride_sec),
            lazy_frames=_read_bool(env, "YT_LAZY_FRAMES", d.youtube.lazy_frames),
            frame_extractor=_read_env(env, "YT_FRAME_EXTRACTOR", d.youtube.frame_extractor),
            max_duration_min=_read_int(env, "YT_MAX_DURATION_MIN", d.youtube.max_duration_min),
            download_format=_read_env(env, "YT_DOWNLOAD_FORMAT", d.youtube.download_format),
            retries=_read_int(env, "YT_RETRIES", d.youtube.retries),
            timeout_sec=_read_int(env, "YT_TIMEOUT_SEC", d.youtube.timeout_sec),
        ),
        api=ApiSettings(
            api_keys=_read_json_dict(env, "API_KEYS", d.api.api_keys),
            redis_url=_read_env(env, "REDIS_URL", d.api.redis_url),
        ),
        uploads=UploadSettings(
            allowed_exts=_read_csv(env, "ALLOWED_UPLOAD_EXTS", d.uploads.allowed_exts),
        ),
        chunks=ChunkSettings(
            size_chars=_read_int(env, "CHUNK_SIZE_CHARS", d.chunks.size_chars),
            overlap_chars=_read_int(env, "CHUNK_OVERLAP_CHARS", d.chunks.overlap_chars),
            split_tokens=_read_int(env, "SPLIT_TOKENS", d.chunks.split_tokens),
            split_overlap_tokens=_read_int(
                env, "SPLIT_OVERLAP_TOKENS", d.chunks.split_overlap_tokens
            ),
        ),
        notes=NotesSettings(
            context_chars=_read_int(env, "NOTE_CONTEXT_CHARS", d.notes.context_chars),
            quiz_questions=_read_int(env, "QUIZ_QUESTION_COUNT", d.notes.quiz_questions),
        ),
        cache=CacheSettings(
            embed_ttl_sec=_read_float(env, "CACHE_EMBED_TTL_SEC", d.cache.embed_ttl_sec),
            retrieval_ttl_sec=_read_float(
                env, "CACHE_RETRIEVAL_TTL_SEC", d.cache.retrieval_ttl_sec
            ),
            chat_ttl_sec=_read_float(env, "CACHE_CHAT_TTL_SEC", d.cache.chat_ttl_sec),
            job_result_ttl_sec=_read_float(
                env, "JOB_RESULT_TTL_SEC", d.cache.job_result_ttl_sec
            ),
            dedup_ttl_sec=_read_float(env, "DEDUP_TTL_SEC", d.cache.dedup_ttl_sec),
        ),
        tpu=TpuSettings(
            compute_dtype=_read_env(env, "TPU_COMPUTE_DTYPE", d.tpu.compute_dtype),
            index_dtype=_read_env(env, "TPU_INDEX_DTYPE", d.tpu.index_dtype),
            # auto | ivf | approx (slower than auto on the card: for parity with
            # the JAX package); xla/pallas raise ValueError
            topk_backend=topk_backend(_read_env(env, "TPU_TOPK_BACKEND", d.tpu.topk_backend)),
            encoder_quant=_read_env(env, "TPU_ENCODER_QUANT", d.tpu.encoder_quant),
            param_dtype=_read_env(env, "TPU_PARAM_DTYPE", d.tpu.param_dtype),
            text_batch_buckets=_read_int_csv(
                env, "TPU_TEXT_BATCH_BUCKETS", d.tpu.text_batch_buckets
            ),
            image_batch_buckets=_read_int_csv(
                env, "TPU_IMAGE_BATCH_BUCKETS", d.tpu.image_batch_buckets
            ),
            text_seq_buckets=_read_int_csv(env, "TPU_TEXT_SEQ_BUCKETS", d.tpu.text_seq_buckets),
            rerank_seq_len=_read_int(env, "TPU_RERANK_SEQ_LEN", d.tpu.rerank_seq_len),
            text_embed_max_len=_read_int(
                env, "TPU_TEXT_EMBED_MAX_LEN", d.tpu.text_embed_max_len
            ),
            ivf_nprobe=_read_int(env, "TPU_IVF_NPROBE", d.tpu.ivf_nprobe),
            ivf_min_rows=_read_int(env, "TPU_IVF_MIN_ROWS", d.tpu.ivf_min_rows),
            ivf_min_structure=_read_float(
                env, "TPU_IVF_MIN_STRUCTURE", d.tpu.ivf_min_structure
            ),
            pq_m=_read_int(env, "TPU_PQ_M", d.tpu.pq_m),
            pq_refine=_read_int(env, "TPU_PQ_REFINE", d.tpu.pq_refine),
            pq_residual=_read_bool(env, "TPU_PQ_RESIDUAL", d.tpu.pq_residual),
            pq_min_quality=_read_float(
                env, "TPU_PQ_MIN_QUALITY", d.tpu.pq_min_quality
            ),
            index_shard_rows=_read_int(env, "TPU_INDEX_SHARD_ROWS", d.tpu.index_shard_rows),
            index_growth_factor=_read_int(
                env, "TPU_INDEX_GROWTH_FACTOR", d.tpu.index_growth_factor
            ),
            data_parallel=_read_data_parallel(env, d.tpu.data_parallel),
            profile_dir=_read_env(env, "TPU_PROFILE_DIR", d.tpu.profile_dir),
            microbatch_window_ms=_read_float(
                env, "TPU_MICROBATCH_WINDOW_MS", d.tpu.microbatch_window_ms
            ),
            microbatch_max=_read_int(env, "TPU_MICROBATCH_MAX", d.tpu.microbatch_max),
            microbatch_workers=_read_int(
                env, "TPU_MICROBATCH_WORKERS", d.tpu.microbatch_workers
            ),
            index_journal=_read_bool(env, "TPU_INDEX_JOURNAL", d.tpu.index_journal),
            journal_poll_sec=_read_float(
                env, "TPU_JOURNAL_POLL_SEC", d.tpu.journal_poll_sec
            ),
            job_workers=_read_int(env, "TPU_JOB_WORKERS", d.tpu.job_workers),
            serving_warmup=_read_bool(
                env, "TPU_SERVING_WARMUP", d.tpu.serving_warmup
            ),
            device_watchdog_sec=_read_float(
                env, "TPU_DEVICE_WATCHDOG_SEC", d.tpu.device_watchdog_sec
            ),
        ),
    )


settings: Settings = load_settings()


def reload_settings(env: Optional[Mapping[str, str]] = None) -> Settings:
    """Rebuild the module singleton (test hook)."""

    global settings
    settings = load_settings(env)
    return settings
