"""Real-checkpoint discovery and conversion.

Port of ``mmrag_tpu/models/probe.py``: the standing probe that upgrades the
port to real weights the day they are provisioned.
:func:`find_real_checkpoints` finds local torch checkpoints (a flat directory
or the HF hub cache), and :func:`convert_found_into` converts them into a
``WEIGHTS_DIR`` with the architecture derived FROM each checkpoint, so the
production :class:`~mmrag_tpu_torch.models.runtime.EncoderRuntime` and
:class:`~mmrag_tpu_torch.ingest.asr.WhisperRuntime` load them instead of
seeded init.

The conversion runs on the host (``transformers`` on the CPU, numpy); no
kernel is launched here. A family whose conversion fails (a bad checkpoint
file, an unwritable directory) is logged and skipped, as in the JAX package;
what is written is loaded later by runtimes that raise on their own errors.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Dict, Optional

logger = logging.getLogger(__name__)

REAL_WEIGHT_FAMILIES = {
    # family -> the reference's checkpoint id
    "minilm": "sentence-transformers/all-MiniLM-L6-v2",
    "clip": "openai/clip-vit-base-patch32",
    "reranker": "cross-encoder/ms-marco-MiniLM-L-6-v2",
    "whisper": "openai/whisper-base",
}

TOKENIZER_FILES = (
    "vocab.txt", "vocab.json", "merges.txt", "tokenizer.json",
    "tokenizer_config.json", "special_tokens_map.json",
    "preprocessor_config.json",
)


def copy_tokenizer_files(src_dir: str, out: str, names=TOKENIZER_FILES) -> None:
    """Copy whatever tokenizer files the checkpoint ships into the
    converted-weights directory (shared by the CLI and the probe)."""

    for name in names:
        path = os.path.join(src_dir, name)
        if os.path.isfile(path):
            shutil.copy2(path, os.path.join(out, name))


def _has_weights(d: str) -> bool:
    if not os.path.isfile(os.path.join(d, "config.json")):
        return False
    return any(os.path.isfile(os.path.join(d, w))
               for w in ("pytorch_model.bin", "model.safetensors"))


def _safe_mtime(p: str) -> float:
    try:
        return os.path.getmtime(p)
    except OSError:  # a dangling entry in a partially collected cache
        return 0.0


def find_real_checkpoints() -> Dict[str, str]:
    """Probe for the four real reference checkpoints.

    Looks in ``TPU_REAL_WEIGHTS_DIR`` (a directory of per-model
    subdirectories, named by HF id with ``/``, ``--`` or ``__`` separators,
    or the bare model name), then the HF hub cache (``$HF_HOME/hub`` or
    ``~/.cache/huggingface/hub``, newest snapshot first). Returns ``{family:
    checkpoint_dir}`` for every family whose directory holds a config.json
    and torch weights; empty when none is provisioned."""

    found: Dict[str, str] = {}
    roots = []
    if os.environ.get("TPU_REAL_WEIGHTS_DIR"):
        roots.append(os.environ["TPU_REAL_WEIGHTS_DIR"])
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    hub = os.path.join(hf_home, "hub")
    for fam, model_id in REAL_WEIGHT_FAMILIES.items():
        candidates = []
        for root in roots:
            candidates += [
                os.path.join(root, model_id),
                os.path.join(root, model_id.replace("/", "--")),
                os.path.join(root, model_id.replace("/", "__")),
                os.path.join(root, model_id.split("/")[-1]),
            ]
        snap_root = os.path.join(hub, "models--" + model_id.replace("/", "--"), "snapshots")
        if os.path.isdir(snap_root):
            try:
                entries = os.listdir(snap_root)
            except OSError:
                entries = []
            candidates += sorted((os.path.join(snap_root, s) for s in entries),
                                 key=_safe_mtime, reverse=True)
        for cand in candidates:
            if os.path.isdir(cand) and _has_weights(cand):
                found[fam] = cand
                break
    return found


def convert_whisper_checkpoint(src: str, weights_dir: str,
                               model_id: str = "openai/whisper-base"):
    """Convert a local torch whisper checkpoint into the layout the ASR
    runtime loads (``<weights_dir>/<id with '/'->'__'>/model.npz`` with its
    architecture in the meta file, plus ``vocab.json`` for the byte-level
    BPE decoder the aligner needs). The architecture is derived FROM the
    checkpoint. Returns the derived ``WhisperConfig``."""

    import dataclasses

    import transformers

    from . import convert
    from .runtime import _sanitize
    from .validate import state_dict_numpy, whisper_config_from_hf

    model = transformers.WhisperForConditionalGeneration.from_pretrained(src)
    hf = model.config
    if hf.decoder_ffn_dim != hf.encoder_ffn_dim:
        raise ValueError("asymmetric encoder/decoder ffn dims are unsupported")
    cfg = whisper_config_from_hf(hf)
    params = convert.convert_whisper(state_dict_numpy(model), cfg)
    out = os.path.join(weights_dir, _sanitize(model_id))
    os.makedirs(out, exist_ok=True)
    convert.save_params(params, out, "model",
                        meta={"arch": "whisper", "config": dataclasses.asdict(cfg),
                              "source": src})
    try:
        # vocab.json drives the ByteLevelBPEDecoder (word alignment)
        transformers.AutoTokenizer.from_pretrained(src).save_vocabulary(out)
    except Exception:  # a raw checkpoint without tokenizer config
        copy_tokenizer_files(src, out)
    return cfg


def convert_found_into(weights_dir: str, found: Dict[str, str],
                       families: Optional[tuple] = None) -> Dict[str, object]:
    """Convert local checkpoints into ``weights_dir`` in the production
    layout (``<weights_dir>/<model_id with '/'->'__'>/model.npz`` plus
    tokenizer files), each architecture derived from its checkpoint.

    Returns ``{family: derived_config}`` for the converted families; the
    whisper family converts into the layout
    :mod:`mmrag_tpu_torch.ingest.asr` loads. A family whose conversion fails
    is logged and skipped, never fatal: one bad checkpoint must not take
    down the probe's upgrade path."""

    import transformers

    from . import convert
    from . import validate as val
    from .runtime import _sanitize

    converted: Dict[str, object] = {}
    for fam in families or ("minilm", "clip", "reranker", "whisper"):
        src = found.get(fam)
        if not src:
            continue
        logger.info("converting real %s checkpoint from %s", fam, src)
        try:
            if fam == "whisper":
                converted[fam] = convert_whisper_checkpoint(src, weights_dir,
                                                            REAL_WEIGHT_FAMILIES[fam])
                continue
            if fam == "minilm":
                model = transformers.BertModel.from_pretrained(src).eval()
                cfg = val.bert_config_from_hf(model.config)
                params = convert.convert_bert(val.state_dict_numpy(model), cfg)
            elif fam == "reranker":
                model = transformers.BertForSequenceClassification.from_pretrained(src).eval()
                cfg = val.bert_config_from_hf(model.config)
                params = convert.convert_cross_encoder(val.state_dict_numpy(model), cfg)
            else:  # clip
                model = transformers.CLIPModel.from_pretrained(src).eval()
                cfg = val.clip_config_from_hf(model.config)
                params = convert.convert_clip(val.state_dict_numpy(model), cfg)
            out = os.path.join(weights_dir, _sanitize(REAL_WEIGHT_FAMILIES[fam]))
            os.makedirs(out, exist_ok=True)
            convert.save_params(params, out, "model", meta={"arch": fam, "source": src})
            copy_tokenizer_files(src, out)
        except Exception:
            # the skip-never-fatal rule covers the write side too (disk
            # full, an unwritable weights_dir)
            logger.exception("conversion of %s checkpoint failed; skipping", fam)
            continue
        converted[fam] = cfg
    return converted
