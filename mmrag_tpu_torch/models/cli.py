"""Weight conversion CLI: HF torch checkpoints -> the flat npz weight dirs.

Port of ``mmrag_tpu/models/cli.py``. Usage (the checkpoints must be local:
point at a downloaded directory or the hub cache):

    python -m mmrag_tpu_torch.models.cli convert-minilm   <hf_dir_or_id> [--out DIR]
    python -m mmrag_tpu_torch.models.cli convert-clip     <hf_dir_or_id> [--out DIR]
    python -m mmrag_tpu_torch.models.cli convert-reranker <hf_dir_or_id> [--out DIR]
    python -m mmrag_tpu_torch.models.cli convert-whisper  <hf_dir_or_id> [--out DIR]
    python -m mmrag_tpu_torch.models.cli validate --minilm DIR [--clip DIR]
        [--reranker DIR] [--whisper DIR] [--out DIR] [--model-id ID] [--no-save]
        [--platform cpu]

``convert-*`` writes ``WEIGHTS_DIR/<model-id>/model.npz`` (the JAX package's
format: either package loads it) plus tokenizer files, on the host.
``validate`` runs the battery of :mod:`mmrag_tpu_torch.models.validate` on
the card, or on the CPU with ``--platform cpu`` (or ``MMRAG_PLATFORM=cpu``),
prints one JSON report on stdout, and persists the converted weights only
when every gate passes. Exit codes: 1 when a gate fails (nothing is
written); 2 when nothing is given to validate or a dependency
(``transformers``) is missing.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..settings import settings
from . import bert as tbert
from . import clip as tclip
from . import convert
from .probe import REAL_WEIGHT_FAMILIES, TOKENIZER_FILES, copy_tokenizer_files
from .runtime import _sanitize
from .validate import state_dict_numpy

FAMILIES = ("minilm", "clip", "reranker", "whisper")


def _out_dir(args, model_id: str) -> str:
    out = os.path.join(args.out or settings.paths.weights_dir, _sanitize(model_id))
    os.makedirs(out, exist_ok=True)
    return out


def convert_minilm(args) -> None:
    from transformers import AutoTokenizer, BertModel

    model = BertModel.from_pretrained(args.source)
    params = convert.convert_bert(state_dict_numpy(model), tbert.MINILM_L6)
    out = _out_dir(args, args.model_id or REAL_WEIGHT_FAMILIES["minilm"])
    convert.save_params(params, out, "model", meta={"arch": "minilm-l6"})
    AutoTokenizer.from_pretrained(args.source).save_vocabulary(out)
    print(f"wrote {out}/model.npz")


def convert_reranker(args) -> None:
    from transformers import AutoTokenizer, BertForSequenceClassification

    model = BertForSequenceClassification.from_pretrained(args.source)
    params = convert.convert_cross_encoder(state_dict_numpy(model), tbert.MINILM_L6)
    out = _out_dir(args, args.model_id or REAL_WEIGHT_FAMILIES["reranker"])
    convert.save_params(params, out, "model", meta={"arch": "bert-cross-encoder"})
    AutoTokenizer.from_pretrained(args.source).save_vocabulary(out)
    print(f"wrote {out}/model.npz")


def convert_clip(args) -> None:
    from transformers import CLIPModel, CLIPTokenizer

    model = CLIPModel.from_pretrained(args.source)
    params = convert.convert_clip(state_dict_numpy(model), tclip.CLIP_VIT_B32)
    out = _out_dir(args, args.model_id or REAL_WEIGHT_FAMILIES["clip"])
    convert.save_params(params, out, "model", meta={"arch": "clip-vit-b32"})
    CLIPTokenizer.from_pretrained(args.source).save_vocabulary(out)
    print(f"wrote {out}/model.npz")


def convert_whisper(args) -> None:
    from .probe import convert_whisper_checkpoint

    model_id = args.model_id or REAL_WEIGHT_FAMILIES["whisper"]
    base = args.out or settings.paths.weights_dir
    convert_whisper_checkpoint(args.source, base, model_id)
    print(f"wrote {os.path.join(base, _sanitize(model_id))}/model.npz")


def validate_checkpoints(args) -> None:
    """For each checkpoint given: derive the architecture from it, run the
    battery (:mod:`mmrag_tpu_torch.models.validate`) on ``--platform``'s
    device, print one JSON report, and persist the converted weights and
    tokenizer files as the ``convert-*`` subcommands do, only when every
    gate passes. A failing gate exits 1 with nothing written."""

    import dataclasses
    import json

    from . import validate as val

    sources = {fam: getattr(args, fam) for fam in FAMILIES if getattr(args, fam)}
    if not sources:
        print("nothing to validate: pass --minilm/--clip/--reranker/--whisper "
              "<checkpoint_dir>", file=sys.stderr)
        raise SystemExit(2)
    if args.model_id and len(sources) > 1:
        # one target dir for several families: each model.npz would overwrite
        # the one before
        print("--model-id applies to a single family; validating "
              f"{sorted(sources)} into one dir would overwrite weights", file=sys.stderr)
        raise SystemExit(2)
    device = args.platform or None
    reports = []
    all_ok = True
    for fam, src in sources.items():
        rep = val.VALIDATORS[fam](src, device=device)
        passed = val.report_passed(rep)
        all_ok &= passed
        out_path = None
        if passed and not args.no_save:
            model_id = args.model_id or REAL_WEIGHT_FAMILIES[fam]
            out = os.path.join(args.out or settings.paths.weights_dir, _sanitize(model_id))
            os.makedirs(out, exist_ok=True)
            meta = {"arch": fam, "validated": True}
            if fam == "whisper":
                meta["config"] = dataclasses.asdict(rep["_cfg"])
            convert.save_params(rep["_params"], out, "model", meta=meta)
            if os.path.isdir(src):
                copy_tokenizer_files(src, out, TOKENIZER_FILES)
            out_path = out
        public = val.public_report(rep)
        public["passed"] = passed
        public["saved_to"] = out_path
        reports.append(public)
        status = "PASS" if passed else "FAIL"
        print(f"[{status}] {fam}: " + ", ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in public.items() if k not in ("config", "saved_to")), file=sys.stderr)
    print(json.dumps({"reports": reports, "passed": all_ok}, default=str))
    if not all_ok:
        raise SystemExit(1)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="mmrag_tpu_torch.models.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, fn in (("convert-minilm", convert_minilm), ("convert-clip", convert_clip),
                     ("convert-reranker", convert_reranker),
                     ("convert-whisper", convert_whisper)):
        p = sub.add_parser(name)
        p.add_argument("source", help="HF model id or local checkpoint dir")
        p.add_argument("--out", default=None, help="weights root (default WEIGHTS_DIR)")
        p.add_argument("--model-id", default=None, help="override target dir name")
        p.set_defaults(fn=fn)
    v = sub.add_parser(
        "validate",
        help="convert + run the real-weights parity/accuracy battery; "
             "persists converted weights only when every gate passes")
    for fam in FAMILIES:
        v.add_argument(f"--{fam}", default=None, help=f"{fam} HF checkpoint dir (or hub id)")
    v.add_argument("--out", default=None, help="weights root (default WEIGHTS_DIR)")
    v.add_argument("--model-id", default=None,
                   help="override target dir name (single-family runs)")
    v.add_argument("--no-save", action="store_true",
                   help="validate only; do not persist converted weights")
    v.add_argument("--platform", default=os.environ.get("MMRAG_PLATFORM", ""),
                   help="torch device of the battery: cuda (the default) or cpu")
    v.set_defaults(fn=validate_checkpoints)
    args = parser.parse_args(argv)
    try:
        args.fn(args)
    except ImportError as exc:
        print(f"missing dependency for conversion: {exc}", file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
