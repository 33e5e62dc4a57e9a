"""Parameter persistence and the carry-across from the JAX package's layout.

Port of the persistence half of ``mmrag_tpu/models/convert.py``
(``:235-283``): the same flat ``.npz`` with ``/``-joined keys, read and
written with numpy only, so each package loads what the other saves.

:func:`params_from_jax` turns a JAX-layout tree (``flatten_params`` output,
numpy) into the port's tensors. The port's own layout changes happen here
and nowhere else:

* the q, k and v projections of every encoder layer are concatenated into
  one ``qkv`` (h, 3h) kernel and (3h,) bias, read by the fused projection of
  the B1 block;
* matrices (the ``kernel`` of every dense layer, CLIP's ``patch_kernel``)
  are cast once to the working dtype, where the JAX package casts them at
  every call; biases, LayerNorms and embeddings stay f32;
* with ``q8=True`` the result is instead the W8A8 form of the encoder blocks
  (``TPU_ENCODER_QUANT=int8``: the BERT trunk's, or CLIP's vision layers),
  quantized from the f32 weights before any cast, as the JAX package
  quantizes its f32 params.

* Whisper (``kind="whisper"``) keeps the JAX tree as it is; only its
  matrices are cast.

:func:`params_to_jax` is the inverse for the three towers, so a tower
fine-tuned by :mod:`mmrag_tpu_torch.parallel.training` is saved in the JAX
package's layout.

The HF-checkpoint converters (JAX ``convert.py:34-233``):
:func:`convert_bert`, :func:`convert_cross_encoder`, :func:`convert_clip` and
:func:`convert_whisper` read a local HF state dict (numpy) into the
JAX-layout tree as numpy arrays, which ``save_params`` writes in the JAX
package's flat npz and ``params_from_jax`` turns into tensors.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

Params = Dict[str, Any]
StateDict = Mapping[str, np.ndarray]


# ---------------------------------------------------------------------------
# HF state dict -> the JAX-layout tree (numpy)
# ---------------------------------------------------------------------------


def _linear(sd: StateDict, prefix: str, bias: bool = True) -> Params:
    """torch ``nn.Linear`` stores (out, in); dense kernels are (in, out)."""

    p: Params = {"kernel": np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight"]).T)}
    if bias:
        p["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return p


def _ln(sd: StateDict, prefix: str) -> Params:
    return {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])}


def convert_bert(sd: StateDict, cfg, prefix: str = "") -> Params:
    """Convert an HF ``BertModel`` state dict (optionally under ``prefix``);
    ``cfg`` is a ``BertConfig`` (its ``num_layers`` layers are read)."""

    def k(name: str) -> str:
        return f"{prefix}{name}"

    params: Params = {
        "embeddings": {
            "word": np.asarray(sd[k("embeddings.word_embeddings.weight")]),
            "position": np.asarray(sd[k("embeddings.position_embeddings.weight")]),
            "token_type": np.asarray(sd[k("embeddings.token_type_embeddings.weight")]),
            "ln": _ln(sd, k("embeddings.LayerNorm")),
        },
        "layers": [],
    }
    for i in range(cfg.num_layers):
        base = k(f"encoder.layer.{i}")
        params["layers"].append({
            "q": _linear(sd, f"{base}.attention.self.query"),
            "k": _linear(sd, f"{base}.attention.self.key"),
            "v": _linear(sd, f"{base}.attention.self.value"),
            "attn_out": _linear(sd, f"{base}.attention.output.dense"),
            "attn_ln": _ln(sd, f"{base}.attention.output.LayerNorm"),
            "ffn_in": _linear(sd, f"{base}.intermediate.dense"),
            "ffn_out": _linear(sd, f"{base}.output.dense"),
            "ffn_ln": _ln(sd, f"{base}.output.LayerNorm"),
        })
    return params


def convert_cross_encoder(sd: StateDict, cfg) -> Params:
    """Convert HF ``BertForSequenceClassification`` (num_labels=1)."""

    return {
        "bert": convert_bert(sd, cfg, prefix="bert."),
        "pooler": _linear(sd, "bert.pooler.dense"),
        "classifier": _linear(sd, "classifier"),
    }


def _clip_encoder_layers(sd: StateDict, prefix: str, num_layers: int) -> list:
    layers = []
    for i in range(num_layers):
        base = f"{prefix}.layers.{i}"
        layers.append({
            "ln1": _ln(sd, f"{base}.layer_norm1"),
            "q": _linear(sd, f"{base}.self_attn.q_proj"),
            "k": _linear(sd, f"{base}.self_attn.k_proj"),
            "v": _linear(sd, f"{base}.self_attn.v_proj"),
            "attn_out": _linear(sd, f"{base}.self_attn.out_proj"),
            "ln2": _ln(sd, f"{base}.layer_norm2"),
            "fc1": _linear(sd, f"{base}.mlp.fc1"),
            "fc2": _linear(sd, f"{base}.mlp.fc2"),
        })
    return layers


def convert_clip(sd: StateDict, cfg) -> Params:
    """Convert an HF ``CLIPModel`` state dict; ``cfg`` is a ``CLIPConfig``.
    The patch convolution (h, 3, p, p) becomes the (3 p p, h) kernel of the
    patch product, and ``logit_scale`` is carried."""

    v = cfg.vision
    patch_w = np.asarray(sd["vision_model.embeddings.patch_embedding.weight"])
    patch_kernel = np.ascontiguousarray(patch_w.reshape(v.hidden_size, -1).T)
    # HF spells it "pre_layrnorm" (sic)
    pre_ln_key = ("vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd
                  else "vision_model.pre_layernorm")
    return {
        "vision": {
            "class_embedding": np.asarray(sd["vision_model.embeddings.class_embedding"]),
            "patch_kernel": patch_kernel,
            "position_embedding": np.asarray(
                sd["vision_model.embeddings.position_embedding.weight"]),
            "pre_ln": _ln(sd, pre_ln_key),
            "layers": _clip_encoder_layers(sd, "vision_model.encoder", v.num_layers),
            "post_ln": _ln(sd, "vision_model.post_layernorm"),
        },
        "text": {
            "token_embedding": np.asarray(sd["text_model.embeddings.token_embedding.weight"]),
            "position_embedding": np.asarray(
                sd["text_model.embeddings.position_embedding.weight"]),
            "layers": _clip_encoder_layers(sd, "text_model.encoder", cfg.text.num_layers),
            "final_ln": _ln(sd, "text_model.final_layer_norm"),
        },
        "visual_projection": _linear(sd, "visual_projection", bias=False),
        "text_projection": _linear(sd, "text_projection", bias=False),
        "logit_scale": np.asarray(sd["logit_scale"]),
    }


def _conv1d_kernel(sd: StateDict, prefix: str) -> Params:
    """torch ``Conv1d.weight`` (out, in, k) -> the unfold product's kernel
    (k*in, out), k-major to match :func:`mmrag_tpu_torch.models.whisper._unfold3`."""

    w = np.asarray(sd[f"{prefix}.weight"])
    kernel = np.ascontiguousarray(w.transpose(2, 1, 0).reshape(-1, w.shape[0]))
    return {"kernel": kernel, "bias": np.asarray(sd[f"{prefix}.bias"])}


def _whisper_attn(sd: StateDict, base: str) -> Params:
    return {
        "q": _linear(sd, f"{base}.q_proj"),
        "k": _linear(sd, f"{base}.k_proj", bias=False),
        "v": _linear(sd, f"{base}.v_proj"),
        "out": _linear(sd, f"{base}.out_proj"),
    }


def convert_whisper(sd: StateDict, cfg) -> Params:
    """Convert an HF ``WhisperModel`` / ``WhisperForConditionalGeneration``
    state dict (``proj_out`` is tied to the token embedding, so it is never
    read) into the JAX-layout tree of numpy arrays; ``cfg`` is a
    ``WhisperConfig``."""

    if "model.encoder.conv1.weight" in sd:  # ForConditionalGeneration wrapper
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    enc_layers = []
    for i in range(cfg.encoder_layers):
        base = f"encoder.layers.{i}"
        enc_layers.append({
            "ln1": _ln(sd, f"{base}.self_attn_layer_norm"),
            "attn": _whisper_attn(sd, f"{base}.self_attn"),
            "ln2": _ln(sd, f"{base}.final_layer_norm"),
            "fc1": _linear(sd, f"{base}.fc1"),
            "fc2": _linear(sd, f"{base}.fc2"),
        })
    dec_layers = []
    for i in range(cfg.decoder_layers):
        base = f"decoder.layers.{i}"
        dec_layers.append({
            "ln1": _ln(sd, f"{base}.self_attn_layer_norm"),
            "self_attn": _whisper_attn(sd, f"{base}.self_attn"),
            "ln_cross": _ln(sd, f"{base}.encoder_attn_layer_norm"),
            "cross_attn": _whisper_attn(sd, f"{base}.encoder_attn"),
            "ln2": _ln(sd, f"{base}.final_layer_norm"),
            "fc1": _linear(sd, f"{base}.fc1"),
            "fc2": _linear(sd, f"{base}.fc2"),
        })
    return {
        "encoder": {
            "conv1": _conv1d_kernel(sd, "encoder.conv1"),
            "conv2": _conv1d_kernel(sd, "encoder.conv2"),
            "positions": np.asarray(sd["encoder.embed_positions.weight"]),
            "layers": enc_layers,
            "final_ln": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "token_embedding": np.asarray(sd["decoder.embed_tokens.weight"]),
            "positions": np.asarray(sd["decoder.embed_positions.weight"]),
            "layers": dec_layers,
            "final_ln": _ln(sd, "decoder.layer_norm"),
        },
    }


# ---------------------------------------------------------------------------
# Persistence: flat .npz with /-joined paths
# ---------------------------------------------------------------------------


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    if isinstance(params, dict):
        for key, val in params.items():
            flat.update(flatten_params(val, f"{prefix}{key}/"))
    elif isinstance(params, (list, tuple)):
        for i, val in enumerate(params):
            flat.update(flatten_params(val, f"{prefix}{i}/"))
    else:
        if isinstance(params, torch.Tensor):
            params = params.detach().float().cpu().numpy()
        flat[prefix[:-1]] = np.asarray(params)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Params:
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(val)
    return _listify(tree)


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_listify(node[str(i)]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def save_params(params: Params, directory: str, name: str, meta: Dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.npz")
    np.savez(path, **flatten_params(params))
    if meta is not None:
        with open(os.path.join(directory, f"{name}.json"), "w") as fh:
            json.dump(meta, fh, indent=2, sort_keys=True)
    return path


def load_params(directory: str, name: str) -> Params:
    with np.load(os.path.join(directory, f"{name}.npz")) as data:
        return unflatten_params({k: data[k] for k in data.files})


def params_available(directory: str, name: str) -> bool:
    return os.path.exists(os.path.join(directory, f"{name}.npz"))


# ---------------------------------------------------------------------------
# JAX layout -> the port's tensors
# ---------------------------------------------------------------------------


_KINDS = ("minilm", "cross", "clip", "whisper")


def params_from_jax(
    flat: Mapping[str, np.ndarray],
    kind: str,
    cfg=None,
    device="cpu",
    dtype: torch.dtype = torch.float32,
    q8: bool = False,
) -> Params:
    """The port's parameter tree for ``kind`` in ``{"minilm", "cross",
    "clip", "whisper"}`` from JAX-layout parameters: a flat
    ``{"a/b/0/c": array}`` mapping (``flatten_params`` output) or the nested
    tree itself.

    ``cfg`` (a ``BertConfig`` / ``CLIPConfig`` / ``WhisperConfig``) is
    checked against the shapes when given; ``dtype`` is the working dtype of
    the matrices.

    ``q8=True`` returns ``{"layers": [...]}``, the int8 encoder blocks the
    towers take as ``q8_layers`` (``bert.quantize_bert`` of the MiniLM tree
    or of the cross-encoder's trunk, ``clip.quantize_clip_vision``),
    quantized on the CPU from the f32 weights and then moved to ``device``;
    ``dtype`` is not used."""

    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {_KINDS}")
    if q8:
        if kind == "whisper":
            raise ValueError("whisper has no int8 form")
        from . import bert, clip

        f32 = params_from_jax(flat, kind, cfg)
        if kind == "clip":
            quant = clip.quantize_clip_vision(f32)
        else:
            quant = bert.quantize_bert(f32["bert"] if kind == "cross" else f32)
        return _to_device(quant, torch.device(device))
    if any(isinstance(v, (dict, list)) for v in flat.values()):
        flat = flatten_params(dict(flat))
    tree = unflatten_params(flat)
    dev = torch.device(device)

    # np.array copies: the loaded arrays may be read-only views
    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    def mat(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype).contiguous()

    def dense(p) -> Params:
        out = {"kernel": mat(p["kernel"])}
        if "bias" in p:
            out["bias"] = f32(p["bias"])
        return out

    def ln(p) -> Params:
        return {"scale": f32(p["scale"]), "bias": f32(p["bias"])}

    def encoder_layer(p) -> Params:
        out: Params = {
            "qkv": {
                "kernel": mat(np.concatenate(
                    [p["q"]["kernel"], p["k"]["kernel"], p["v"]["kernel"]], axis=1)),
                "bias": f32(np.concatenate([p["q"]["bias"], p["k"]["bias"], p["v"]["bias"]])),
            },
            "attn_out": dense(p["attn_out"]),
        }
        for key, val in p.items():
            if key in ("q", "k", "v", "attn_out"):
                continue
            out[key] = ln(val) if "scale" in val else dense(val)
        return out

    def bert(p) -> Params:
        emb = p["embeddings"]
        return {
            "embeddings": {
                "word": f32(emb["word"]),
                "position": f32(emb["position"]),
                "token_type": f32(emb["token_type"]),
                "ln": ln(emb["ln"]),
            },
            "layers": [encoder_layer(layer) for layer in p["layers"]],
        }

    def whisper(node):
        # the JAX tree kept as it is: dense layers (the conv stems, q/k/v/out,
        # fc1/fc2) cast their matrices, every other array stays f32
        if isinstance(node, list):
            return [whisper(v) for v in node]
        if "kernel" in node:
            return dense(node)
        if "scale" in node:
            return ln(node)
        return {k: whisper(v) if isinstance(v, (dict, list)) else f32(v)
                for k, v in node.items()}

    if kind == "whisper":
        out = whisper(tree)
        _check_whisper(out, cfg)
        return out
    if kind == "minilm":
        out = bert(tree)
        _check_bert(out, cfg)
        return out
    if kind == "cross":
        out = {
            "bert": bert(tree["bert"]),
            "pooler": dense(tree["pooler"]),
            "classifier": dense(tree["classifier"]),
        }
        _check_bert(out["bert"], cfg)
        return out
    vis, txt = tree["vision"], tree["text"]
    out = {
        "vision": {
            "class_embedding": f32(vis["class_embedding"]),
            "patch_kernel": mat(vis["patch_kernel"]),
            "position_embedding": f32(vis["position_embedding"]),
            "pre_ln": ln(vis["pre_ln"]),
            "layers": [encoder_layer(layer) for layer in vis["layers"]],
            "post_ln": ln(vis["post_ln"]),
        },
        "text": {
            "token_embedding": f32(txt["token_embedding"]),
            "position_embedding": f32(txt["position_embedding"]),
            "layers": [encoder_layer(layer) for layer in txt["layers"]],
            "final_ln": ln(txt["final_ln"]),
        },
        "visual_projection": dense(tree["visual_projection"]),
        "text_projection": dense(tree["text_projection"]),
        # serving never reads it; the contrastive loss trains it
        "logit_scale": f32(tree["logit_scale"]),
    }
    if cfg is not None:
        v, t = cfg.vision, cfg.text
        shapes = (
            (len(out["vision"]["layers"]), v.num_layers),
            (out["vision"]["patch_kernel"].shape[1], v.hidden_size),
            (len(out["text"]["layers"]), t.num_layers),
            (out["text"]["token_embedding"].shape[1], t.hidden_size),
            (out["visual_projection"]["kernel"].shape[1], cfg.projection_dim),
        )
        if any(got != want for got, want in shapes):
            raise ValueError(f"clip params do not match {cfg}")
    return out


def params_to_jax(params: Params, kind: str) -> Params:
    """The JAX-layout tree (nested numpy f32) of a port tree of ``kind`` in
    ``{"minilm", "cross", "clip"}``: the exact inverse of
    :func:`params_from_jax` on f32 matrices. Each fused ``qkv`` splits back
    into ``q``, ``k`` and ``v`` by column thirds; every other leaf is copied
    as it is (``logit_scale`` too). ``save_params(params_to_jax(p, kind),
    dir, "model")`` writes a tower that both packages load from
    ``WEIGHTS_DIR``."""

    if kind not in ("minilm", "cross", "clip"):
        raise ValueError(f"params_to_jax takes minilm, cross or clip, not {kind!r}")

    def arr(t) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy().copy()

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return arr(node)
        out: Params = {}
        for key, val in node.items():
            if key == "qkv":
                w, b = arr(val["kernel"]), arr(val["bias"])
                h = w.shape[1] // 3
                for i, name in enumerate("qkv"):
                    out[name] = {"kernel": np.ascontiguousarray(w[:, i * h:(i + 1) * h]),
                                 "bias": b[i * h:(i + 1) * h].copy()}
            else:
                out[key] = walk(val)
        return out

    return walk(params)


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _check_bert(p: Params, cfg) -> None:
    if cfg is None:
        return
    if (len(p["layers"]) != cfg.num_layers
            or p["embeddings"]["word"].shape != (cfg.vocab_size, cfg.hidden_size)):
        raise ValueError(f"bert params do not match {cfg}")


def _check_whisper(p: Params, cfg) -> None:
    if cfg is None:
        return
    enc, dec = p["encoder"], p["decoder"]
    if (len(enc["layers"]) != cfg.encoder_layers or len(dec["layers"]) != cfg.decoder_layers
            or dec["token_embedding"].shape[1] != cfg.d_model
            or enc["conv1"]["kernel"].shape[0] != 3 * cfg.num_mel_bins):
        raise ValueError(f"whisper params do not match {cfg}")
