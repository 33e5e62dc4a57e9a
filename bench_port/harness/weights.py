"""Seeded weights for the three towers, made on the device.

Each model's leaves are cut from one ``torch.randn`` over its whole size,
drawn by a generator on the run's device from the seed, scaled as trained
checkpoints of these families are (matrices ``1/sqrt(fan_in)``, embeddings
0.05, biases 0.02, LayerNorm scales ``1 + 0.05 n``), and rounded to
float16, the type the flat ``.npz`` carries them in. The tree (numpy,
the flat layout's nesting) goes to the system under test through its own
loader, as ``WEIGHTS_DIR/<model>/model.npz``, and the same arrays to the
plain reference.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Leaf = Tuple[str, Tuple[int, ...], str]


def _linear(path: str, fan_in: int, fan_out: int, bias: bool = True) -> List[Leaf]:
    out = [(f"{path}/kernel", (fan_in, fan_out), "w")]
    return out + ([(f"{path}/bias", (fan_out,), "b")] if bias else [])


def _ln(path: str, dim: int) -> List[Leaf]:
    return [(f"{path}/scale", (dim,), "s"), (f"{path}/bias", (dim,), "b")]


def bert_leaves(m: Dict, prefix: str = "") -> List[Leaf]:
    h, inter = m["hidden_size"], m["intermediate_size"]
    leaves = [(f"{prefix}embeddings/word", (m["vocab_size"], h), "e"),
              (f"{prefix}embeddings/position", (m["max_position_embeddings"], h), "e"),
              (f"{prefix}embeddings/token_type", (m["type_vocab_size"], h), "e"),
              *_ln(f"{prefix}embeddings/ln", h)]
    for i in range(m["num_hidden_layers"]):
        base = f"{prefix}layers/{i}"
        for name in ("q", "k", "v", "attn_out"):
            leaves += _linear(f"{base}/{name}", h, h)
        leaves += _ln(f"{base}/attn_ln", h)
        leaves += _linear(f"{base}/ffn_in", h, inter) + _linear(f"{base}/ffn_out", inter, h)
        leaves += _ln(f"{base}/ffn_ln", h)
    return leaves


def cross_leaves(m: Dict) -> List[Leaf]:
    h = m["hidden_size"]
    return (bert_leaves(m, "bert/") + _linear("pooler", h, h)
            + _linear("classifier", h, m.get("num_labels", 1)))


def _clip_layers(prefix: str, layers: int, h: int, inter: int) -> List[Leaf]:
    out: List[Leaf] = []
    for i in range(layers):
        base = f"{prefix}/layers/{i}"
        out += _ln(f"{base}/ln1", h)
        for name in ("q", "k", "v", "attn_out"):
            out += _linear(f"{base}/{name}", h, h)
        out += _ln(f"{base}/ln2", h) + _linear(f"{base}/fc1", h, inter)
        out += _linear(f"{base}/fc2", inter, h)
    return out


def clip_leaves(m: Dict) -> List[Leaf]:
    v, t = m["vision_config"], m["text_config"]
    hv, ht, proj = v["hidden_size"], t["hidden_size"], m["projection_dim"]
    patches = (v["image_size"] // v["patch_size"]) ** 2
    return ([("vision/class_embedding", (hv,), "e"),
             ("vision/patch_kernel", (3 * v["patch_size"] ** 2, hv), "w"),
             ("vision/position_embedding", (patches + 1, hv), "e"),
             *_ln("vision/pre_ln", hv)]
            + _clip_layers("vision", v["num_hidden_layers"], hv, v["intermediate_size"])
            + _ln("vision/post_ln", hv)
            + [("text/token_embedding", (t["vocab_size"], ht), "e"),
               ("text/position_embedding", (t["max_position_embeddings"], ht), "e")]
            + _clip_layers("text", t["num_hidden_layers"], ht, t["intermediate_size"])
            + _ln("text/final_ln", ht)
            + _linear("visual_projection", hv, proj, bias=False)
            + _linear("text_projection", ht, proj, bias=False)
            + [("logit_scale", (), "l")])


def make_flat(leaves: List[Leaf], seed: int, device) -> Dict[str, np.ndarray]:
    """``{path: float16 array}`` from one generator call on ``device``."""

    sizes = [int(np.prod(shape)) for _, shape, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    parts = torch.split(buf, sizes)
    scaled = []
    for (path, shape, kind), part in zip(leaves, parts):
        if kind == "w":
            part = part * (1.0 / np.sqrt(shape[0]))
        elif kind == "e":
            part = part * 0.05
        elif kind == "b":
            part = part * 0.02
        elif kind == "s":
            part = 1.0 + 0.05 * part
        else:  # CLIP's logit scale, log(1 / 0.07)
            part = torch.full_like(part, float(np.log(1 / 0.07)))
        scaled.append(part.to(torch.float16))
    host = torch.cat(scaled).cpu().numpy()
    out, at = {}, 0
    for (path, shape, _), n in zip(leaves, sizes):
        out[path] = host[at:at + n].reshape(shape)
        at += n
    return out


def nest(flat: Dict[str, np.ndarray]) -> Any:
    """The flat ``a/0/b`` mapping as nested dicts and lists."""

    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def write(flat: Dict[str, np.ndarray], directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "model.npz"), **flat)


def model_dir(weights_dir: str, model_id: str) -> str:
    return os.path.join(weights_dir, model_id.replace("/", "__"))


def make_all(models: Dict, seed: int, device, weights_dir: str) -> Dict[str, Dict]:
    """Every tower's flat weights, written under ``weights_dir``; returns
    ``{"text"|"clip"|"reranker": flat}``."""

    out = {}
    for i, (role, leaves_of) in enumerate((("text", bert_leaves), ("clip", clip_leaves),
                                           ("reranker", cross_leaves))):
        m = models[role]
        flat = make_flat(leaves_of(m), seed * 7919 + i, device)
        write(flat, model_dir(weights_dir, m["id"]))
        out[role] = flat
    return out
