"""Plain forwards of the three published towers, in float32.

* ``sentence-transformers/all-MiniLM-L6-v2``: BERT (post-LN, GELU, LayerNorm
  eps 1e-12), masked mean pooling, L2 normalisation.
* ``cross-encoder/ms-marco-MiniLM-L-6-v2``: the same trunk on
  ``[CLS] query [SEP] passage [SEP]`` with token types, tanh pooler on
  ``[CLS]``, one-logit classifier.
* ``openai/clip-vit-base-patch32`` text tower: pre-LN blocks with
  quick_gelu, causal and padding masks, LayerNorm eps 1e-5, the final
  LayerNorm, the hidden state at the end-of-text token (the largest id),
  the bias-free text projection, L2 normalisation.

Parameters are the benchmark's own trees (numpy, the flat layout's
nesting) moved to a device as float32. Every product runs in float32 with
TF32 off. ``bits`` (``"int4"``, ``"int8"`` or ``"fp8"``) rounds the inputs
and weights of a tower's linear layers to that format, scaled per row and
per output column (symmetric integers rounded half to even; float8 e4m3
with the absolute maximum at 448), which is how the lower-precision control
is computed; ``None`` is the reference itself.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Tree = Dict[str, Any]


def exact_float32() -> None:
    """Turn TF32 off for every float32 product of this process."""

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v, device) for v in tree]
    return torch.as_tensor(tree).to(device=device, dtype=torch.float32)


def _fake_quant(x: torch.Tensor, bits: str, dim: int) -> torch.Tensor:
    if bits == "fp8":
        scale = (x.abs().amax(dim, keepdim=True) / 448.0).clamp_min(1e-12)
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    top = float(2 ** (int(bits[3:]) - 1) - 1)
    scale = (x.abs().amax(dim, keepdim=True) / top).clamp_min(1e-12)
    return torch.round(x / scale).clamp(-top, top) * scale


def linear(p: Tree, x: torch.Tensor, bits: Optional[str] = None) -> torch.Tensor:
    w = p["kernel"]
    if bits is not None:
        x = _fake_quant(x, bits, -1)
        w = _fake_quant(w, bits, 0)
    y = x @ w
    return y + p["bias"] if "bias" in p else y


def layer_norm(p: Tree, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _attend(q, k, v, heads: int, bias: torch.Tensor) -> torch.Tensor:
    b, s, h = q.shape
    d = h // heads

    def split(t):
        return t.reshape(b, s, heads, d).transpose(1, 2)

    scores = split(q) @ split(k).transpose(-1, -2) / math.sqrt(d) + bias
    ctx = torch.softmax(scores, dim=-1) @ split(v)
    return ctx.transpose(1, 2).reshape(b, s, h)


def bert_hidden(tree: Tree, ids: torch.Tensor, mask: torch.Tensor, tt: Optional[torch.Tensor],
                heads: int = 12, bits: Optional[str] = None) -> torch.Tensor:
    emb = tree["embeddings"]
    s = ids.shape[1]
    tt = torch.zeros_like(ids) if tt is None else tt
    x = emb["word"][ids] + emb["position"][:s][None] + emb["token_type"][tt]
    x = layer_norm(emb["ln"], x, 1e-12)
    bias = (1.0 - mask.float())[:, None, None, :] * torch.finfo(torch.float32).min
    for layer in tree["layers"]:
        q, k, v = (linear(layer[n], x, bits) for n in ("q", "k", "v"))
        attn = linear(layer["attn_out"], _attend(q, k, v, heads, bias), bits)
        x = layer_norm(layer["attn_ln"], x + attn, 1e-12)
        inner = F.gelu(linear(layer["ffn_in"], x, bits))  # the erf form, as published
        x = layer_norm(layer["ffn_ln"], x + linear(layer["ffn_out"], inner, bits), 1e-12)
    return x


def minilm_embed(tree: Tree, ids, mask, heads: int = 12,
                 bits: Optional[str] = None) -> torch.Tensor:
    hidden = bert_hidden(tree, ids, mask, None, heads=heads, bits=bits)
    m = mask.float()[:, :, None]
    pooled = (hidden * m).sum(1) / m.sum(1).clamp_min(1e-9)
    return F.normalize(pooled, dim=-1, eps=1e-12)


def cross_logits(tree: Tree, ids, mask, tt, heads: int = 12,
                 bits: Optional[str] = None) -> torch.Tensor:
    hidden = bert_hidden(tree["bert"], ids, mask, tt, heads=heads, bits=bits)
    pooled = torch.tanh(linear(tree["pooler"], hidden[:, 0]))
    return linear(tree["classifier"], pooled)[:, 0]


def clip_text_embed(tree: Tree, ids, mask, heads: int = 8,
                    bits: Optional[str] = None) -> torch.Tensor:
    t = tree["text"]
    b, s = ids.shape
    x = t["token_embedding"][ids] + t["position_embedding"][:s][None]
    neg = torch.finfo(torch.float32).min
    causal = torch.triu(torch.full((s, s), neg, device=ids.device), diagonal=1)
    bias = causal[None, None] + (1.0 - mask.float())[:, None, None, :] * neg
    bias = bias.clamp_min(neg)
    for layer in t["layers"]:
        y = layer_norm(layer["ln1"], x, 1e-5)
        q, k, v = (linear(layer[n], y, bits) for n in ("q", "k", "v"))
        x = x + linear(layer["attn_out"], _attend(q, k, v, heads, bias), bits)
        y = layer_norm(layer["ln2"], x, 1e-5)
        inner = linear(layer["fc1"], y, bits)
        x = x + linear(layer["fc2"], inner * torch.sigmoid(1.702 * inner), bits)
    x = layer_norm(t["final_ln"], x, 1e-5)
    pooled = x[torch.arange(b, device=ids.device), ids.argmax(-1)]
    return F.normalize(linear(tree["text_projection"], pooled), dim=-1, eps=1e-12)
