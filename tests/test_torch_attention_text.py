"""B5, the multi-head attention with a full additive bias (the CLIP text
tower's), against the JAX package's ``fused_encoder_attention``.

The JAX wrapper runs its Pallas kernel ``_attn_kernel`` in interpret mode on
the CPU (as ``tests/test_ops_attention.py`` runs it); the port's wrapper runs
on CPU tensors, the plain version of its K-attn launch. f32, s = 77 (CLIP
text), heads of 32. Tolerance: atol 2e-5, as for B1 (``test_torch_kernels``):
the same one-pass softmax, f32 sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrag_tpu.models import clip as jclip
from mmrag_tpu.models import convert as jconvert
from mmrag_tpu.ops.attention import fused_encoder_attention as jax_attention
from mmrag_tpu_torch.cache import clear_all_caches
from mmrag_tpu_torch.models import clip
from mmrag_tpu_torch.models.convert import params_from_jax
from mmrag_tpu_torch.ops import kernels
from mmrag_tpu_torch.ops.attention import fused_encoder_attention, fused_encoder_attention_plain

ATOL = 2e-5
S = 77


@pytest.fixture(autouse=True)
def _clear_port_caches():
    clear_all_caches()
    yield
    clear_all_caches()


def _qkv(rng, b, s, h, scale=1.0):
    return [(rng.standard_normal((b, s, h)) * scale).astype(np.float32) for _ in range(3)]


def _causal(s):
    return np.triu(np.full((s, s), -1e9, np.float32), 1)


def _pad_mask(b, s, lengths):
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)


def _both(q, k, v, nh, mask=None, bias=None):
    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    want = np.asarray(jax_attention(j(q), j(k), j(v), nh, attention_mask=j(mask), bias=j(bias)))
    got = fused_encoder_attention(t(q), t(k), t(v), nh, attention_mask=t(mask),
                                  bias=t(bias)).numpy()
    return got, want


@pytest.mark.parametrize(
    "b,h,nh,form",
    [
        (3, 64, 2, "causal+pad full"),  # the text tower's (b, s, s) bias
        (2, 64, 2, "shared causal + mask"),  # (s, s) bias and a key mask
        (2, 128, 4, "shared causal"),  # (s, s) bias alone: batch stride 0
        (17, 64, 2, "mask only"),  # b not a multiple of 16 (the JAX tile)
    ],
)
def test_text_attention_matches_jax(b, h, nh, form):
    rng = np.random.default_rng(b * h)
    q, k, v = _qkv(rng, b, S, h)
    lengths = rng.integers(1, S + 1, b)
    lengths[0] = S
    mask = _pad_mask(b, S, lengths)
    if form == "causal+pad full":
        got, want = _both(q, k, v, nh, bias=_causal(S)[None] + (1.0 - mask[:, None, :]) * -1e9)
    elif form == "shared causal + mask":
        got, want = _both(q, k, v, nh, mask=mask, bias=_causal(S))
    elif form == "shared causal":
        got, want = _both(q, k, v, nh, bias=_causal(S))
    else:
        got, want = _both(q, k, v, nh, mask=mask)
    assert got.shape == (b, S, h)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fully_masked_row_gives_zero():
    rng = np.random.default_rng(2)
    b, h, nh = 3, 64, 2
    q, k, v = _qkv(rng, b, S, h)
    mask = _pad_mask(b, S, [S, 30, 0])  # row 2: batch padding, every key masked
    got, want = _both(q, k, v, nh, mask=mask, bias=_causal(S))
    assert np.all(got[2] == 0.0)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_logits_above_the_cap():
    """Scores past 80 are capped before exp (the one-pass softmax's overflow
    guard): capped keys share the weight equally, in both packages."""

    rng = np.random.default_rng(3)
    b, h, nh = 2, 64, 2
    q, _, v = _qkv(rng, b, S, h, scale=4.0)
    k = q.copy()  # each query's own (unmasked) key scores |q|^2 / sqrt(hd), ~90
    got, want = _both(q, k, v, nh, bias=_causal(S))
    hd = h // nh
    scores = np.einsum("bqd,bkd->bqk", q[..., :hd], k[..., :hd]) * hd ** -0.5
    assert (scores + _causal(S)).max() > 80.0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL * 8)  # |v| up to ~16 here


def test_strided_views_of_a_fused_projection():
    """The text tower hands B5 the thirds of its fused (b, s, 3h) projection
    as strided views; the result is that of contiguous q, k, v."""

    rng = np.random.default_rng(4)
    b, h, nh = 2, 64, 2
    qkv = torch.from_numpy(rng.standard_normal((b, S, 3 * h)).astype(np.float32))
    views = (qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:])
    bias = torch.from_numpy(_causal(S))
    got = fused_encoder_attention(*views, nh, bias=bias)
    want = fused_encoder_attention_plain(*(t.contiguous() for t in views), nh, bias=bias)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    kernels.reset_launches()
    fused_encoder_attention(*views, nh, bias=bias)
    assert kernels.LAUNCHES["B5"] == 0  # CPU tensors launch nothing


CLIP_J = jclip.CLIPConfig(
    vision=jclip.CLIPVisionConfig(hidden_size=64, num_layers=1, num_heads=2,
                                  intermediate_size=128),
    text=jclip.CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
                              intermediate_size=128, max_position=77),
    projection_dim=32,
)
CLIP_T = clip.CLIPConfig(
    vision=clip.CLIPVisionConfig(hidden_size=64, num_layers=1, num_heads=2,
                                 intermediate_size=128),
    text=clip.CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
                             intermediate_size=128, max_position=77),
    projection_dim=32,
)


def test_text_tower_matches_the_jax_fused_branch():
    """The port's text tower runs B5 in every layer: it matches the JAX
    tower's fused branch (``attention_impl="fused"``: ``_attn_kernel`` in
    interpret mode) within 1e-4, the tower tolerance of
    ``test_torch_models.py``."""

    rng = np.random.default_rng(5)
    jp = jclip.init_clip_params(jax.random.PRNGKey(1), CLIP_J)
    tp = params_from_jax(jconvert.flatten_params(jp), "clip", CLIP_T)
    b = 3
    lengths = np.array([77, 9, 40])
    ids = rng.integers(1, 990, (b, S)).astype(np.int32)
    ids[np.arange(b), lengths - 1] = 999  # EOT: the largest id
    mask = _pad_mask(b, S, lengths)
    ids = ids * mask
    want = np.asarray(jclip.clip_text_features(jp, jnp.asarray(ids), jnp.asarray(mask), CLIP_J,
                                               attention_impl="fused"))
    got = clip.clip_text_features(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                                  CLIP_T).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
