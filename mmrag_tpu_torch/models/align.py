"""Word-level transcript alignment — the WhisperX-align equivalent.

Port of ``mmrag_tpu/models/align.py``. A teacher-forced decoder pass over
the already-decoded tokens (torch, on the device) captures the decoder's
cross-attention over encoder frames; :func:`alignment_matrix_device` (X6)
reduces it on the device to one (s_tokens, frames) matrix, the only tensor
read back; a host DTW over it recovers the monotonic token->frame alignment,
and tokens regroup into words through the byte-level BPE vocab. This is the
attention-DTW construction OpenAI whisper uses for ``word_timestamps=True``.

The DTW stays on the host, as in the JAX package: a sequential recurrence
over an (<= 448 tokens x 1500 frames) grid, row-vectorized in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .whisper import HOP_LENGTH, SAMPLE_RATE, WhisperConfig, whisper_decode_logits

# one encoder state covers conv-stride-2 x hop samples
FRAME_SECONDS = 2 * HOP_LENGTH / SAMPLE_RATE  # 0.02 s


def decoder_cross_attention(
    params,
    token_ids: torch.Tensor,  # (b, s) int
    enc_states: torch.Tensor,  # (b, frames, d)
    cfg: WhisperConfig,
    compute_dtype: Optional[torch.dtype] = None,
):
    """Teacher-forced decoder pass that also returns cross-attention probs.

    Returns ``(logits (b, s, vocab), cross (layers, b, heads, s, frames))``;
    the logits are :func:`mmrag_tpu_torch.models.whisper.whisper_decode_logits`'s
    own, so the capture can never drift from the production decoder.
    """

    cross: list = []
    logits = whisper_decode_logits(params, token_ids, enc_states, cfg,
                                   torch.float32 if compute_dtype is None else compute_dtype,
                                   cross_out=cross)
    return logits, torch.stack(cross)


def _median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (frames), edge-padded. Smooths the
    per-token attention before DTW, like openai-whisper's
    ``median_filter(weights, 7)``."""

    if width <= 1:
        return x
    half = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def attention_alignment_matrix(
    cross: np.ndarray,  # (layers, heads, s_tokens, frames) — one window
    layer_slice: Optional[slice] = None,
) -> np.ndarray:
    """Average selected heads into one (s_tokens, frames) alignment matrix.

    Without whisper's learned alignment-head mask, the standard heuristic
    applies: the top half of decoder layers carries the alignment signal.
    Each head's weights are z-normalized per token over frames (so confident
    heads do not drown the rest), median-filtered over frames, then averaged.
    """

    n_layers = cross.shape[0]
    sel = cross[layer_slice if layer_slice is not None
                else slice(n_layers // 2, n_layers)]
    w = sel.reshape(-1, sel.shape[-2], sel.shape[-1])  # (picked_heads, s, f)
    std = w.std(axis=-1, keepdims=True)
    w = (w - w.mean(axis=-1, keepdims=True)) / np.where(std < 1e-9, 1.0, std)
    w = _median_filter(w, 7)
    return w.mean(axis=0)


def alignment_matrix_device(cross: torch.Tensor,
                            layer_slice: Optional[slice] = None) -> torch.Tensor:
    """:func:`attention_alignment_matrix` on the device (X6): z-norm per
    token over frames (the population std, ``correction=0``, as ``jnp.std``),
    an edge-padded median over 7 frames (an odd count: ``torch.median``'s
    middle value is the true median), the mean over the top half of the
    decoder layers' heads — so only the reduced ``(s_tokens, frames)``
    matrix is read back, not the (layers, heads, s, frames) probabilities."""

    n_layers = cross.shape[0]
    sel = cross[layer_slice if layer_slice is not None
                else slice(n_layers // 2, n_layers)]
    w = sel.reshape(-1, sel.shape[-2], sel.shape[-1]).float()
    std = w.std(dim=-1, keepdim=True, correction=0)
    w = (w - w.mean(dim=-1, keepdim=True)) / torch.where(std < 1e-9, 1.0, std)
    half = 3
    xp = F.pad(w, (half, half), mode="replicate")
    w = xp.unfold(-1, 2 * half + 1, 1).median(dim=-1).values
    return w.mean(dim=0)


def dtw_monotonic(cost: np.ndarray) -> List[Tuple[int, int]]:
    """Classic 3-move DTW over ``cost (N, M)``; returns the optimal
    monotonic path [(token_row, frame_col), ...] from (0,0) to (N-1,M-1)."""

    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf, np.float64)
    acc[0, 0] = 0.0
    # one O(M) numpy pass per token row: within a row the recurrence
    #   cur[j] = row[j] + min(best_prev[j], cur[j-1])
    # unrolls to  cur[j] = P[j] + min_{k<=j} (best_prev[k] - P[k-1])
    # with P = cumsum(row), a prefix sum plus a running prefix-min; inf
    # entries (unreached cells) stay inf and never win the min.
    for i in range(1, n + 1):
        best_prev = np.minimum(acc[i - 1, :-1], acc[i - 1, 1:])
        p = np.cumsum(cost[i - 1], dtype=np.float64)
        p_prev = np.concatenate(([0.0], p[:-1]))
        acc[i, 1:] = p + np.minimum.accumulate(best_prev - p_prev)
    # backtrack, preferring the diagonal on ties
    path = []
    i, j = n, m
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        step = int(np.argmin(moves))
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return path


def token_frame_spans(matrix: np.ndarray) -> np.ndarray:
    """(s_tokens, frames) alignment matrix -> (s_tokens, 2) [start, end)
    frame spans via DTW over ``-matrix``."""

    path = dtw_monotonic(-matrix.astype(np.float64))
    n = matrix.shape[0]
    spans = np.zeros((n, 2), np.int64)
    seen = np.zeros(n, bool)
    for tok, frame in path:
        if not seen[tok]:
            spans[tok, 0] = frame
            seen[tok] = True
        spans[tok, 1] = frame + 1
    return spans


@dataclass(frozen=True)
class WordSpan:
    word: str
    start: float  # seconds, absolute (offset applied)
    end: float


def group_words(
    token_ids: Sequence[int],
    spans: np.ndarray,  # (len(token_ids), 2) frame spans
    decoder,  # ByteLevelBPEDecoder
    time_offset: float = 0.0,
) -> List[WordSpan]:
    """Merge aligned text tokens into words.

    A token starts a new word when its vocab string begins with the
    byte-level space symbol (GPT-2 mapping: 0x20 -> 'Ġ'); special tokens
    (>= the decoder's special_base) never reach here — callers pass text
    tokens only.
    """

    from .tokenizer import _bytes_to_unicode

    space_sym = _bytes_to_unicode()[0x20]
    words: List[WordSpan] = []
    group: List[int] = []
    g_start = g_end = 0
    for idx, tid in enumerate(token_ids):
        piece = decoder.id_to_token.get(int(tid), "")
        starts_word = piece.startswith(space_sym)
        if group and starts_word:
            text = decoder.decode(group).strip()
            if text:
                words.append(WordSpan(
                    text, time_offset + g_start * FRAME_SECONDS,
                    time_offset + g_end * FRAME_SECONDS))
            group = []
        if not group:
            g_start = int(spans[idx, 0])
        group.append(int(tid))
        g_end = int(spans[idx, 1])
    if group:
        text = decoder.decode(group).strip()
        if text:
            words.append(WordSpan(
                text, time_offset + g_start * FRAME_SECONDS,
                time_offset + g_end * FRAME_SECONDS))
    return words


def words_from_cross(
    cross_np: np.ndarray,  # (layers, heads, s_tokens, frames) — one window
    tokens: Sequence[int],  # the s_tokens consumed tokens, prefix included
    decoder,  # ByteLevelBPEDecoder
    cfg: WhisperConfig,
    time_offset: float = 0.0,
) -> List[WordSpan]:
    """Host half of the aligner over the raw cross-attention: averaged
    matrix -> DTW over the TEXT-token rows -> word grouping."""

    return words_from_matrix(attention_alignment_matrix(cross_np), tokens,
                             decoder, cfg, time_offset=time_offset)


def words_from_matrix(
    matrix: np.ndarray,  # (s_tokens, frames) — reduced alignment matrix
    tokens: Sequence[int],
    decoder,  # ByteLevelBPEDecoder
    cfg: WhisperConfig,
    time_offset: float = 0.0,
) -> List[WordSpan]:
    """DTW + word grouping over an already-reduced alignment matrix (the
    :func:`alignment_matrix_device` output the runtime reads back)."""

    toks = np.asarray(list(tokens), np.int64)
    if toks.size == 0:
        return []
    text_mask = toks < min(cfg.eot_id, decoder.special_base)
    if not text_mask.any():
        return []
    text_rows = np.asarray(matrix)[text_mask]
    spans = token_frame_spans(text_rows)
    return group_words(toks[text_mask].tolist(), spans, decoder,
                       time_offset=time_offset)
