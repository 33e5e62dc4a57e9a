"""The tiny fine-tuning geometries of ``tests/test_parallel.py`` (``:76-91``,
``:224-227``) for the port, and seeded batches for each tower's step, in the
step's argument order. Imports no jax, so ``tests/torch_dcn_worker.py``
runs the port alone."""

import numpy as np

from mmrag_tpu_torch.models.bert import BertConfig
from mmrag_tpu_torch.models.clip import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

TRAIN_BERT = BertConfig(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
                        intermediate_size=64, max_position=32)
TRAIN_CLIP = CLIPConfig(
    vision=CLIPVisionConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
                            num_heads=2, intermediate_size=64),
    text=CLIPTextConfig(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
                        intermediate_size=64, max_position=16),
    projection_dim=32,
)
KINDS = ("clip", "minilm", "cross")


def _padded(rng, b: int, s: int, lo: int, eot: int | None = None):
    """Token ids padded with zeros after a random length in ``[lo, s]``, and
    the mask; ``eot`` ends each row with the largest id (CLIP's EOT)."""

    lengths = rng.integers(lo, s + 1, b)
    ids = rng.integers(1, 500, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    if eot is not None:
        ids[np.arange(b), lengths - 1] = eot
    return ids * mask, mask


def train_batch(kind: str, b: int, seed: int = 0) -> tuple:
    """``kind``'s batch of ``b`` rows: clip (images, ids, mask); minilm
    (q_ids, q_mask, p_ids, p_mask); cross (ids, mask, token types, labels)."""

    rng = np.random.default_rng(seed)
    if kind == "clip":
        images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
        return (images, *_padded(rng, b, 16, 4, eot=511))
    if kind == "minilm":
        return (*_padded(rng, b, 12, 6), *_padded(rng, b, 12, 6))
    ids, mask = _padded(rng, b, 16, 10)
    tt = np.concatenate([np.zeros((b, 8), np.int32), np.ones((b, 8), np.int32)], 1) * mask
    labels = rng.integers(0, 2, b).astype(np.float32)
    return ids, mask, tt, labels
