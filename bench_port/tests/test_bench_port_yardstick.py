"""The operation and byte counts, the roofline and MFU readers and the idle
share, against hand counts."""

import pytest

from bench_port.harness import flops, readers
from bench_port.harness.trace import Recorder, breakdown, gaps, union_length

MINILM = {"hidden_size": 384, "num_hidden_layers": 6, "intermediate_size": 1536,
          "num_attention_heads": 12, "max_seq_length": 256}


def test_bert_step_hand_count():
    # one sequence of 10 tokens: 6 layers x (4 h^2 + 2 h f) x 2 x 10, and
    # attention 4 x 10^2 x h x 6
    step = flops.bert_step([10], MINILM)
    assert step["linear"] == 2 * 10 * 6 * (4 * 384 ** 2 + 2 * 384 * 1536)
    assert step["attention"] == 4 * 100 * 384 * 6


def test_kbmax_bound_hand_count():
    # 16 queries over 1,048,576 x 384 bf16 rows with a (16, n) bool mask:
    # 805 MB + 16.8 MB + queries + maxima at 3.35 TB/s beats 12.9 TFLOP at peak
    q, n, d = 16, 1 << 20, 384
    t = flops.kbmax_bound(q, n, d, 2, q * n, q * (n // 128) * 4)
    nbytes = n * d * 2 + q * n + q * d * 4 + q * (n // 128) * 4
    assert t == pytest.approx(nbytes / 3.35e12)
    assert 2 * q * n * d / 989e12 < t


def test_gemm_bound_hand_count():
    # 4096 x 384 by 384 x 1152 bf16 with a bf16 residual and output: the
    # 22.9 MB outweigh the 3.6 GFLOP
    t = flops.gemm_bound(4096, 384, 1152, 2, 2, True)
    nbytes = (4096 * 384 + 384 * 1152) * 2 + 1152 * 4 + 2 * 4096 * 1152 * 2
    assert t == pytest.approx(nbytes / 3.35e12)
    assert t > 2 * 4096 * 384 * 1152 / 989e12
    assert flops.gemm_bound(4096, 1536, 4096, 2, 2, False) == pytest.approx(
        2 * 4096 * 1536 * 4096 / 989e12)
    assert flops.gemm_bound(16, 384, 384, 2, 4, False) == pytest.approx(
        (16 * 384 * 2 + 384 * 384 * 2 + 384 * 4 + 16 * 384 * 4) / 3.35e12)


def _rec(events, calls=(), batches=(), window=(0.0, 1.0)):
    r = Recorder()
    r.calls.extend(calls)
    r.batches.extend(batches)

    class _T:
        pass

    t = _T()
    t.events = list(events)
    t.window = window
    t.start_mono, t.stop_mono = window
    return {"recorder": r, "trace": t, "window": window, "config": None, "reference": None}


def test_idle_share_of_a_synthetic_trace():
    events = [("k1", 0.1, 0.2), ("k2", 0.15, 0.3), ("memcpy", 0.5, 0.6), ("k3", 0.95, 1.2)]
    rec = _rec(events)
    assert union_length([(s, e) for _, s, e in events], 0.0, 1.0) == pytest.approx(0.35)
    assert readers.idle_pct(rec) == pytest.approx(65.0)
    assert gaps([(s, e) for _, s, e in events], 0.0, 1.0) == pytest.approx(
        [(0.0, 0.1), (0.3, 0.5), (0.6, 0.95)])
    rec["recorder"].observed.append(("stage.retrieve.hydrate", 0.9, 0.5))
    b = breakdown(rec["trace"], rec["recorder"])
    assert b["idle_gaps"][0] == ["stage.retrieve.hydrate", pytest.approx(0.35)]
    assert b["device_ops"][0][0] in ("k2", "k1", "memcpy", "k3")


def test_roofline_pairs_sums_of_calls_and_launches():
    info = (16, 1 << 20, 384, 2, 16 << 20, 16 * 8192 * 4)
    bound = flops.kbmax_bound(*info)
    events = [("bucket_max_tc_kernel<...>", 0.1, 0.1 + 2 * bound),
              ("bucket_max_tc_kernel<...>", 0.5, 0.5 + 2 * bound)]
    rec = _rec(events, calls=[("K-bmax", 0.09, info), ("K-bmax", 0.49, info)])
    assert readers.roofline_pct(rec, "K-bmax") == pytest.approx(50.0)
    assert readers.roofline_pct(rec, "K-gemm") is None


def test_mfu_chat_counts_real_tokens_over_busy_time():
    class _Tok:
        def ids(self, text):
            return text.split()

    cfg = {"models": {"text": MINILM, "reranker": {**MINILM, "max_length": 512},
                      "clip": {"projection_dim": 512,
                               "text_config": {"hidden_size": 512, "num_hidden_layers": 12,
                                               "intermediate_size": 2048,
                                               "max_position_embeddings": 77}}},
           "index": {"text_rows": 1000, "image_rows": 100}, "env": {}}
    ref = type("R", (), {"wp": _Tok(), "bpe": _Tok()})()
    batch = {"start": 0.2, "end": 0.4, "items": [("t", "a b c", None)],
             "payloads": [{"text": [{"text": "x y", "rerank_score": 1.0},
                                    {"text": "z", "rerank_score": None}]}]}
    rec = _rec([], batches=[batch])
    rec["config"], rec["reference"] = cfg, ref
    step = readers.chat_step_time(rec, batch)
    lin = flops.encoder_linear_flops(5, 6, 384, 1536) + flops.encoder_linear_flops(8, 6, 384,
                                                                                    1536)
    att = flops.attention_flops([5], 6, 384) + flops.attention_flops([8], 6, 384)
    clip = flops.clip_text_step([5], cfg["models"]["clip"])
    search = 2 * 1000 * 384 + 2 * 100 * 512
    assert step == pytest.approx((lin + att + clip + search) / 989e12)
    assert readers.mfu_chat(rec) == pytest.approx(100 * step / 0.2)
