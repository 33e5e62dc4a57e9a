"""The port's native host runtime (``mmrag_tpu_torch.native``) against the JAX
package's (``mmrag_tpu.native``) and against its own numpy plain versions
(``mmrag_tpu_torch.native.plain``): the cases of ``tests/test_native.py``.
Bits and token ids must be equal. The port has no fallback: its library is
built from its own source, and a build that fails raises."""

import numpy as np
import pytest

from mmrag_tpu import native as jnative
from mmrag_tpu_torch import native
from mmrag_tpu_torch.native import plain


def _trio(name, *args):
    """The port's native result, its plain version's and the JAX package's."""

    return getattr(native, name)(*args), getattr(plain, name)(*args), \
        getattr(jnative, name)(*args)


def test_library_is_the_ports_own_build():
    lib = native.load()
    assert lib.mmrag_abi_version() == 3
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and "libmmrag_host" not in path


def test_bf16_roundtrip_matches_ml_dtypes(rng):
    import ml_dtypes

    x = rng.standard_normal((256, 48)).astype(np.float32)
    bits, bits_plain, bits_jax = _trio("f32_to_bf16", x)
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    for got in (bits, bits_plain, bits_jax):
        np.testing.assert_array_equal(got, want)
    back = native.bf16_to_f32(bits)
    np.testing.assert_array_equal(back, plain.bf16_to_f32(bits))
    np.testing.assert_allclose(back, x, rtol=8e-3)


def test_bf16_handles_specials():
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, 3.0000002,
                  1.00390625, 65504.0, -1e30, np.finfo(np.float32).max], dtype=np.float32)
    bits, bits_plain, bits_jax = _trio("f32_to_bf16", x)
    np.testing.assert_array_equal(bits, bits_plain)
    np.testing.assert_array_equal(bits, bits_jax)
    back = native.bf16_to_f32(bits)
    assert np.isnan(back[0]) and np.isnan(back[1])
    assert np.isposinf(back[2]) and np.isneginf(back[3])


def test_gather_rows(rng):
    src = rng.standard_normal((100, 17)).astype(np.float32)
    rows = rng.integers(0, 100, 40)
    for got in _trio("gather_rows", src, rows):
        np.testing.assert_array_equal(got, src[rows])


def test_hamming_dedup_sequential_semantics():
    # h0 kept; h1 within 2 bits of h0 -> dropped; h2 within 2 bits of h1 but
    # NOT of h0 -> kept (distance is measured against *kept* hashes only)
    hashes = np.array([0, 0b11, 0b1111], np.uint64)
    for got in _trio("hamming_dedup", hashes, 2):
        np.testing.assert_array_equal(got, [True, False, True])


def test_hamming_dedup_parity_random(rng):
    h = rng.integers(0, 2 ** 30, 300, dtype=np.uint64)  # small space: collisions
    got, want, jax_got = _trio("hamming_dedup", h, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_got)
    assert native.hamming_dedup(np.zeros(0, np.uint64), 3).shape == (0,)


def test_hamming_matrix(rng):
    a = rng.integers(0, 2 ** 63, 20, dtype=np.uint64)
    b = rng.integers(0, 2 ** 63, 30, dtype=np.uint64)
    got, want, jax_got = _trio("hamming_matrix", a, b)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_got)
    assert got[0, 0] == bin(int(a[0]) ^ int(b[0])).count("1")


def test_merge_topk_matches_global_sort(rng):
    shards, q, k = 4, 3, 8
    scores = rng.standard_normal((shards, q, k)).astype(np.float32)
    scores = -np.sort(-scores, axis=-1)  # per-shard lists arrive sorted
    ids = rng.permutation(shards * q * k).reshape(shards, q, k).astype(np.int64)
    (gs, gi), (ps, pi), (js, ji) = _trio("merge_topk", scores, ids, k)
    for s, i in ((ps, pi), (js, ji)):
        np.testing.assert_array_equal(gs, s)
        np.testing.assert_array_equal(gi, i)
    flat = scores.transpose(1, 0, 2).reshape(q, -1)
    np.testing.assert_array_equal(gs, -np.sort(-flat, axis=-1)[:, :k])


def test_merge_topk_ties_go_to_the_smaller_id():
    scores = np.array([[[0.5, 0.5, 0.1]], [[0.5, 0.2, 0.1]]], np.float32)
    ids = np.array([[[9, 3, 7]], [[1, 4, 8]]], np.int64)
    (gs, gi), (ps, pi), (_, ji) = _trio("merge_topk", scores, ids, 3)
    assert gi[0].tolist() == [1, 3, 9] == pi[0].tolist() == ji[0].tolist()
    np.testing.assert_array_equal(gs, ps)


def test_merge_topk_fillers(rng):
    scores = np.full((2, 1, 3), -1e30, np.float32)
    scores[0, 0, 0] = 0.5
    ids = np.arange(6, dtype=np.int64).reshape(2, 1, 3)
    (gs, gi), (ps, pi), _ = _trio("merge_topk", scores, ids, 3)
    assert gs[0, 0] == np.float32(0.5) and gi[0, 0] == 0
    assert (gs[0, 1:] <= -1e29).all()
    np.testing.assert_array_equal(gi, pi)


def test_merge_topk_nan_scores_sink():
    """NaN scores (poisoned embeddings) order as -inf in the native
    comparator and in the plain version."""

    scores = np.asarray([[[np.nan, 0.5, 0.1]], [[0.9, np.nan, 0.2]]], np.float32)
    ids = np.asarray([[[1, 2, 3]], [[4, 5, 6]]], np.int64)
    (gs, gi), (ps, pi), (_, ji) = _trio("merge_topk", scores, ids, 3)
    assert gi[0].tolist() == [4, 2, 6] == pi[0].tolist() == ji[0].tolist()
    np.testing.assert_array_equal(gs, ps)
    # every slot taken: the NaN rows come last, in id order
    (gs, gi), (ps, pi), _ = _trio("merge_topk", scores[:, :, :2], ids[:, :, :2], 2)
    np.testing.assert_array_equal(gi, pi)


def test_merge_topk_rejects_a_width_other_than_k():
    with pytest.raises(ValueError, match="merge_topk"):
        native.merge_topk(np.zeros((2, 1, 3), np.float32), np.zeros((2, 1, 3), np.int64), 4)


def test_l2_normalize_rows(rng):
    x = rng.standard_normal((50, 9)).astype(np.float32)
    x[7] = 0.0  # a zero row stays zero
    got, want, jax_got = _trio("l2_normalize_rows", x)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got, jax_got)
    norms = np.linalg.norm(got, axis=1)
    assert abs(norms[0] - 1.0) < 1e-5 and norms[7] == 0.0


def test_gather_rows_rejects_out_of_range(rng):
    src = rng.standard_normal((10, 4)).astype(np.float32)
    with pytest.raises(IndexError):
        native.gather_rows(src, np.asarray([0, -1], np.int64))
    with pytest.raises(IndexError):
        native.gather_rows(src, np.asarray([10], np.int64))
    with pytest.raises(ValueError):
        native.gather_rows(src.reshape(-1), np.asarray([0], np.int64))


def test_a_build_failure_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    out = tmp_path / "libbroken.so"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(str(bad), str(out))
    assert not out.exists() and not list(tmp_path.glob("*.tmp"))


def test_a_build_writes_its_library_atomically(tmp_path):
    out = native.build(native.SOURCE, str(tmp_path / "lib.so"))
    assert out == str(tmp_path / "lib.so") and (tmp_path / "lib.so").exists()
    assert not list(tmp_path.glob("*.tmp"))


WP_VOCAB = {
    "[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3,
    "hello": 4, "world": 5, "un": 6, "##aff": 7, "##able": 8, ",": 9,
    "the": 10, "a": 11, "##b": 12, "##c": 13, "ab": 14, "1": 15, "##2": 16,
    "x": 17, "##x": 18, "_": 19, "-": 20, ".": 21,
}


def _wp_trio():
    """The port's tokenizer with its native kernel, the same with the
    kernel removed (its plain version), and the JAX package's."""

    from mmrag_tpu.models.tokenizer import WordPieceTokenizer as JTok
    from mmrag_tpu_torch.models.tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer(dict(WP_VOCAB))
    py = WordPieceTokenizer(dict(WP_VOCAB))
    py._native = None
    return tok, py, JTok(dict(WP_VOCAB))


def test_wordpiece_native_matches_python_random(rng):
    tok, py, jtok = _wp_trio()
    assert tok._native is not None
    pool = list("abcx12_ ,.-\t\n") + ["hello", "world", "unaffable", "the", "AB"]
    for _ in range(300):
        parts = [pool[i] for i in rng.integers(0, len(pool), rng.integers(0, 12))]
        s = "".join(parts)
        want = py.tokenize_ids(s)
        assert tok._native.tokenize(s) == want, repr(s)
        assert tok.tokenize_ids(s) == want == jtok.tokenize_ids(s), repr(s)


def test_wordpiece_native_edge_cases():
    tok, py, jtok = _wp_trio()
    cases = [
        "",
        "Hello, WORLD",
        "unaffable",
        "a" * 100,        # exactly at the per-word char cap
        "a" * 101,        # over the cap -> whole-word [UNK]
        "ab" * 80,        # a long word, the overflow accumulation path
        "a\x1cb",         # \x1c is Python str.split() whitespace
        "a\x01b",         # \x01 is a punctuation-class single token
        "x!!y",
        " \t\n ",
        "a.b,c-d_e",
    ]
    for s in cases:
        assert tok._native.tokenize(s) == py.tokenize_ids(s) == jtok.tokenize_ids(s), repr(s)


def test_wordpiece_native_declines_non_ascii():
    tok, py, jtok = _wp_trio()
    for s in ["café", "naïve hello", "東京 world", "héllo, wörld"]:
        assert tok._native.tokenize(s) is None  # the kernel declines
        assert tok.tokenize_ids(s) == py.tokenize_ids(s) == jtok.tokenize_ids(s)


def test_wordpiece_sparse_vocab_disables_native():
    from mmrag_tpu_torch.models.tokenizer import WordPieceTokenizer

    sparse = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "hello": 99}
    assert native.wordpiece_create(sparse, 1) is None
    tok = WordPieceTokenizer(sparse)
    assert tok._native is None
    assert tok.tokenize_ids("hello xyzzy") == [99, 1]


def test_wordpiece_other_configurations_stay_python():
    from mmrag_tpu_torch.models.tokenizer import WordPieceTokenizer

    assert WordPieceTokenizer(dict(WP_VOCAB), lowercase=False)._native is None
    assert WordPieceTokenizer(dict(WP_VOCAB), max_chars_per_word=50)._native is None
    assert native.wordpiece_create({"a\nb": 0, "[UNK]": 1}, 1) is None


def test_wordpiece_tokenize_matrix_matches_tokenize_ids():
    """The batched matrix path (native rows and Python rows mixed) gives
    exactly the per-text ``tokenize_ids`` streams, and the JAX package's
    matrix."""

    tok, py, jtok = _wp_trio()
    texts = [
        "hello world, the unaffable ab",
        "café naïve",          # non-ASCII: that row in Python
        "",
        "a" * 120,             # over the word cap
        "x " * 50,
    ]
    jbuf, jlengths = jtok.tokenize_matrix(texts)
    for impl in (tok, py):
        buf, lengths = impl.tokenize_matrix(texts)
        assert buf.dtype == np.int32 and lengths.shape == (len(texts),)
        np.testing.assert_array_equal(lengths, jlengths)
        for i, t in enumerate(texts):
            want = py.tokenize_ids(t)
            assert buf[i, : lengths[i]].tolist() == want, repr(t)
            assert (buf[i, lengths[i]:] == impl.pad_id).all()
            assert jbuf[i, : jlengths[i]].tolist() == want


def test_embed_text_takes_the_native_matrix_and_matches_jax(tmp_path):
    """The port's runtime with a WordPiece vocab (the native kernel) gives
    the JAX runtime's embeddings, unicode and truncated rows included."""

    from mmrag_tpu.models import runtime as jrt
    from mmrag_tpu.models.tokenizer import WordPieceTokenizer as JTok
    from mmrag_tpu.settings import load_settings as jload
    from mmrag_tpu_torch.models import runtime as trt
    from mmrag_tpu_torch.models.tokenizer import WordPieceTokenizer
    from mmrag_tpu_torch.settings import load_settings as tload

    from tiny import TINY_BERT as JBERT
    from tiny_torch import TINY_BERT, write_tiny_weights

    env = {"WEIGHTS_DIR": write_tiny_weights(tmp_path / "w"), "TPU_COMPUTE_DTYPE": "float32",
           "TPU_TEXT_BATCH_BUCKETS": "4,16", "TPU_TEXT_SEQ_BUCKETS": "32,128",
           "TPU_DATA_PARALLEL": "off"}
    jenc = jrt.EncoderRuntime(jload(env), bert_cfg=JBERT)
    tenc = trt.EncoderRuntime(tload(env), bert_cfg=TINY_BERT, device="cpu")
    jenc._ensure_minilm()
    tenc._ensure_minilm()
    jenc._bert_tok = JTok(dict(WP_VOCAB))
    tenc._bert_tok = WordPieceTokenizer(dict(WP_VOCAB))
    assert tenc._bert_tok._native is not None
    texts = ["hello world", "café the unaffable", "ab " * 400, ""]
    np.testing.assert_allclose(tenc.embed_text_batch(texts), jenc.embed_text_batch(texts),
                               atol=1e-4)
