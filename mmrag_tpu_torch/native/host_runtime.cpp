// mmrag host runtime — native C++ replacements for the hot host-side loops
// that the reference delegates to native third-party libs (SURVEY §2b):
//
//   * f32<->bf16 slab conversion (LanceDB/lance does its own columnar
//     encoding in Rust; we store bf16 slabs for HBM-ready upload)
//   * row gather / compaction (lance fragment rewrite)
//   * 64-bit phash Hamming dedup — the reference's O(n^2) Python loop over
//     frame hashes (the reference's app/ingest/frames.py:87-95), popcounted
//   * host-side top-k shard merge — the cross-shard merge LanceDB performs
//     inside its Rust ANN executor (lancedb_store.py:103-123)
//
// Exposed as a plain C ABI consumed via ctypes (mmrag_tpu_torch/native/
// __init__.py), built with g++ at first use. The numpy forms of every entry
// point (mmrag_tpu_torch/native/plain.py) are the plain versions the tests
// hold it against; the package never falls back to them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// Run fn(begin, end) over [0, n) in roughly equal chunks on all cores.
template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  int workers = std::min<int64_t>(hw_threads(), std::max<int64_t>(n / 4096, 1));
  if (workers <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    int64_t b = w * chunk, e = std::min<int64_t>(n, b + chunk);
    if (b >= e) break;
    pool.emplace_back([=] { fn(b, e); });
  }
  for (auto& t : pool) t.join();
}

inline uint16_t f32_to_bf16_rne(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  // round to nearest even, matching XLA/numpy ml_dtypes semantics
  uint32_t lsb = (x >> 16) & 1;
  uint32_t rounded = x + 0x7fffu + lsb;
  // NaN must stay NaN (rounding can carry into the exponent of an inf)
  if ((x & 0x7fffffffu) > 0x7f800000u) return static_cast<uint16_t>((x >> 16) | 0x40);
  return static_cast<uint16_t>(rounded >> 16);
}

}  // namespace

extern "C" {

// ---- dtype conversion ------------------------------------------------------

void mmrag_f32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
  parallel_for(n, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) dst[i] = f32_to_bf16_rne(src[i]);
  });
}

void mmrag_bf16_to_f32(const uint16_t* src, float* dst, int64_t n) {
  parallel_for(n, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      uint32_t x = static_cast<uint32_t>(src[i]) << 16;
      std::memcpy(&dst[i], &x, 4);
    }
  });
}

// ---- compaction: gather rows by index (lance fragment rewrite) -------------

void mmrag_gather_rows_f32(const float* src, const int64_t* rows, int64_t n_rows,
                           int64_t dim, float* dst) {
  parallel_for(n_rows, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i)
      std::memcpy(dst + i * dim, src + rows[i] * dim, sizeof(float) * dim);
  });
}

// ---- phash Hamming dedup (reference frames.py:87-95) ------------------------
// Greedy in input order: keep[i] = 1 iff hash[i] is > max_dist bits away from
// every previously kept hash. Matches the reference's sequential semantics
// exactly, so the same frames survive. O(n * kept) with popcount.

int64_t mmrag_hamming_dedup(const uint64_t* hashes, int64_t n, int32_t max_dist,
                            uint8_t* keep) {
  std::vector<uint64_t> kept;
  kept.reserve(256);
  int64_t n_keep = 0;
  for (int64_t i = 0; i < n; ++i) {
    bool dup = false;
    for (uint64_t h : kept) {
      if (__builtin_popcountll(h ^ hashes[i]) <= max_dist) {
        dup = true;
        break;
      }
    }
    keep[i] = dup ? 0 : 1;
    if (!dup) {
      kept.push_back(hashes[i]);
      ++n_keep;
    }
  }
  return n_keep;
}

// ---- pairwise Hamming matrix (for batched device-side comparisons) ---------

void mmrag_hamming_matrix(const uint64_t* a, int64_t na, const uint64_t* b,
                          int64_t nb, int32_t* out) {
  parallel_for(na, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      for (int64_t j = 0; j < nb; ++j)
        out[i * nb + j] = __builtin_popcountll(a[i] ^ b[j]);
  });
}

// ---- host-side top-k shard merge --------------------------------------------
// scores: (shards, q, k) f32, ids: (shards, q, k) i64 (global row ids).
// Writes the global per-query top-k into out_scores/out_ids (q, k), sorted
// descending. Filler entries (score <= -1e29) never beat real ones.

void mmrag_merge_topk(const float* scores, const int64_t* ids, int64_t shards,
                      int64_t q, int64_t k, float* out_scores, int64_t* out_ids) {
  parallel_for(q, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<float, int64_t>> heap;
    for (int64_t qi = lo; qi < hi; ++qi) {
      heap.clear();
      heap.reserve(shards * k);
      for (int64_t s = 0; s < shards; ++s) {
        const float* sc = scores + (s * q + qi) * k;
        const int64_t* id = ids + (s * q + qi) * k;
        for (int64_t j = 0; j < k; ++j) heap.emplace_back(sc[j], id[j]);
      }
      int64_t kk = std::min<int64_t>(k, static_cast<int64_t>(heap.size()));
      // NaN scores (a poisoned embedding upstream) must not break the
      // comparator's strict weak ordering (UB in partial_sort): order them
      // as -inf so they sink to the tail deterministically.
      auto key = [](float v) { return std::isnan(v) ? -INFINITY : v; };
      std::partial_sort(heap.begin(), heap.begin() + kk, heap.end(),
                        [&key](const auto& x, const auto& y) {
                          const float a = key(x.first), b = key(y.first);
                          return a > b || (a == b && x.second < y.second);
                        });
      for (int64_t j = 0; j < kk; ++j) {
        out_scores[qi * k + j] = heap[j].first;
        out_ids[qi * k + j] = heap[j].second;
      }
      for (int64_t j = kk; j < k; ++j) {
        out_scores[qi * k + j] = -1e30f;
        out_ids[qi * k + j] = -1;
      }
    }
  });
}

// ---- L2 normalize rows in place (zero-safe, embeddings.py:46-49) -----------

void mmrag_l2_normalize_rows(float* data, int64_t rows, int64_t dim) {
  parallel_for(rows, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      float* row = data + i * dim;
      double acc = 0.0;
      for (int64_t j = 0; j < dim; ++j) acc += double(row[j]) * row[j];
      float inv = acc > 1e-24 ? float(1.0 / std::sqrt(acc)) : 0.0f;
      if (inv != 0.0f)
        for (int64_t j = 0; j < dim; ++j) row[j] *= inv;
    }
  });
}

}  // extern "C"

// ---- WordPiece tokenizer (ASCII fast path) ----------------------------------
//
// The host-side pure-Python WordPiece measures ~1.5k 512-token chunks/s
// single-threaded — a bottleneck against the device embed rate on the ingest
// path; this kernel measures ~6.6k chunks/s (3.5M tokens/s, 4.5x). It
// replicates the exact semantics of mmrag_tpu_torch/models/tokenizer.py
// (_basic_tokenize + greedy longest-match _wordpiece) for pure-ASCII input;
// any byte >= 0x80 returns MMRAG_WP_NON_ASCII and the caller falls back to
// the Python path (unicode NFD/category work stays in Python).
//
// ASCII basic-tokenize semantics being matched:
//   * lowercase (A-Z only for ASCII)
//   * split on whitespace; inside each blob, word chars are [a-z0-9_] and
//     every other char is its own single-char token (re `(\W)` split)
//   * greedy longest-match WordPiece, "##" continuations, whole-word [UNK]
//     on failure, words > 100 chars -> [UNK]

#include <cctype>
#include <string>
#include <unordered_map>

namespace {

struct WpVocab {
  std::unordered_map<std::string, int32_t> full;  // word-initial pieces
  std::unordered_map<std::string, int32_t> cont;  // "##" continuations (stored stripped)
  size_t max_full = 0;  // longest key lengths bound the greedy scan
  size_t max_cont = 0;
};

constexpr int64_t MMRAG_WP_NON_ASCII = -1;
constexpr int64_t MMRAG_WP_OVERFLOW = -2;
constexpr int kMaxCharsPerWord = 100;

inline bool wp_word_char(char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
}

// Python's str.split() additionally treats the FS/GS/RS/US control chars
// (0x1c-0x1f) as whitespace; C isspace() does not.
inline bool wp_space(unsigned char c) {
  return std::isspace(c) || (c >= 0x1c && c <= 0x1f);
}

// Greedy longest-match over one lowercased word; appends ids or unk.
inline bool wp_piece(const WpVocab& v, const char* w, size_t len, int32_t unk,
                     int32_t* out, int64_t cap, int64_t& n) {
  if (len > kMaxCharsPerWord) {
    if (n >= cap) return false;
    out[n++] = unk;
    return true;
  }
  int64_t start_n = n;
  size_t start = 0;
  std::string key;
  while (start < len) {
    const auto& table = start == 0 ? v.full : v.cont;
    size_t longest = start == 0 ? v.max_full : v.max_cont;
    size_t end = std::min(len, start + longest);
    int32_t cur = -1;
    for (; end > start; --end) {
      key.assign(w + start, end - start);
      auto it = table.find(key);
      if (it != table.end()) {
        cur = it->second;
        break;
      }
    }
    if (cur < 0) {  // whole word becomes UNK (drop partial pieces)
      n = start_n;
      if (n >= cap) return false;
      out[n++] = unk;
      return true;
    }
    if (n >= cap) return false;
    out[n++] = cur;
    start = end;
  }
  return true;
}

}  // namespace

extern "C" {

void* mmrag_wp_create(const char* blob, int64_t blob_len) {
  auto* v = new WpVocab();
  int32_t id = 0;
  const char* p = blob;
  const char* stop = blob + blob_len;
  while (p < stop) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', stop - p));
    size_t len = (nl ? nl : stop) - p;
    if (len >= 2 && p[0] == '#' && p[1] == '#') {
      v->cont.emplace(std::string(p + 2, len - 2), id);
      v->max_cont = std::max(v->max_cont, len - 2);
    } else {
      v->full.emplace(std::string(p, len), id);
      v->max_full = std::max(v->max_full, len);
    }
    ++id;
    p = nl ? nl + 1 : stop;
  }
  return v;
}

void mmrag_wp_destroy(void* h) { delete static_cast<WpVocab*>(h); }

// Returns token count, MMRAG_WP_NON_ASCII (caller must use the Python
// path), or MMRAG_WP_OVERFLOW (out capacity too small).
int64_t mmrag_wp_tokenize(void* h, const char* text, int64_t text_len,
                          int32_t unk_id, int32_t* out, int64_t cap) {
  const auto& v = *static_cast<WpVocab*>(h);
  int64_t n = 0;
  char word[kMaxCharsPerWord + 2];
  size_t wlen = 0;
  bool word_overflow = false;
  auto flush = [&]() -> bool {
    if (word_overflow) {
      word_overflow = false;
      wlen = 0;
      if (n >= cap) return false;
      out[n++] = unk_id;  // > 100 chars -> [UNK], matching Python
      return true;
    }
    if (!wlen) return true;
    bool ok = wp_piece(v, word, wlen, unk_id, out, cap, n);
    wlen = 0;
    return ok;
  };
  for (int64_t i = 0; i < text_len; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (c >= 0x80) return MMRAG_WP_NON_ASCII;
    if (c >= 'A' && c <= 'Z') c += 32;  // ASCII lowercase
    if (wp_word_char(static_cast<char>(c))) {
      if (wlen < kMaxCharsPerWord + 1) {
        word[wlen++] = static_cast<char>(c);
      } else {
        word_overflow = true;  // keep consuming; emit one UNK at flush
      }
      continue;
    }
    if (!flush()) return MMRAG_WP_OVERFLOW;
    if (!wp_space(c)) {  // single-char punctuation token
      if (!wp_piece(v, reinterpret_cast<const char*>(&c), 1, unk_id, out, cap, n))
        return MMRAG_WP_OVERFLOW;
    }
  }
  if (!flush()) return MMRAG_WP_OVERFLOW;
  return n;
}

// Batched tokenize: texts arrive concatenated in `blob`, text i spanning
// [offsets[i], offsets[i+1]); token ids land in row i of `out` (rows are
// `stride` ids apart) and the per-text token count — or a negative kernel
// code for rows the caller must redo in Python — in `lengths`. Rows are
// independent, so the loop threads across cores (the vocab is read-only),
// and one C call replaces n_texts ctypes round-trips.
void mmrag_wp_tokenize_batch(void* h, const char* blob, const int64_t* offsets,
                             int64_t n_texts, int32_t unk_id, int32_t* out,
                             int64_t stride, int64_t* lengths) {
  auto run = [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      lengths[i] = mmrag_wp_tokenize(h, blob + offsets[i],
                                     offsets[i + 1] - offsets[i], unk_id,
                                     out + i * stride, stride);
    }
  };
  // rows are ~10-100 us each (vs parallel_for's element-count heuristic):
  // thread whenever there are a handful of rows per worker
  int workers = static_cast<int>(
      std::min<int64_t>(hw_threads(), std::max<int64_t>(n_texts / 8, 1)));
  if (workers <= 1) {
    run(0, n_texts);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n_texts + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    int64_t b = w * chunk, e = std::min<int64_t>(n_texts, b + chunk);
    if (b >= e) break;
    pool.emplace_back([=] { run(b, e); });
  }
  for (auto& t : pool) t.join();
}

int32_t mmrag_abi_version() { return 3; }

}  // extern "C"
