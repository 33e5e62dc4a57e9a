// K-bmax: per 128-row bucket of the corpus, the max over its rows of q . c
// for every query, with rows the mask kills and rows past n at -1e30:
// out (qp, ceil(n / 128)) f32.
//
// Replaces phase A of mmrag_tpu/ops/pallas_topk.py::_bucket_max_kernel (B4).
// Phases B and C (top k+4 buckets, gather, exact rescore) stay plain torch
// ops in mmrag_tpu_torch/ops/pallas_topk.py, as they stay plain jnp there.
// The TPU kernel walked 2048-row tiles in order on one core, required the
// corpus padded to a tile multiple and took the mask as an f32 bias; here
// blocks walk buckets in any order, rows past n score -1e30 inside the
// kernel (the slab is never copied for padding), and the kernel reads the
// bool mask itself (1 byte an entry: (n,) shared or (qp, n) per query), so
// no (qp, n) f32 bias is ever built. -1e30 where the mask is 0 is the JAX
// sum s + (-1e30) in f32 for any |s| <= 1e22.
//
// Bound on an H100: bytes. The corpus is read once: 1,048,576 x 384 bf16 is
// 805 MB, 0.240 ms at 3.35 TB/s, plus the mask (1 B a row, or a row and a
// query). A bf16 element (2 B) meets qp queries: qp flops a byte, 32 at most
// (qp 32) -- far below the tensor cores' ridge (989 TFLOP/s over 3.35 TB/s,
// about 295 flop/B), but above the CUDA cores' (about 20 at 67 TFLOP/s f32).
//
// bf16 design. The product runs on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate): A is 16 corpus rows x 16 columns, loaded from shared
// memory with ldmatrix (row-major, k contiguous); B is 16 columns x 8
// queries, the .col operand, loaded with ldmatrix from the query rows; qp
// 8/16/24/32 is 1-4 n-tiles. Persistent blocks (one a SM, 8 warps) walk the
// buckets with a stride of the grid; each bucket streams through a ring of 8
// stages of 128 rows x 64 columns (16 KB) filled by 16-byte cp.async.cg
// copies (a row chunk XOR-swizzled by row so ldmatrix reads are free of bank
// conflicts; a ragged row or column tail is zero-filled by a source size of
// 0), so up to 7 stages (112 KB) are in flight while one is multiplied and
// the next bucket's loads overlap this one's max. The queries are staged
// once per block. Each warp owns 16 rows of the bucket; its maxima are taken
// in registers from the m16n8 accumulator layout (mask, then a shuffle over
// the rows), then across the 8 warps in shared memory, one float a (query,
// bucket) written. d must be a multiple of 8 (16-byte rows); the wrapper
// checks. The f32 form (TPU_COMPUTE_DTYPE=float32) keeps the first design:
// one block a bucket, 32-column slices staged by scalar loads, f32 FMAs.
//
// -Xptxas -v (CUDA 12.8, sm_90a): the bf16 instances 56-80 registers (1-4
// n-tiles), the f32 ones 42-64 and 18-21 KB of static shared memory; no
// spills. chip_smoke.py's build phase prints the report.
//
// The top-k form (mm_bucket_topk, K-bmax-top, X1: TPU_TOPK_BACKEND=approx)
// and its merge (mm_topk_merge, K-bmax-topk-merge) replace
// mmrag_tpu/ops/topk.py::_cosine_topk_approx (jax.lax.approx_max_k, the
// TPU's PartialReduce: keep each bin's best, then a top-k of those). The
// answer is the top-k, by (score descending, row ascending), of the union of
// each bucket's kTop best rows (48: a query loses only the true top-k rows
// past the 48th of one bucket, so its recall is at least min(1, 48 / k),
// 0.96 at k 50, whatever the layout; tools/approx_recall.py). That key is a
// total order, so the answer does not depend on how buckets are split among
// blocks, and the union is never written out:
//
// * K-bmax-top is a separate instance of each kernel (TOP = true; the exact
//   instances keep their code). Its persistent blocks walk their buckets in
//   ascending order, and each keeps, for every query, a list in shared
//   memory of its best ell = min(k, kCap) candidates so far, sorted by the
//   key, with the ell-th score tau. A later bucket's rows are higher, so a
//   row of the bucket can enter the list only with a score above tau: the
//   bucket's staged scores are tested against tau by one ballot per 32 x 4
//   scores. Where 1-48 rows pass, they are compacted in row order and placed
//   by rank (list_merge); where more pass (a block's first two buckets, or
//   scores that rise with the row), one warp bitonic sort of the bucket's
//   128 (score, row) pairs (warp_top) gives its kTop best first. A block's
//   list is the top k of its own share of the corpus, so with random rows a
//   block's t-th bucket still brings about k / t new rows a query: most
//   buckets pass a few. So the bf16 form is warp-specialised: its 8 product
//   warps stage each bucket's scores in one of two buffers and go on, and 8
//   list warps merge them (named barriers "full" and "empty" a buffer): a
//   merge costs the product warps nothing unless the list warps fall a
//   bucket behind (qp above 16, or blocks of few buckets). The f32 form
//   merges in its own warps between buckets. Each block writes its lists,
//   (qp, G, out_len) pairs: 0.84 MB at q16, G 132, k 50.
// * K-bmax-topk-merge: one block a query takes the G lists through
//   pairwise merge levels (a row's place is its place in its list plus the
//   rows of the partner list before it, found by binary search) in shared
//   memory, or in a global scratch where they do not fit, and writes the
//   (qp, k) answer.
//
// For k > kCap a block's union must fit its list, so the grid is then
// ceil(nb / (kCap / kTop)) blocks of at most kCap / kTop buckets (one at
// kCap 64): the per-bucket lists, then the merge in its global scratch.
// Bound: the same corpus read plus the (qp, G, out_len) pairs written (8 B
// each) for K-bmax-top; the lists read and the answer written for the
// merge. -Xptxas -v (CUDA 12.8, sm_90a): the bf16 top-k instances 92-127
// registers (1-4 n-tiles; 512 threads allow 128), the f32 ones 80-120 and
// 22-38 KB of static shared memory, the merge 32; no stack frame, no spills.
#include "common.cuh"

using mm::bf16;
using mm::cp_async16;
using mm::cp_async_commit;
using mm::cp_async_wait;
using mm::ldmatrix_x4;
using mm::mma_bf16;
using mm::sm_count;

namespace {

constexpr int BUCKET = 128;
constexpr float kNeg = -1e30f;
constexpr int kTop = 48;       // rows a bucket gives the top-k form's union (a multiple of 4)
constexpr int kCap = 64;       // list entries a (block, query) keeps (a multiple of 32)
constexpr int SC_PITCH = 132;  // floats a query row of a bucket's staged scores
// a list's empty place: below every score (masked rows are -1e30) and row
constexpr float kSentinel = -__builtin_huge_valf();
constexpr int kSentinelRow = 0x7fffffff;

// The top kTop of one query's 128 masked scores ``s`` (shared memory,
// 16-byte aligned), by one warp: a bitonic sort of the 128 (score, row)
// pairs, 4 consecutive a lane (strides 1 and 2 in registers, 4-64 by
// shuffles), into descending score and, on equal scores, ascending row (the
// keys are distinct, so the order is the plain version's stable sort). Lanes
// 0..kTop/4-1 write their 4 scores to vals[0..kTop) and the global rows
// (row0 + r) to rows, 16 bytes each.
__device__ __forceinline__ bool precedes(float av, int ar, float bv, int br) {
  return av > bv || (av == bv && ar < br);
}

__device__ __forceinline__ void warp_top(const float* s, int lane, float* __restrict__ vals,
                                         int* __restrict__ rows, int row0) {
  const float4 f = reinterpret_cast<const float4*>(s)[lane];
  float v[4] = {f.x, f.y, f.z, f.w};
  int r[4] = {4 * lane, 4 * lane + 1, 4 * lane + 2, 4 * lane + 3};
#pragma unroll
  for (int size = 2; size <= BUCKET; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * lane + i;
        const bool up = (e & size) == 0;  // this run sorts best first
        if (stride >= 4) {
          // keep the preceding pair member at the lower place of an up run
          const float ov = __shfl_xor_sync(0xffffffffu, v[i], stride >> 2);
          const int orow = __shfl_xor_sync(0xffffffffu, r[i], stride >> 2);
          if (precedes(ov, orow, v[i], r[i]) == (((e & stride) == 0) == up)) {
            v[i] = ov;
            r[i] = orow;
          }
        } else if ((i ^ stride) > i) {  // constant indices: v and r stay in registers
          const int j = i ^ stride;
          if (precedes(v[j], r[j], v[i], r[i]) == up) {
            const float tv = v[i];
            const int tr = r[i];
            v[i] = v[j];
            r[i] = r[j];
            v[j] = tv;
            r[j] = tr;
          }
        }
      }
    }
  }
  if (lane < kTop / 4) {
    reinterpret_cast<float4*>(vals)[lane] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(rows)[lane] =
        make_int4(row0 + r[0], row0 + r[1], row0 + r[2], row0 + r[3]);
  }
}

// One query's bucket into its list, by one warp: ``s`` the bucket's 128
// masked scores (shared, 16-byte aligned), rows row0..row0+127; ``lv`` /
// ``lr`` the list (shared, ell entries sorted by the key, every row below
// row0); ``cv`` / ``cr`` the warp's kTop candidate places (16-byte aligned).
// A row of equal score to a listed one loses to it (it is the higher row),
// so only scores above tau = lv[ell - 1] can enter. The places come from
// one pass over the candidates, each broadcast to the warp: a candidate
// follows the candidates that precede it and the listed rows of its score
// or more (a ballot over the list, which the lanes hold two places each); a
// listed row follows the candidates of a higher score.
__device__ __forceinline__ void list_merge(const float* s, int lane, float* lv, int* lr,
                                           float* cv, int* cr, int ell, int row0) {
  const float tau = lv[ell - 1];
  const float4 f = reinterpret_cast<const float4*>(s)[lane];
  const float v[4] = {f.x, f.y, f.z, f.w};
  unsigned pass[4];
  int m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pass[i] = __ballot_sync(0xffffffffu, v[i] > tau);
    m += __popc(pass[i]);
  }
  if (m == 0) return;  // the whole warp: m is uniform
  constexpr int LP = kCap / 32;  // list places a lane holds
  float ev[LP];
  int er[LP], above[LP];
#pragma unroll
  for (int t = 0; t < LP; ++t) {  // read before the syncwarp, so before any place is written
    const int p = lane + 32 * t;
    ev[t] = p < ell ? lv[p] : kSentinel;
    er[t] = p < ell ? lr[p] : kSentinelRow;
    above[t] = 0;
  }
  if (m > kTop) {  // the bucket's kTop best, sorted: all of them pass
    warp_top(s, lane, cv, cr, row0);
    m = kTop;
  } else {  // the passing rows in row order (row 4 * lane + i)
    int slot = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) slot += __popc(pass[i] & ((1u << lane) - 1u));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (v[i] > tau) {
        cv[slot] = v[i];
        cr[slot] = row0 + 4 * lane + i;
        ++slot;
      }
  }
  __syncwarp();
  float xv[2] = {kSentinel, kSentinel};
  int xr[2] = {kSentinelRow, kSentinelRow}, xp[2] = {0, 0};  // this lane's candidates
#pragma unroll
  for (int t = 0; t < 2; ++t)
    if (lane + 32 * t < m) {
      xv[t] = cv[lane + 32 * t];
      xr[t] = cr[lane + 32 * t];
    }
  for (int u = 0; u < m; ++u) {
    const float cu = cv[u];
    const int ru = cr[u];
    int listed = 0;  // listed rows of score >= cu (sentinels never)
#pragma unroll
    for (int t = 0; t < LP; ++t) {
      listed += __popc(__ballot_sync(0xffffffffu, ev[t] >= cu));
      above[t] += cu > ev[t];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) xp[t] += precedes(cu, ru, xv[t], xr[t]);
    if (lane == (u & 31)) {
      if (u < 32) xp[0] += listed;
      else xp[1] += listed;
    }
  }
#pragma unroll
  for (int t = 0; t < LP; ++t) {
    const int p = lane + 32 * t, at = p + above[t];
    if (p < ell && at < ell) {
      lv[at] = ev[t];
      lr[at] = er[t];
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
    if (lane + 32 * t < m && xp[t] < ell) {
      lv[xp[t]] = xv[t];
      lr[xp[t]] = xr[t];
    }
  __syncwarp();
}

// A block's lists, ``entries`` places of scores and rows: every place empty.
__device__ __forceinline__ void lists_init(float* lv, int* lr, int entries, int tid, int threads) {
  for (int e = tid; e < entries; e += threads) {
    lv[e] = kSentinel;
    lr[e] = kSentinelRow;
  }
}

// A block's lists out: (qp, gridDim.x, out_len) pairs, by the owning warps.
__device__ __forceinline__ void lists_out(const float* lv, const int* lr, float* out, int* rows,
                                          int qp, int out_len, int warp, int warps, int lane) {
  for (int j = warp; j < qp; j += warps)
    for (int p = lane; p < out_len; p += 32) {
      const size_t o = (static_cast<size_t>(j) * gridDim.x + blockIdx.x) * out_len + p;
      out[o] = lv[j * kCap + p];
      rows[o] = lr[j * kCap + p];
    }
}

__device__ __forceinline__ void ldmatrix_x2(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(mm::smem_u32(p)));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, a cp.async ring, persistent blocks
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;  // 8 warps x 16 rows: one bucket
constexpr int TC_COLS = 64;      // columns a stage: 128 B of every row
constexpr int TC_STAGES = 8;
constexpr int TOP_STAGES = 6;  // the top-k form's ring: room for its lists at d 1024, qp 32
constexpr int MERGE_WARPS = 8;  // the top-k form's list warps, beside the TC_WARPS product warps
constexpr int TOP_THREADS = TC_THREADS + 32 * MERGE_WARPS;
// named barriers of the top-k form: the product warps' item barrier, and
// for each of the two staged-score buffers "full" (product -> list warps)
// and "empty" (list -> product warps)
constexpr int BAR_ITEM = 1, BAR_FULL = 2, BAR_EMPTY = 4;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
constexpr int TC_STAGE_ELEMS = BUCKET * TC_COLS;  // 16 KB of bf16
constexpr int TC_WARPS = TC_THREADS / 32;

__host__ __device__ constexpr int tc_qpitch(int d) {  // bf16 elements a staged query row
  return ((d + TC_COLS - 1) / TC_COLS) * TC_COLS + 8;  // +16 B: 8 rows, 8 bank groups
}
// the ring, the staged queries, then the cross-warp maxima [2][TC_WARPS][QR]
// (exact form) or the bucket's staged scores [2][QR][SC_PITCH], the lists
// [QR][kCap] (scores, rows) and the list warps' candidates
// [MERGE_WARPS][kTop] (scores, rows) (top-k form)
__host__ __device__ constexpr size_t tc_smem(int nt, int d, bool top) {
  return static_cast<size_t>(top ? TOP_STAGES : TC_STAGES) * TC_STAGE_ELEMS * 2 +
         static_cast<size_t>(8 * nt) * tc_qpitch(d) * 2 +
         (top ? 2 * 8 * nt * SC_PITCH * 4 + 8 * nt * kCap * 8 + MERGE_WARPS * kTop * 8
              : 2 * TC_WARPS * 8 * nt * 4);
}

// TOP = false: the maxima, out (qp, nb). TOP = true: each block's lists of
// ell entries a query, out and rows (qp, gridDim.x, out_len). The top-k
// form is warp-specialised: the TC_WARPS product warps stage each bucket's
// masked scores in one of two buffers and go on to the next bucket, while
// MERGE_WARPS list warps merge the buffer into their queries' lists (query
// j: list warp j % MERGE_WARPS), so no product warp waits for a merge.
template <int NT, bool TOP>  // n-tiles of 8 queries
__global__ void __launch_bounds__(TOP ? TOP_THREADS : TC_THREADS, 1)
    bucket_max_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ corpus,
                         const uint8_t* __restrict__ mask, float* __restrict__ out,
                         int* __restrict__ rows, int qp, int n, int d, int mask_rows, int ell,
                         int out_len) {
  constexpr int QR = 8 * NT;  // staged query rows (rows >= qp are zero)
  constexpr int STAGES = TOP ? TOP_STAGES : TC_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nchunk = (d + TC_COLS - 1) / TC_COLS;
  const int qpitch = tc_qpitch(d);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* qs = ring + STAGES * TC_STAGE_ELEMS;
  float* red = reinterpret_cast<float*>(qs + QR * qpitch);  // [2][TC_WARPS][QR] or scores

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = (n + BUCKET - 1) / BUCKET;
  const int my_buckets = (nb - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int total = my_buckets * nchunk;  // (bucket, column chunk) items of this block

  if constexpr (TOP) {
    if (warp >= TC_WARPS) {  // a list warp: the lists and its candidate places, after the scores
      const int mw = warp - TC_WARPS;
      float* lv = red + 2 * QR * SC_PITCH;
      int* lr = reinterpret_cast<int*>(lv + QR * kCap);
      float* cv = reinterpret_cast<float*>(lr + QR * kCap) + mw * kTop;
      int* cr = reinterpret_cast<int*>(lr + QR * kCap + MERGE_WARPS * kTop) + mw * kTop;
      for (int j = mw; j < qp; j += MERGE_WARPS)  // its own queries' lists
        lists_init(lv + j * kCap, lr + j * kCap, kCap, lane, 32);
      __syncwarp();
      for (int i = 0; i < my_buckets; ++i) {
        const int par = i & 1;
        bar_sync(BAR_FULL + par, TOP_THREADS);  // bucket i's scores are staged
        const float* sp = red + par * QR * SC_PITCH;
        const int row0 = (blockIdx.x + i * gridDim.x) * BUCKET;
        for (int j = mw; j < qp; j += MERGE_WARPS)
          list_merge(sp + j * SC_PITCH, lane, lv + j * kCap, lr + j * kCap, cv, cr, ell, row0);
        if (i + 2 < my_buckets) bar_arrive(BAR_EMPTY + par, TOP_THREADS);  // free for i + 2
      }
      lists_out(lv, lr, out, rows, qp, out_len, mw, MERGE_WARPS, lane);
      return;
    }
  }

  // the queries, once: rows past qp and columns past d are zero
  const int qchunks = (qpitch - 8) / 8;
  for (int e = tid; e < QR * qchunks; e += TC_THREADS) {
    const int j = e / qchunks, c = (e % qchunks) * 8;
    const bool p = j < qp && c < d;
    cp_async16(qs + j * qpitch + c, p ? q + static_cast<size_t>(j) * d + c : q, p);
  }
  cp_async_commit();

  auto fetch = [&](int item) {
    if (item < total) {
      const size_t row0 =
          static_cast<size_t>(blockIdx.x + (item / nchunk) * gridDim.x) * BUCKET;
      const int c0 = (item % nchunk) * TC_COLS;
      bf16* st = ring + (item % STAGES) * TC_STAGE_ELEMS;
#pragma unroll
      for (int i = 0; i < (BUCKET * TC_COLS / 8) / TC_THREADS; ++i) {
        const int e = tid + i * TC_THREADS;  // 16-byte chunk: row e / 8, chunk e % 8
        const int r = e >> 3, ch = e & 7;
        const size_t row = row0 + r;
        const int col = c0 + ch * 8;
        const bool p = row < static_cast<size_t>(n) && col < d;
        cp_async16(st + r * TC_COLS + ((ch ^ (r & 7)) << 3), p ? corpus + row * d + col : corpus,
                   p);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  uint8_t keep[NT][4];  // mask bytes of this thread's (row, query) pairs, read early

  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix row addresses: A matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_khalf = lane >> 4;
  // B matrices: (n-tile 2p | 2p+1) x (k 0-7 | 8-15), rows are queries
  const int b_row = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_khalf = (lane >> 3) & 1;

  int pending = -1, pend_par = 0, done = 0;  // bucket whose cross-warp max waits in red
  // a finished bucket's max across the warps (the exact form)
  auto flush = [&](int bucket, int par) {
    if (tid < qp) {
      const float* rp = red + par * TC_WARPS * QR;
      float v = rp[tid];
#pragma unroll
      for (int w = 1; w < TC_WARPS; ++w) v = fmaxf(v, rp[w * QR + tid]);
      out[static_cast<size_t>(tid) * nb + bucket] = v;
    }
  };
  for (int item = 0; item < total; ++item) {
    cp_async_wait<STAGES - 2>();
    if constexpr (TOP) bar_sync(BAR_ITEM, TC_THREADS);  // the product warps only
    else __syncthreads();
    if (pending >= 0) {
      flush(pending, pend_par);
      pending = -1;
    }
    fetch(item + STAGES - 1);

    const int bucket = blockIdx.x + (item / nchunk) * gridDim.x;
    const int chunk = item % nchunk;
    const int row_g = bucket * BUCKET + warp * 16 + g;  // this thread's rows: row_g, row_g + 8
    if (chunk == 0) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row_g + (i >> 1) * 8;
          const int j = t * 8 + tq * 2 + (i & 1);
          const bool in = row < n && (mask_rows == 1 || j < qp);
          const size_t mrow = mask_rows == 1 ? 0 : static_cast<size_t>(j);
          keep[t][i] = in ? mask[mrow * n + row] : 0;
        }
    }

    const bf16* st = ring + (item % STAGES) * TC_STAGE_ELEMS;
    const bf16* qc = qs + chunk * TC_COLS;
#pragma unroll
    for (int kk = 0; kk < TC_COLS / 16; ++kk) {
      unsigned a[4];
      const int ach = kk * 2 + a_khalf;
      ldmatrix_x4(a, st + a_row * TC_COLS + ((ach ^ (a_row & 7)) << 3));
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        unsigned b[4];
        ldmatrix_x4(b, qc + (16 * p + b_row) * qpitch + kk * 16 + b_khalf * 8);
        mma_bf16(acc[2 * p], a, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
      if (NT & 1) {  // the lone last n-tile: lanes 0-15 give its two matrices
        unsigned b0, b1;
        ldmatrix_x2(b0, b1, qc + (8 * (NT - 1) + (lane & 7)) * qpitch + kk * 16 + b_khalf * 8);
        mma_bf16(acc[NT - 1], a, b0, b1);
      }
    }

    if (chunk == nchunk - 1) {  // the bucket is done: mask, max over rows, reset
      const int par = done & 1;
      if constexpr (TOP) {
        if (done >= 2) bar_sync(BAR_EMPTY + par, TOP_THREADS);  // bucket done - 2 is merged
      }
      float* rp = red + par * TC_WARPS * QR + warp * QR;
      float* sp = red + par * QR * SC_PITCH + warp * 16 + g;  // top-k: this thread's row
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v0 = keep[t][c] ? acc[t][c] : kNeg;          // row g
          const float v1 = keep[t][2 + c] ? acc[t][2 + c] : kNeg;  // row g + 8
          if constexpr (TOP) {
            float* col = sp + (t * 8 + tq * 2 + c) * SC_PITCH;
            col[0] = v0;
            col[8] = v1;
          } else {
            float v = fmaxf(v0, v1);
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
            if (g == 0) rp[t * 8 + tq * 2 + c] = v;
          }
          acc[t][c] = 0.f;
          acc[t][2 + c] = 0.f;
        }
      }
      if constexpr (TOP) {
        bar_arrive(BAR_FULL + par, TOP_THREADS);  // to the list warps
      } else {
        pending = bucket;
        pend_par = par;
      }
      ++done;
    }
  }
  cp_async_wait<0>();
  if constexpr (!TOP) {
    __syncthreads();
    if (pending >= 0) flush(pending, pend_par);
  }
}

template <int NT, bool TOP>
int launch_tc(const void* q, const void* corpus, const void* mask, void* out, void* rows, int qp,
              int n, int d, int mask_rows, int grid, int ell, int out_len, cudaStream_t stream) {
  const size_t smem = tc_smem(NT, d, TOP);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_max_tc_kernel<NT, TOP>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  bucket_max_tc_kernel<NT, TOP><<<grid, TOP ? TOP_THREADS : TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(corpus),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<int*>(rows), qp,
      n, d, mask_rows, ell, out_len);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the first design, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NTH = 256;  // 2 threads a row: each takes every other query
constexpr int DC = 32;    // columns staged per step

// The f32 dot products of one bucket: acc[t] = q[g + 2t] . corpus[row0 + r]
// for this thread's row r = tid % 128 and query parity g = tid / 128 (rows
// past n and queries past qp read zeros).
template <int QPT>
__device__ __forceinline__ void f32_bucket_dot(const float* __restrict__ q,
                                               const float* __restrict__ corpus,
                                               float (&cs)[BUCKET][DC + 1],
                                               float (&qs)[2 * QPT][DC], float (&acc)[QPT],
                                               size_t row0, int qp, int n, int d) {
  constexpr int QMAX = 2 * QPT;
  const int tid = threadIdx.x;
  const int r = tid % BUCKET;
  const int g = tid / BUCKET;
#pragma unroll
  for (int t = 0; t < QPT; ++t) acc[t] = 0.f;

  for (int c0 = 0; c0 < d; c0 += DC) {
    __syncthreads();
    // corpus slice: each warp reads one row's 32 contiguous columns
    for (int e = tid; e < BUCKET * DC; e += NTH) {
      const int rr = e / DC, cc = e % DC;
      const size_t gr = row0 + rr;
      cs[rr][cc] = (gr < static_cast<size_t>(n) && c0 + cc < d) ? corpus[gr * d + c0 + cc] : 0.f;
    }
    for (int e = tid; e < QMAX * DC; e += NTH) {
      const int j = e / DC, cc = e % DC;
      qs[j][cc] = (j < qp && c0 + cc < d) ? q[static_cast<size_t>(j) * d + c0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DC; k += 4) {
      const float c0v = cs[r][k], c1v = cs[r][k + 1], c2v = cs[r][k + 2], c3v = cs[r][k + 3];
#pragma unroll
      for (int t = 0; t < QPT; ++t) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[g + 2 * t][k]);
        float a = acc[t];
        a = fmaf(c0v, qv.x, a);
        a = fmaf(c1v, qv.y, a);
        a = fmaf(c2v, qv.z, a);
        a = fmaf(c3v, qv.w, a);
        acc[t] = a;
      }
    }
  }
}

// this thread's masked score of query j: -1e30 where the mask is 0 or the
// row is past n
__device__ __forceinline__ float f32_masked(const uint8_t* __restrict__ mask, float a, int j,
                                            int grow, int qp, int n, int mask_rows) {
  if (grow >= n || j >= qp) return kNeg;
  const size_t mrow = mask_rows == 1 ? 0 : static_cast<size_t>(j);
  return mask[mrow * n + grow] ? a : kNeg;
}

// the exact form: one block a bucket, out (qp, nb)
template <int QPT>
__global__ void __launch_bounds__(NTH)
    bucket_max_f32_kernel(const float* __restrict__ q, const float* __restrict__ corpus,
                          const uint8_t* __restrict__ mask, float* __restrict__ out, int qp,
                          int n, int d, int mask_rows) {
  __shared__ float cs[BUCKET][DC + 1];
  __shared__ __align__(16) float qs[2 * QPT][DC];
  __shared__ float red[2][4][QPT];

  const int tid = threadIdx.x;
  const int r = tid % BUCKET;  // row within the bucket
  const int g = tid / BUCKET;  // query parity
  const int bucket = blockIdx.x;
  const size_t row0 = static_cast<size_t>(bucket) * BUCKET;
  const int grow = static_cast<int>(row0) + r;

  float acc[QPT];
  f32_bucket_dot<QPT>(q, corpus, cs, qs, acc, row0, qp, n, d);

  const int warp_in_group = (tid % BUCKET) >> 5;
  const int nb = (n + BUCKET - 1) / BUCKET;
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    float v = f32_masked(mask, acc[t], g + 2 * t, grow, qp, n, mask_rows);
    v = mm::warp_max(v);
    if ((tid & 31) == 0) red[g][warp_in_group][t] = v;
  }
  __syncthreads();
  if (tid < 2 * QPT) {
    const int gg = tid / QPT, t = tid % QPT;
    const int j = gg + 2 * t;
    if (j < qp) {
      float v = fmaxf(fmaxf(red[gg][0][t], red[gg][1][t]), fmaxf(red[gg][2][t], red[gg][3][t]));
      out[static_cast<size_t>(j) * nb + bucket] = v;
    }
  }
}

// the top-k form: persistent blocks walk buckets blockIdx.x, + gridDim.x, ...
// in ascending order; each bucket's masked scores staged [QMAX][SC_PITCH],
// then merged into the lists (dynamic shared memory: [QMAX][kCap] scores and
// rows, then the warps' [8][kTop] candidates) by the queries' warps
template <int QPT>
__global__ void __launch_bounds__(NTH)
    bucket_topk_f32_kernel(const float* __restrict__ q, const float* __restrict__ corpus,
                           const uint8_t* __restrict__ mask, float* __restrict__ out,
                           int* __restrict__ rows, int qp, int n, int d, int mask_rows, int ell,
                           int out_len) {
  constexpr int QMAX = 2 * QPT;
  __shared__ float cs[BUCKET][DC + 1];
  __shared__ __align__(16) float qs[QMAX][DC];
  __shared__ __align__(16) float sc[QMAX][SC_PITCH];
  extern __shared__ __align__(16) unsigned char dyn[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* lv = reinterpret_cast<float*>(dyn);
  int* lr = reinterpret_cast<int*>(lv + QMAX * kCap);
  float* cv = reinterpret_cast<float*>(lr + QMAX * kCap) + warp * kTop;
  int* cr = reinterpret_cast<int*>(lr + QMAX * kCap + (NTH / 32) * kTop) + warp * kTop;
  lists_init(lv, lr, QMAX * kCap, tid, NTH);

  const int r = tid % BUCKET, g = tid / BUCKET;
  const int nb = (n + BUCKET - 1) / BUCKET;
  for (int bucket = blockIdx.x; bucket < nb; bucket += gridDim.x) {
    const size_t row0 = static_cast<size_t>(bucket) * BUCKET;
    float acc[QPT];
    f32_bucket_dot<QPT>(q, corpus, cs, qs, acc, row0, qp, n, d);  // opens with a barrier
#pragma unroll
    for (int t = 0; t < QPT; ++t)
      sc[g + 2 * t][r] = f32_masked(mask, acc[t], g + 2 * t, static_cast<int>(row0) + r, qp, n,
                                    mask_rows);
    __syncthreads();
    for (int j = warp; j < qp; j += NTH / 32)
      list_merge(sc[j], lane, lv + j * kCap, lr + j * kCap, cv, cr, ell, bucket * BUCKET);
  }
  lists_out(lv, lr, out, rows, qp, out_len, warp, NTH / 32, lane);
}

template <int QPT>
int launch_topk_f32(const float* q, const float* corpus, const uint8_t* mask, float* out,
                    int* rows, int qp, int n, int d, int mask_rows, int grid, int ell,
                    int out_len, cudaStream_t stream) {
  const int dyn = 2 * QPT * kCap * 8 + (NTH / 32) * kTop * 8;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_topk_f32_kernel<QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  bucket_topk_f32_kernel<QPT><<<grid, NTH, dyn, stream>>>(q, corpus, mask, out, rows, qp, n, d,
                                                          mask_rows, ell, out_len);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* corpus, const void* mask, void* out, int qp, int n,
               int d, int mask_rows, cudaStream_t stream) {
  const int nb = (n + BUCKET - 1) / BUCKET;
  const float* qq = static_cast<const float*>(q);
  const float* cc = static_cast<const float*>(corpus);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* oo = static_cast<float*>(out);
  if (qp <= 8) {
    bucket_max_f32_kernel<4><<<nb, NTH, 0, stream>>>(qq, cc, mk, oo, qp, n, d, mask_rows);
  } else if (qp <= 16) {
    bucket_max_f32_kernel<8><<<nb, NTH, 0, stream>>>(qq, cc, mk, oo, qp, n, d, mask_rows);
  } else {
    bucket_max_f32_kernel<16><<<nb, NTH, 0, stream>>>(qq, cc, mk, oo, qp, n, d, mask_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int qp, int n, int d, int mask_rows) {
  return qp <= 0 || qp > 32 || n < 0 || d <= 0 || (mask_rows != 1 && mask_rows != qp);
}

// ---------------------------------------------------------------------------
// K-bmax-topk-merge: the blocks' lists to the answer, one block a query
// ---------------------------------------------------------------------------

constexpr int MERGE_THREADS = 1024;

// One level: nl lists of len at (sv, sr), each sorted by the key, merged in
// pairs into ceil(nl / 2) lists of lo = min(k, 2 len) at (dv, dr); a lone
// last list is copied and filled with sentinels. An entry of the even list
// of a pair goes before the partner's entries it precedes, one of the odd
// list after the partner's entries it does not precede: places are unique
// even among equal keys (sentinels).
__device__ __forceinline__ void merge_level(const float* sv, const int* sr, float* dv, int* dr,
                                            int nl, int len, int lo) {
  const int total = nl * len;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int li = e / len, p = e - li * len;
    const float xv = sv[e];
    const int xr = sr[e];
    float* ov = dv + static_cast<size_t>(li >> 1) * lo;
    int* orow = dr + static_cast<size_t>(li >> 1) * lo;
    const int partner = li ^ 1;
    int place = p;
    if (partner < nl) {
      const float* pv = sv + static_cast<size_t>(partner) * len;
      const int* pr = sr + static_cast<size_t>(partner) * len;
      int a = 0, b = len;
      while (a < b) {
        const int mid = (a + b) >> 1;
        const bool before = (li & 1) ? !precedes(xv, xr, pv[mid], pr[mid])
                                     : precedes(pv[mid], pr[mid], xv, xr);
        if (before) a = mid + 1;
        else b = mid;
      }
      place += a;
    } else if (p < lo - len) {
      ov[len + p] = kSentinel;
      orow[len + p] = kSentinelRow;
    }
    if (place < lo) {
      ov[place] = xv;
      orow[place] = xr;
    }
  }
}

// iv/ir: (qp, L, m) lists; out: (qp, k). The levels ping-pong between
// buffers A (size_a entries, the input first) and B (size_b), in shared
// memory, or per query in the global scratch gv/gr when it is given; the
// last level writes the answer.
__global__ void __launch_bounds__(MERGE_THREADS)
    topk_merge_kernel(const float* __restrict__ iv, const int* __restrict__ ir, float* ov,
                      int* orow, float* gv, int* gr, int L, int m, int k, int size_a,
                      int size_b) {
  extern __shared__ __align__(16) unsigned char msm[];
  const int q = blockIdx.x;
  float* av;
  int* ar;
  if (gv == nullptr) {
    av = reinterpret_cast<float*>(msm);
    ar = reinterpret_cast<int*>(av + size_a + size_b);
  } else {
    av = gv + static_cast<size_t>(q) * (size_a + size_b);
    ar = gr + static_cast<size_t>(q) * (size_a + size_b);
  }
  float* bv = av + size_a;
  int* br = ar + size_a;
  const size_t in0 = static_cast<size_t>(q) * L * m;
  for (int e = threadIdx.x; e < L * m; e += blockDim.x) {
    av[e] = iv[in0 + e];
    ar[e] = ir[in0 + e];
  }
  __syncthreads();
  bool in_a = true;
  for (int nl = L, len = m; nl > 1;) {
    const int lo = min(k, 2 * len), no = (nl + 1) / 2;
    float* dv = no == 1 ? ov + static_cast<size_t>(q) * k : (in_a ? bv : av);
    int* dr = no == 1 ? orow + static_cast<size_t>(q) * k : (in_a ? br : ar);
    merge_level(in_a ? av : bv, in_a ? ar : br, dv, dr, nl, len, lo);
    __syncthreads();
    nl = no;
    len = lo;
    in_a = !in_a;
  }
}

}  // namespace

// q: (qp, d) of dt, qp <= 32; corpus: (n, d) of dt; mask: (mask_rows, n)
// bytes (bool or uint8, nonzero = live) with mask_rows 1 (shared) or qp (per
// query); out: (qp, ceil(n / 128)) f32. bf16 needs d % 8 == 0.
extern "C" int mm_bucket_max(void* q, void* corpus, void* mask, void* out, int qp, int n, int d,
                             int mask_rows, int dt, void* stream) {
  if (bad_args(qp, n, d, mask_rows)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == mm::DT_BF16) {
    if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
    const int nb = (n + BUCKET - 1) / BUCKET;
    const int grid = nb < sm_count() ? nb : sm_count();
    const auto go = [&](auto kernel_launch) {
      return kernel_launch(q, corpus, mask, out, nullptr, qp, n, d, mask_rows, grid, 0, 0, st);
    };
    switch ((qp + 7) / 8) {
      case 1: return go(launch_tc<1, false>);
      case 2: return go(launch_tc<2, false>);
      case 3: return go(launch_tc<3, false>);
      default: return go(launch_tc<4, false>);
    }
  }
  if (dt == mm::DT_F32) return launch_f32(q, corpus, mask, out, qp, n, d, mask_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The top-k form (K-bmax-top): each of ``grid`` blocks (<= ceil(n / 128))
// keeps ell (<= kCap) entries a query and writes its first out_len (<= ell):
// vals (qp, grid, out_len) f32 and rows (the same) int32, sorted by (score
// descending, row ascending), sentinels (-inf, INT_MAX) past a block's
// candidates. The wrapper chooses the grid so that a block's list holds the
// top ell of its buckets' union whatever k is.
extern "C" int mm_bucket_topk(void* q, void* corpus, void* mask, void* vals, void* rows, int qp,
                              int n, int d, int mask_rows, int grid, int ell, int out_len, int dt,
                              void* stream) {
  const int nb = (n + BUCKET - 1) / BUCKET;
  if (bad_args(qp, n, d, mask_rows) || n == 0 || grid < 1 || grid > nb || ell < 1 ||
      ell > kCap || out_len < 1 || out_len > ell)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == mm::DT_BF16) {
    if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
    const auto go = [&](auto kernel_launch) {
      return kernel_launch(q, corpus, mask, vals, rows, qp, n, d, mask_rows, grid, ell, out_len,
                           st);
    };
    switch ((qp + 7) / 8) {
      case 1: return go(launch_tc<1, true>);
      case 2: return go(launch_tc<2, true>);
      case 3: return go(launch_tc<3, true>);
      default: return go(launch_tc<4, true>);
    }
  }
  if (dt == mm::DT_F32) {
    const float* qq = static_cast<const float*>(q);
    const float* cc = static_cast<const float*>(corpus);
    const uint8_t* mk = static_cast<const uint8_t*>(mask);
    float* vv = static_cast<float*>(vals);
    int* rr = static_cast<int*>(rows);
    if (qp <= 8)
      return launch_topk_f32<4>(qq, cc, mk, vv, rr, qp, n, d, mask_rows, grid, ell, out_len, st);
    if (qp <= 16)
      return launch_topk_f32<8>(qq, cc, mk, vv, rr, qp, n, d, mask_rows, grid, ell, out_len, st);
    return launch_topk_f32<16>(qq, cc, mk, vv, rr, qp, n, d, mask_rows, grid, ell, out_len, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K-bmax-topk-merge: vals / rows (qp, L, m) sorted lists (K-bmax-top's
// output, L >= 2, L * m >= k) to out_vals / out_rows (qp, k), one block a
// query. size_a / size_b: the two level buffers' entries (the wrapper's
// count: size_a >= L * m); gv / gr: a (qp, size_a + size_b) f32 / int32
// scratch, or null to hold the buffers in shared memory.
extern "C" int mm_topk_merge(void* vals, void* rows, void* out_vals, void* out_rows, void* gv,
                             void* gr, int qp, int L, int m, int k, int size_a, int size_b,
                             void* stream) {
  if (qp <= 0 || L < 2 || m < 1 || k < 1 || static_cast<long long>(L) * m < k ||
      size_a < L * m || size_b < 0 || (gv == nullptr) != (gr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = gv ? 0 : static_cast<size_t>(size_a + size_b) * 8;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  topk_merge_kernel<<<qp, MERGE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(rows),
      static_cast<float*>(out_vals), static_cast<int*>(out_rows), static_cast<float*>(gv),
      static_cast<int*>(gr), L, m, k, size_a, size_b);
  return static_cast<int>(cudaGetLastError());
}
