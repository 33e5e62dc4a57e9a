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
// The top-t form (mm_bucket_top, X1: TPU_TOPK_BACKEND=approx) replaces
// mmrag_tpu/ops/topk.py::_cosine_topk_approx (jax.lax.approx_max_k, the
// TPU's PartialReduce: keep each bin's best, then a top-k of those). It is
// a separate instance of each kernel, chosen at compile time (TOP = true),
// so the exact path's instances keep their code. Where the exact form takes
// a bucket's max, it writes, for every query, the kTop best rows of the
// bucket and their scores: out (qp, nb, kTop) f32 and rows (qp, nb, kTop)
// int32 (global row ids), best first, on equal scores the lower row first
// (the plain version's stable sort). kTop is 48, the smallest that holds
// the contract at the engine's k 50 whatever the data: a query loses only
// the true top-k rows past the 48th of one bucket, so its recall is at least
// min(1, 48 / k), 0.96 at k 50, even where every one of its top-50 lies in
// one bucket (a document of 50 or more chunks, appended in contiguous rows).
// With 16 rows a bucket, mean recall@50 was 0.905 on documents of 8-24
// chunks and 0.4625 on documents of 32-96; with 48, 1.0 and 0.9838 (least
// 0.96) (tools/approx_recall.py, 65,536 rows x 384, on the CPU). The
// bucket's masked scores go to shared memory (query-major, a row pitch of
// 132 floats: the m16n8 layout's stores and a warp's 16-byte row reads are
// free of bank conflicts), and one warp a query sorts its 128 (score, row)
// pairs (warp_top). The bf16 form selects a bucket at the start of the next
// item, as the exact form reduces across warps there, while that item's
// loads are in flight. Bound: the same corpus read plus the (qp, nb, kTop)
// pairs written (8 B each). -Xptxas -v (CUDA 12.8): the bf16 top-t
// instances 104-115 registers, the f32 ones 64-104 and 22-37 KB of static
// shared memory; no stack frame, no spills.
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
constexpr int kTop = 48;       // rows kept a bucket by the top-t form (a multiple of 4)
constexpr int SC_PITCH = 132;  // floats a query row of a bucket's staged scores

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
constexpr int TC_STAGE_ELEMS = BUCKET * TC_COLS;  // 16 KB of bf16
constexpr int TC_WARPS = TC_THREADS / 32;

__host__ __device__ constexpr int tc_qpitch(int d) {  // bf16 elements a staged query row
  return ((d + TC_COLS - 1) / TC_COLS) * TC_COLS + 8;  // +16 B: 8 rows, 8 bank groups
}
// the ring, the staged queries, then the cross-warp maxima [2][TC_WARPS][QR]
// (exact form) or the bucket's staged scores [2][QR][SC_PITCH] (top-t form)
__host__ __device__ constexpr size_t tc_smem(int nt, int d, bool top) {
  return static_cast<size_t>(TC_STAGES) * TC_STAGE_ELEMS * 2 +
         static_cast<size_t>(8 * nt) * tc_qpitch(d) * 2 +
         (top ? 2 * 8 * nt * SC_PITCH * 4 : 2 * TC_WARPS * 8 * nt * 4);
}

// TOP = false: the maxima, out (qp, nb). TOP = true: the kTop best rows,
// out (qp, nb, kTop) and rows (qp, nb, kTop).
template <int NT, bool TOP>  // n-tiles of 8 queries
__global__ void __launch_bounds__(TC_THREADS, 1)
    bucket_max_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ corpus,
                         const uint8_t* __restrict__ mask, float* __restrict__ out,
                         int* __restrict__ rows, int qp, int n, int d, int mask_rows) {
  constexpr int QR = 8 * NT;  // staged query rows (rows >= qp are zero)
  extern __shared__ __align__(128) unsigned char smem[];
  const int nchunk = (d + TC_COLS - 1) / TC_COLS;
  const int qpitch = tc_qpitch(d);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* qs = ring + TC_STAGES * TC_STAGE_ELEMS;
  float* red = reinterpret_cast<float*>(qs + QR * qpitch);  // [2][TC_WARPS][QR] or scores

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = (n + BUCKET - 1) / BUCKET;
  const int my_buckets = (nb - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int total = my_buckets * nchunk;  // (bucket, column chunk) items of this block

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
      bf16* st = ring + (item % TC_STAGES) * TC_STAGE_ELEMS;
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
  for (int s = 0; s < TC_STAGES - 1; ++s) fetch(s);

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
  // a finished bucket's result: the max across the warps, or the top-t rows
  auto flush = [&](int bucket, int par) {
    if constexpr (TOP) {
      const float* sp = red + par * QR * SC_PITCH;
      for (int j = warp; j < qp; j += TC_WARPS) {
        const size_t o = (static_cast<size_t>(j) * nb + bucket) * kTop;
        warp_top(sp + j * SC_PITCH, lane, out + o, rows + o, bucket * BUCKET);
      }
    } else if (tid < qp) {
      const float* rp = red + par * TC_WARPS * QR;
      float v = rp[tid];
#pragma unroll
      for (int w = 1; w < TC_WARPS; ++w) v = fmaxf(v, rp[w * QR + tid]);
      out[static_cast<size_t>(tid) * nb + bucket] = v;
    }
  };
  for (int item = 0; item < total; ++item) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    if (pending >= 0) {
      flush(pending, pend_par);
      pending = -1;
    }
    fetch(item + TC_STAGES - 1);

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

    const bf16* st = ring + (item % TC_STAGES) * TC_STAGE_ELEMS;
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
      float* rp = red + par * TC_WARPS * QR + warp * QR;
      float* sp = red + par * QR * SC_PITCH + warp * 16 + g;  // top-t: this thread's row
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
      pending = bucket;
      pend_par = par;
      ++done;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (pending >= 0) flush(pending, pend_par);
}

template <int NT, bool TOP>
int launch_tc(const void* q, const void* corpus, const void* mask, void* out, void* rows, int qp,
              int n, int d, int mask_rows, cudaStream_t stream) {
  const size_t smem = tc_smem(NT, d, TOP);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_max_tc_kernel<NT, TOP>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int nb = (n + BUCKET - 1) / BUCKET;
  const int grid = nb < sm_count() ? nb : sm_count();
  bucket_max_tc_kernel<NT, TOP><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(corpus),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<int*>(rows), qp,
      n, d, mask_rows);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the first design, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NTH = 256;  // 2 threads a row: each takes every other query
constexpr int DC = 32;    // columns staged per step

template <int QPT, bool TOP>
__global__ void __launch_bounds__(NTH)
    bucket_max_f32_kernel(const float* __restrict__ q, const float* __restrict__ corpus,
                          const uint8_t* __restrict__ mask, float* __restrict__ out,
                          int* __restrict__ rows, int qp, int n, int d, int mask_rows) {
  constexpr int QMAX = 2 * QPT;
  __shared__ float cs[BUCKET][DC + 1];
  __shared__ __align__(16) float qs[QMAX][DC];
  __shared__ float red[2][4][QPT];
  __shared__ __align__(16) float sc[TOP ? QMAX : 1][TOP ? SC_PITCH : 1];  // top-t: scores

  const int tid = threadIdx.x;
  const int r = tid % BUCKET;  // row within the bucket
  const int g = tid / BUCKET;  // query parity
  const int bucket = blockIdx.x;
  const size_t row0 = static_cast<size_t>(bucket) * BUCKET;
  const int grow = static_cast<int>(row0) + r;

  float acc[QPT];
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

  const int warp_in_group = (tid % BUCKET) >> 5;
  const int nb = (n + BUCKET - 1) / BUCKET;
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    const int j = g + 2 * t;
    float v = kNeg;
    if (grow < n && j < qp) {
      const size_t mrow = mask_rows == 1 ? 0 : static_cast<size_t>(j);
      if (mask[mrow * n + grow]) v = acc[t];
    }
    if constexpr (TOP) {
      sc[j][r] = v;
    } else {
      v = mm::warp_max(v);
      if ((tid & 31) == 0) red[g][warp_in_group][t] = v;
    }
  }
  __syncthreads();
  if constexpr (TOP) {
    for (int j = tid >> 5; j < qp; j += NTH / 32) {
      const size_t o = (static_cast<size_t>(j) * nb + bucket) * kTop;
      warp_top(sc[j], tid & 31, out + o, rows + o, bucket * BUCKET);
    }
    return;
  }
  if (tid < 2 * QPT) {
    const int gg = tid / QPT, t = tid % QPT;
    const int j = gg + 2 * t;
    if (j < qp) {
      float v = fmaxf(fmaxf(red[gg][0][t], red[gg][1][t]), fmaxf(red[gg][2][t], red[gg][3][t]));
      out[static_cast<size_t>(j) * nb + bucket] = v;
    }
  }
}

template <bool TOP>
int launch_f32(const void* q, const void* corpus, const void* mask, void* out, void* rows, int qp,
               int n, int d, int mask_rows, cudaStream_t stream) {
  const int nb = (n + BUCKET - 1) / BUCKET;
  const float* qq = static_cast<const float*>(q);
  const float* cc = static_cast<const float*>(corpus);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* oo = static_cast<float*>(out);
  int* rr = static_cast<int*>(rows);
  if (qp <= 8) {
    bucket_max_f32_kernel<4, TOP><<<nb, NTH, 0, stream>>>(qq, cc, mk, oo, rr, qp, n, d,
                                                          mask_rows);
  } else if (qp <= 16) {
    bucket_max_f32_kernel<8, TOP><<<nb, NTH, 0, stream>>>(qq, cc, mk, oo, rr, qp, n, d,
                                                          mask_rows);
  } else {
    bucket_max_f32_kernel<16, TOP><<<nb, NTH, 0, stream>>>(qq, cc, mk, oo, rr, qp, n, d,
                                                           mask_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool TOP>
int launch(void* q, void* corpus, void* mask, void* out, void* rows, int qp, int n, int d,
           int mask_rows, int dt, cudaStream_t st) {
  if (qp <= 0 || qp > 32 || n < 0 || d <= 0 || (mask_rows != 1 && mask_rows != qp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (dt == mm::DT_BF16) {
    if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
    switch ((qp + 7) / 8) {
      case 1: return launch_tc<1, TOP>(q, corpus, mask, out, rows, qp, n, d, mask_rows, st);
      case 2: return launch_tc<2, TOP>(q, corpus, mask, out, rows, qp, n, d, mask_rows, st);
      case 3: return launch_tc<3, TOP>(q, corpus, mask, out, rows, qp, n, d, mask_rows, st);
      default: return launch_tc<4, TOP>(q, corpus, mask, out, rows, qp, n, d, mask_rows, st);
    }
  }
  if (dt == mm::DT_F32) return launch_f32<TOP>(q, corpus, mask, out, rows, qp, n, d, mask_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (qp, d) of dt, qp <= 32; corpus: (n, d) of dt; mask: (mask_rows, n)
// bytes (bool or uint8, nonzero = live) with mask_rows 1 (shared) or qp (per
// query); out: (qp, ceil(n / 128)) f32. bf16 needs d % 8 == 0.
extern "C" int mm_bucket_max(void* q, void* corpus, void* mask, void* out, int qp, int n, int d,
                             int mask_rows, int dt, void* stream) {
  return launch<false>(q, corpus, mask, out, nullptr, qp, n, d, mask_rows, dt,
                       static_cast<cudaStream_t>(stream));
}

// The top-t form: vals (qp, ceil(n / 128), t) f32 and rows (the same) int32,
// t == kTop (the wrapper passes its own constant, checked here).
extern "C" int mm_bucket_top(void* q, void* corpus, void* mask, void* vals, void* rows, int qp,
                             int n, int d, int mask_rows, int t, int dt, void* stream) {
  if (t != kTop) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, corpus, mask, vals, rows, qp, n, d, mask_rows, dt,
                      static_cast<cudaStream_t>(stream));
}
