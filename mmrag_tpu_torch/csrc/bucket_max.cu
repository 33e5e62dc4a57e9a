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
__host__ __device__ constexpr size_t tc_smem(int nt, int d) {
  return static_cast<size_t>(TC_STAGES) * TC_STAGE_ELEMS * 2 +
         static_cast<size_t>(8 * nt) * tc_qpitch(d) * 2 + 2 * TC_WARPS * 8 * nt * 4;
}

template <int NT>  // n-tiles of 8 queries
__global__ void __launch_bounds__(TC_THREADS, 1)
    bucket_max_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ corpus,
                         const uint8_t* __restrict__ mask, float* __restrict__ out, int qp,
                         int n, int d, int mask_rows) {
  constexpr int QR = 8 * NT;  // staged query rows (rows >= qp are zero)
  extern __shared__ __align__(128) unsigned char smem[];
  const int nchunk = (d + TC_COLS - 1) / TC_COLS;
  const int qpitch = tc_qpitch(d);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* qs = ring + TC_STAGES * TC_STAGE_ELEMS;
  float* red = reinterpret_cast<float*>(qs + QR * qpitch);  // [2][TC_WARPS][QR]

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
  for (int item = 0; item < total; ++item) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    if (pending >= 0) {
      if (tid < qp) {
        const float* rp = red + pend_par * TC_WARPS * QR;
        float v = rp[tid];
#pragma unroll
        for (int w = 1; w < TC_WARPS; ++w) v = fmaxf(v, rp[w * QR + tid]);
        out[static_cast<size_t>(tid) * nb + pending] = v;
      }
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
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v0 = keep[t][c] ? acc[t][c] : kNeg;          // row g
          const float v1 = keep[t][2 + c] ? acc[t][2 + c] : kNeg;  // row g + 8
          float v = fmaxf(v0, v1);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if (g == 0) rp[t * 8 + tq * 2 + c] = v;
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
  if (pending >= 0 && tid < qp) {
    const float* rp = red + pend_par * TC_WARPS * QR;
    float v = rp[tid];
#pragma unroll
    for (int w = 1; w < TC_WARPS; ++w) v = fmaxf(v, rp[w * QR + tid]);
    out[static_cast<size_t>(tid) * nb + pending] = v;
  }
}

template <int NT>
int launch_tc(const void* q, const void* corpus, const void* mask, void* out, int qp, int n,
              int d, int mask_rows, cudaStream_t stream) {
  const size_t smem = tc_smem(NT, d);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_max_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int nb = (n + BUCKET - 1) / BUCKET;
  const int grid = nb < sm_count() ? nb : sm_count();
  bucket_max_tc_kernel<NT><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(corpus),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), qp, n, d, mask_rows);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the first design, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NTH = 256;  // 2 threads a row: each takes every other query
constexpr int DC = 32;    // columns staged per step

template <int QPT>
__global__ void __launch_bounds__(NTH)
    bucket_max_f32_kernel(const float* __restrict__ q, const float* __restrict__ corpus,
                          const uint8_t* __restrict__ mask, float* __restrict__ out, int qp,
                          int n, int d, int mask_rows) {
  constexpr int QMAX = 2 * QPT;
  __shared__ float cs[BUCKET][DC + 1];
  __shared__ __align__(16) float qs[QMAX][DC];
  __shared__ float red[2][4][QPT];

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
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    const int j = g + 2 * t;
    float v = kNeg;
    if (grow < n && j < qp) {
      const size_t mrow = mask_rows == 1 ? 0 : static_cast<size_t>(j);
      if (mask[mrow * n + grow]) v = acc[t];
    }
    v = mm::warp_max(v);
    if ((tid & 31) == 0) red[g][warp_in_group][t] = v;
  }
  __syncthreads();
  const int nb = (n + BUCKET - 1) / BUCKET;
  if (tid < 2 * QPT) {
    const int gg = tid / QPT, t = tid % QPT;
    const int j = gg + 2 * t;
    if (j < qp) {
      float v = fmaxf(fmaxf(red[gg][0][t], red[gg][1][t]), fmaxf(red[gg][2][t], red[gg][3][t]));
      out[static_cast<size_t>(j) * nb + bucket] = v;
    }
  }
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

}  // namespace

// q: (qp, d) of dt, qp <= 32; corpus: (n, d) of dt; mask: (mask_rows, n)
// bytes (bool or uint8, nonzero = live) with mask_rows 1 (shared) or qp (per
// query); out: (qp, ceil(n / 128)) f32. bf16 needs d % 8 == 0.
extern "C" int mm_bucket_max(void* q, void* corpus, void* mask, void* out, int qp, int n, int d,
                             int mask_rows, int dt, void* stream) {
  if (qp <= 0 || qp > 32 || n < 0 || d <= 0 || (mask_rows != 1 && mask_rows != qp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == mm::DT_BF16) {
    if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
    switch ((qp + 7) / 8) {
      case 1: return launch_tc<1>(q, corpus, mask, out, qp, n, d, mask_rows, st);
      case 2: return launch_tc<2>(q, corpus, mask, out, qp, n, d, mask_rows, st);
      case 3: return launch_tc<3>(q, corpus, mask, out, qp, n, d, mask_rows, st);
      default: return launch_tc<4>(q, corpus, mask, out, qp, n, d, mask_rows, st);
    }
  }
  if (dt == mm::DT_F32) return launch_f32(q, corpus, mask, out, qp, n, d, mask_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
