// K-adc: asymmetric distance computation (ADC) over product-quantized codes.
// A row's code is m bytes (int8, bias -128); its score for query q is
// sum_j tables[j][q, code_j + 128] over j = 0..m-1, in that order, an f32
// sum of bf16 table entries, then + bias. Two kernels:
//
// * adc_bucket_max (B10) replaces mmrag_tpu/ops/pq.py::_adc_bucket_max_kernel,
//   phase A of _pq_topk_fused: the scores of every code row for up to 16
//   queries, reduced to the max of each 128-row bucket, (q, ceil(n / 128));
//   the (q, n) score matrix is never written. Rows past n score -1e30, so
//   the code slab is never padded by a copy.
// * adc_rescore (B11) replaces pq.py::_adc_rescore_kernel: the scores of one
//   query's candidate codes, (q, m, S) lane-major, or (1, m, S) shared by
//   every query (the IVF spill), bias added; (q, S) f32.
//
// The TPU kernels selected table entries with one-hot matmuls on the MXU,
// because a TPU gathers one element at a time; each selection is exact and
// the sum is f32 in j order. Here the tables sit in shared memory and each
// thread looks its entries up directly, summing in the same order, so the
// scores are bit for bit those of the JAX kernels given the same tables.
//
// Bound on an H100: bytes. B10 reads n * m code bytes and the bias (4 B a
// row, or 4q with per-query tenant masks) once: at n 1,048,576, m 16, q 16
// with a per-query bias that is 84 MB, 0.025 ms at 3.35 TB/s. What holds
// this first form back is one shared-memory table lookup per code byte and
// query: the tables are laid out [j][code][query] so that one lookup reads
// the 16 queries' entries of a code as two 16-byte loads, but neighbouring
// threads hold unrelated codes and so hit random banks. B11 at the IVF_PQ
// probe shape (q 16, S 49,152, m 16) reads 12.6 MB of codes and 3.1 MB of
// bias.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int K = 256;        // table entries per subvector
constexpr int BUCKET = 128;   // rows per bucket
constexpr int BMAX_NT = 512;  // 4 buckets of 128 rows per block step
constexpr int BPB = BMAX_NT / BUCKET;
constexpr int RS_NT = 256;    // rescore threads per block
constexpr int RS_TILE = 2048; // candidates per rescore block
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// acc[i] += entry[i] for the QC queries' bf16 entries of one (j, code)
template <int QC>
__device__ __forceinline__ void lookup_add(const bf16* entry, float (&acc)[QC]) {
  if constexpr (QC % 8 == 0) {
    const uint4* e = reinterpret_cast<const uint4*>(entry);
#pragma unroll
    for (int v = 0; v < QC / 8; ++v) {
      const uint4 w = e[v];
      acc[8 * v + 0] += bf_lo(w.x);
      acc[8 * v + 1] += bf_hi(w.x);
      acc[8 * v + 2] += bf_lo(w.y);
      acc[8 * v + 3] += bf_hi(w.y);
      acc[8 * v + 4] += bf_lo(w.z);
      acc[8 * v + 5] += bf_hi(w.z);
      acc[8 * v + 6] += bf_lo(w.w);
      acc[8 * v + 7] += bf_hi(w.w);
    }
  } else if constexpr (QC % 2 == 0) {
    const uint32_t* e = reinterpret_cast<const uint32_t*>(entry);
#pragma unroll
    for (int v = 0; v < QC / 2; ++v) {
      const uint32_t w = e[v];
      acc[2 * v + 0] += bf_lo(w);
      acc[2 * v + 1] += bf_hi(w);
    }
  } else {
#pragma unroll
    for (int v = 0; v < QC; ++v) acc[v] += __bfloat162float(entry[v]);
  }
}

template <int QC>
__global__ void __launch_bounds__(BMAX_NT)
    adc_bucket_max_kernel(const bf16* __restrict__ tables, const int8_t* __restrict__ codes,
                          const float* __restrict__ bias, float* __restrict__ out, int m, int qc,
                          int n, int bias_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* t = reinterpret_cast<bf16*>(smem_raw);  // [j][code][QC]
  __shared__ float red[BPB][BUCKET / 32][QC];

  const int tid = threadIdx.x, lane = tid & 31;
  // tables (m, qc, K) -> shared [j][code][query], queries past qc zero
  const int entries = m * K * QC;
  for (int e = tid; e < entries; e += BMAX_NT) {
    const int qi = e % QC;
    const int code = (e / QC) % K;
    const int j = e / (QC * K);
    t[e] = qi < qc ? tables[(static_cast<size_t>(j) * qc + qi) * K + code]
                   : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  const int nb = (n + BUCKET - 1) / BUCKET;
  const int lb = tid / BUCKET;             // bucket within the block step
  const int wib = (tid % BUCKET) >> 5;     // warp within the bucket
  for (int g = blockIdx.x; g * BPB < nb; g += gridDim.x) {
    const int bucket = g * BPB + lb;
    const long long row = static_cast<long long>(bucket) * BUCKET + (tid % BUCKET);
    const bool in = row < n;
    float acc[QC];
#pragma unroll
    for (int i = 0; i < QC; ++i) acc[i] = 0.f;
    if (in) {
      const int8_t* c = codes + row * m;
      for (int j = 0; j < m; ++j) {
        const int code = static_cast<int>(__ldg(c + j)) + 128;
        lookup_add<QC>(t + (static_cast<size_t>(j) * K + code) * QC, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < QC; ++i) {
      float v = kNeg;
      if (in && i < qc) {
        const size_t brow = bias_rows == 1 ? 0 : static_cast<size_t>(i);
        v = acc[i] + bias[brow * n + row];
      }
      v = mm::warp_max(v);
      if (lane == 0) red[lb][wib][i] = v;
    }
    __syncthreads();
    if (tid < BPB * QC) {
      const int b2 = tid / QC, i = tid % QC;
      const int bk = g * BPB + b2;
      if (bk < nb && i < qc) {
        float v = red[b2][0][i];
#pragma unroll
        for (int w = 1; w < BUCKET / 32; ++w) v = fmaxf(v, red[b2][w][i]);
        out[static_cast<size_t>(i) * nb + bk] = v;
      }
    }
    __syncthreads();
  }
}

template <int QC>
int launch_bucket_max(const bf16* tables, const int8_t* codes, const float* bias, float* out,
                      int m, int qc, int n, int bias_rows, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(m) * K * QC * sizeof(bf16);
  auto kern = adc_bucket_max_kernel<QC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BMAX_NT, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nb = (n + BUCKET - 1) / BUCKET;
  const int groups = (nb + BPB - 1) / BPB;
  // persistent blocks: each loads the tables once and walks many buckets
  const int grid = groups < sms * per_sm ? groups : sms * per_sm;
  kern<<<grid, BMAX_NT, smem, st>>>(tables, codes, bias, out, m, qc, n, bias_rows);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(RS_NT)
    adc_rescore_kernel(const bf16* __restrict__ tables, const int8_t* __restrict__ codes,
                       const float* __restrict__ bias, float* __restrict__ out, int m, int q,
                       int S, int shared) {
  extern __shared__ __align__(16) unsigned char rs_raw[];
  bf16* tq = reinterpret_cast<bf16*>(rs_raw);  // this query's [j][code]
  const int qi = blockIdx.y, tid = threadIdx.x;
  for (int e = tid; e < m * K; e += RS_NT) {
    const int j = e / K, code = e % K;
    tq[e] = tables[(static_cast<size_t>(j) * q + qi) * K + code];
  }
  __syncthreads();
  const int8_t* cb = codes + (shared ? 0 : static_cast<size_t>(qi) * m * S);
  const size_t row0 = static_cast<size_t>(qi) * S;
  const int base = blockIdx.x * RS_TILE;
#pragma unroll 1
  for (int k = 0; k < RS_TILE / RS_NT; ++k) {
    const int s = base + k * RS_NT + tid;
    if (s >= S) break;
    float acc = 0.f;
    for (int j = 0; j < m; ++j) {
      const int code = static_cast<int>(__ldg(cb + static_cast<size_t>(j) * S + s)) + 128;
      acc += __bfloat162float(tq[j * K + code]);
    }
    out[row0 + s] = acc + bias[row0 + s];
  }
}

}  // namespace

// tables: (m, qc, 256) bf16, qc <= 16 and m * 256 * round-up(qc) * 2 B within
// the shared-memory budget; codes: (n, m) int8; bias: (bias_rows, n) f32 with
// bias_rows 1 (shared) or qc; out: (qc, ceil(n / 128)) f32.
extern "C" int mm_adc_bucket_max(void* tables, void* codes, void* bias, void* out, int m, int qc,
                                 int n, int bias_rows, void* stream) {
  if (m <= 0 || qc <= 0 || qc > 16 || n < 0 || (bias_rows != 1 && bias_rows != qc))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bf16* t = static_cast<const bf16*>(tables);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qc == 1) return launch_bucket_max<1>(t, c, b, o, m, qc, n, bias_rows, st);
  if (qc == 2) return launch_bucket_max<2>(t, c, b, o, m, qc, n, bias_rows, st);
  if (qc <= 4) return launch_bucket_max<4>(t, c, b, o, m, qc, n, bias_rows, st);
  if (qc <= 8) return launch_bucket_max<8>(t, c, b, o, m, qc, n, bias_rows, st);
  return launch_bucket_max<16>(t, c, b, o, m, qc, n, bias_rows, st);
}

// tables: (m, q, 256) bf16; codes: (q, m, S) int8, or (1, m, S) with shared
// = 1; bias: (q, S) f32; out: (q, S) f32.
extern "C" int mm_adc_rescore(void* tables, void* codes, void* bias, void* out, int m, int q,
                              int S, int shared, void* stream) {
  if (m <= 0 || q < 0 || S < 0 || q > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0 || S == 0) return 0;
  const size_t smem = static_cast<size_t>(m) * K * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(adc_rescore_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + RS_TILE - 1) / RS_TILE, q);
  adc_rescore_kernel<<<grid, RS_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(tables), static_cast<const int8_t*>(codes),
      static_cast<const float*>(bias), static_cast<float*>(out), m, q, S, shared);
  return static_cast<int>(cudaGetLastError());
}
