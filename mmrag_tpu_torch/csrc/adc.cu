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
// Bound on an H100. B10 reads n * m code bytes and the bias (4 B a row, or
// 4q with per-query tenant masks) once: at n 1,048,576, m 16, q 16 with a
// per-query bias that is 84 MB, 0.025 ms at 3.35 TB/s. Its other floor is
// the shared-memory lookups: n * m * q bf16 entries, 537 MB at q 16, 0.017
// ms at 128 B a clock on each of 132 SMs, and more, because the codes are
// random and so are the banks they hit. The design keeps the lookups few
// and their bank conflicts low:
// * lanes split the queries: a lane sums 8 of them (one 16-byte lookup a
//   code byte), 2 lanes a row at 16 queries, so a quarter-warp reads the
//   32-byte runs of 4 rows: 2.1 passes on average (one thread holding all
//   16 queries of a row needs two lookups a code byte, each quarter-warp
//   then hitting 4 of the 8 bank groups: 3.3 passes);
// * the table sits in shared memory indexed by the code's raw byte
//   ([j][byte][query], code + 128 = byte ^ 0x80), so a lookup is a byte
//   extract and one address computation;
// * a row's codes come in as one 16-byte load (4-byte loads when m is not a
//   multiple of 16), the bias loads go out before the lookups they wait
//   behind, and each warp owns whole 128-row buckets: the maxima reduce in
//   registers and with shuffles, with no shared-memory pass and no block
//   barrier;
// * 1024 threads a block (32 warps an SM with the 128 KB table, two blocks
//   when the table is small), persistent: each block loads the tables once.
// B11 at the IVF_PQ probe shape (q 16, S 49,152, m 16) reads 12.6 MB of codes
// and 3.1 MB of bias.
#include <atomic>

#include "common.cuh"

using mm::bf16;

namespace {

constexpr int K = 256;        // table entries per subvector
constexpr int BUCKET = 128;   // rows per bucket
constexpr int BMAX_NT = 1024; // bucket-max threads per block
constexpr int BMAX_WARPS = BMAX_NT / 32;
constexpr int RS_NT = 256;    // rescore threads per block
constexpr int RS_TILE = 2048; // candidates per rescore block
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// acc[i] += entry[i] for QL consecutive bf16 entries (one shared-memory load)
template <int QL>
__device__ __forceinline__ void lookup_add(const unsigned char* entry, float (&acc)[QL]) {
  if constexpr (QL == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(entry);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      acc[2 * v] += bf_lo(u[v]);
      acc[2 * v + 1] += bf_hi(u[v]);
    }
  } else if constexpr (QL == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(entry);
    acc[0] += bf_lo(w.x);
    acc[1] += bf_hi(w.x);
    acc[2] += bf_lo(w.y);
    acc[3] += bf_hi(w.y);
  } else if constexpr (QL == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(entry);
    acc[0] += bf_lo(w);
    acc[1] += bf_hi(w);
  } else {
    acc[0] += __bfloat162float(*reinterpret_cast<const bf16*>(entry));
  }
}

// CW code bytes of a row from one load (16, 4 or 1 bytes), as words
template <int CW>
__device__ __forceinline__ void load_codes(const int8_t* p, uint32_t (&w)[(CW + 3) / 4]) {
  if constexpr (CW == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (CW == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = static_cast<uint8_t>(__ldg(p));
  }
}

// QC queries (qc rounded up to a power of two): a lane sums QL of them for
// its row, LPR lanes a row, 32 / LPR rows a warp step; a warp walks whole
// buckets, a block's warps share the tables.
template <int QC, int CW>
__global__ void __launch_bounds__(BMAX_NT)
    adc_bucket_max_kernel(const bf16* __restrict__ tables, const int8_t* __restrict__ codes,
                          const float* __restrict__ bias, float* __restrict__ out, int m, int qc,
                          int n, int bias_rows) {
  constexpr int QL = QC < 8 ? QC : 8;
  constexpr int LPR = QC / QL;
  constexpr int RPS = 32 / LPR;
  constexpr int STRIDE = QC * 2;  // bytes of one (j, byte) entry
  extern __shared__ __align__(16) unsigned char smem_raw[];  // [j][byte][QC] bf16

  const int tid = threadIdx.x;
  // tables (m, qc, K) -> shared [j][byte][query]: entry byte b holds code
  // b ^ 0x80 (int8 code c, table index c + 128); queries past qc are zero.
  // A thread gathers one entry's queries into words and stores them whole.
  const unsigned short* tg = reinterpret_cast<const unsigned short*>(tables);
  for (int e = tid; e < m * K; e += BMAX_NT) {
    const unsigned short* src = tg + static_cast<size_t>(e / K) * qc * K + ((e % K) ^ 0x80);
    uint32_t w[(QC + 1) / 2];
#pragma unroll
    for (int p = 0; p < (QC + 1) / 2; ++p) {
      const uint32_t lo = 2 * p < qc ? __ldg(src + 2 * p * K) : 0u;
      const uint32_t hi = 2 * p + 1 < QC && 2 * p + 1 < qc ? __ldg(src + (2 * p + 1) * K) : 0u;
      w[p] = lo | (hi << 16);
    }
    unsigned char* dst = smem_raw + static_cast<size_t>(e) * STRIDE;
    if constexpr (QC >= 8) {
#pragma unroll
      for (int p = 0; p < QC / 2; p += 4)
        *reinterpret_cast<uint4*>(dst + 4 * p) = make_uint4(w[p], w[p + 1], w[p + 2], w[p + 3]);
    } else if constexpr (QC == 4) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else if constexpr (QC == 2) {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(w[0]);
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int q0 = (lane % LPR) * QL;  // this lane's first query
  const int rl = lane / LPR;         // its row within a step
  const unsigned char* tl = smem_raw + q0 * 2;
  const int nb = (n + BUCKET - 1) / BUCKET;
  for (int b = blockIdx.x * BMAX_WARPS + (tid >> 5); b < nb; b += gridDim.x * BMAX_WARPS) {
    float mx[QL];
#pragma unroll
    for (int i = 0; i < QL; ++i) mx[i] = kNeg;
#pragma unroll 1
    for (int s = 0; s < BUCKET / RPS; ++s) {
      const long long row = static_cast<long long>(b) * BUCKET + s * RPS + rl;
      if (row >= n) break;  // rows only run out in the last bucket
      float bv[QL];  // loaded first: the lookups hide their latency
      if (bias_rows == 1) {
        const float v = __ldg(bias + row);
#pragma unroll
        for (int i = 0; i < QL; ++i) bv[i] = v;
      } else {
#pragma unroll
        for (int i = 0; i < QL; ++i)
          bv[i] = q0 + i < qc ? __ldg(bias + static_cast<size_t>(q0 + i) * n + row) : 0.f;
      }
      float acc[QL];
#pragma unroll
      for (int i = 0; i < QL; ++i) acc[i] = 0.f;
      const int8_t* c = codes + row * m;
      const unsigned char* tj = tl;
      for (int j0 = 0; j0 < m; j0 += CW) {
        uint32_t w[(CW + 3) / 4];
        load_codes<CW>(c + j0, w);
#pragma unroll
        for (int jj = 0; jj < CW; ++jj) {
          const uint32_t byte = (w[jj / 4] >> (8 * (jj % 4))) & 0xffu;
          lookup_add<QL>(tj + byte * STRIDE, acc);
          tj += K * STRIDE;
        }
      }
#pragma unroll
      for (int i = 0; i < QL; ++i) mx[i] = fmaxf(mx[i], acc[i] + bv[i]);
    }
    // the maxima over the lanes that hold the same queries
#pragma unroll
    for (int o = 16; o >= LPR; o >>= 1)
#pragma unroll
      for (int i = 0; i < QL; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
    if (rl == 0) {
#pragma unroll
      for (int i = 0; i < QL; ++i)
        if (q0 + i < qc) out[static_cast<size_t>(q0 + i) * nb + b] = mx[i];
    }
  }
}

template <int QC, int CW>
int launch_bucket_max(const bf16* tables, const int8_t* codes, const float* bias, float* out,
                      int m, int qc, int n, int bias_rows, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(m) * K * QC * sizeof(bf16);
  auto kern = adc_bucket_max_kernel<QC, CW>;
  // every table size the device can hold, allowed once (host time counts at
  // the small shapes); a larger table fails its launch
  static const cudaError_t attr = [&] {
    int dev = 0, most = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return e == cudaSuccess
               ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most)
               : e;
  }();
  cudaError_t err = attr;
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks an SM holds at this table size, asked once per size (host time
  // counts at the small shapes): (smem << 8) | blocks
  static std::atomic<long long> occupancy{-1};
  long long occ = occupancy.load();
  if (occ < 0 || static_cast<size_t>(occ >> 8) != smem) {
    int blocks = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, BMAX_NT, smem)) !=
        cudaSuccess)
      return static_cast<int>(err);
    occ = (static_cast<long long>(smem) << 8) | (blocks & 0xff);
    occupancy.store(occ);
  }
  const int per_sm = static_cast<int>(occ & 0xff);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nb = (n + BUCKET - 1) / BUCKET;
  const int wanted = (nb + BMAX_WARPS - 1) / BMAX_WARPS;
  const int slots = mm::sm_count() * per_sm;
  // persistent blocks: each loads the tables once and walks many buckets
  kern<<<wanted < slots ? wanted : slots, BMAX_NT, smem, st>>>(tables, codes, bias, out, m, qc,
                                                               n, bias_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int QC>
int bucket_max_by_codes(const bf16* t, const int8_t* c, const float* b, float* o, int m, int qc,
                        int n, int bias_rows, cudaStream_t st) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(c);
  if (m % 16 == 0 && addr % 16 == 0) return launch_bucket_max<QC, 16>(t, c, b, o, m, qc, n, bias_rows, st);
  if (m % 4 == 0 && addr % 4 == 0) return launch_bucket_max<QC, 4>(t, c, b, o, m, qc, n, bias_rows, st);
  return launch_bucket_max<QC, 1>(t, c, b, o, m, qc, n, bias_rows, st);
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
  if (qc == 1) return bucket_max_by_codes<1>(t, c, b, o, m, qc, n, bias_rows, st);
  if (qc == 2) return bucket_max_by_codes<2>(t, c, b, o, m, qc, n, bias_rows, st);
  if (qc <= 4) return bucket_max_by_codes<4>(t, c, b, o, m, qc, n, bias_rows, st);
  if (qc <= 8) return bucket_max_by_codes<8>(t, c, b, o, m, qc, n, bias_rows, st);
  return bucket_max_by_codes<16>(t, c, b, o, m, qc, n, bias_rows, st);
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
