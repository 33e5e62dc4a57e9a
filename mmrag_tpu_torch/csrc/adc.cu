// K-adc: asymmetric distance computation (ADC) over product-quantized codes.
// A row's code is m bytes (int8, bias -128); its score for query q is
// sum_j tables[j][q, code_j + 128] over j = 0..m-1, in that order, an f32
// sum of bf16 table entries, then + bias. Two kernels:
//
// * adc_bucket_max (B10) replaces mmrag_tpu/ops/pq.py::_adc_bucket_max_kernel
//   (:229, launched at :319), phase A of _pq_topk_fused: the scores of every code row for up to 16
//   queries, reduced to the max of each 128-row bucket, (q, ceil(n / 128));
//   the (q, n) score matrix is never written. Rows past n score -1e30, so
//   the code slab is never padded by a copy.
// * adc_rescore (B11) replaces pq.py::_adc_rescore_kernel (:270, launched
//   at :415): the scores of each query's candidate codes, (q, m, S)
//   lane-major, or (1, m, S) shared by every query (the IVF spill), bias
//   added; (q, S) f32.
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
//
//
// B11 at the IVF_PQ probe shape (q 16, S 49,152, m 16, one candidate set a
// query) reads 12.6 MB of codes and 3.1 MB of bias and writes 3.1 MB of
// scores: 5.7 us at 3.35 TB/s. Its lookups are q * S * m bf16 entries, 25 MB,
// 0.8 us at 128 B a clock on each SM; but a warp's 2-byte lookup serves 32
// lanes a pass (64 B), and random codes hit random banks (2-4 passes a
// lookup), so the lookups take about as long as the bytes. In the shared
// form (the IVF spill: codes (1, m, S), the same candidates for every
// query) the codes are 0.8 MB and the call 7.2 MB, 2.2 us. The design:
// * per query, a thread scores a run of 16 consecutive candidates (the
//   lane-major codes of a step are contiguous: one 16-byte load; runs of 4
//   with 4-byte loads at q 1, so that the grid still covers the SMs, or of 1
//   with byte loads where S or a pointer is not aligned), keeps 16 f32
//   accumulators, loads four steps' codes before their lookups, adds the
//   bias from 16-byte loads issued before the table is staged, and stores
//   16 bytes at a time. The query's 8 KB table is staged with 16-byte loads,
//   indexed by the raw byte as in B10. Blocks of 256 threads, halved (to 64)
//   until the SMs' shares of blocks are even within about 10%. Codes copied
//   to shared memory with cp.async, or more steps' codes held in registers,
//   measured slower at q 16 (fewer blocks an SM);
// * shared, a block stages the tables of a group of up to 8 queries in B10's
//   [j][byte][query] layout (64 KB at m 16; 4, 2 or 1 queries where m is
//   large; further groups on blockIdx.y), the byte's low three bits XORed
//   with the next three so that its stores are free of bank conflicts; each
//   code byte is read once and looked up for the group with one 16-byte load
//   (lookup_add<8>). Staging 64 KB costs a block about as much as scoring
//   2,000 candidates, so the grid is one block an SM, 512 threads that all
//   stage and split the group's candidates evenly, with each run's bias and
//   16 steps' codes in flight while the tables are staged.
// What holds B11 back at these shapes (variants with the staging or the
// lookups taken out, timed on an H100): in the shared form the loads, the
// stores and the launch alone take more than half of the time, then the
// lookups, then the staging; the per-query form is mostly its loads and
// stores, 19 MB that four steps of codes in flight a thread do not stream
// at the full rate.
#include <atomic>

#include "common.cuh"

using mm::bf16;

namespace {

constexpr int K = 256;        // table entries per subvector
constexpr int BUCKET = 128;   // rows per bucket
constexpr int BMAX_NT = 1024; // bucket-max threads per block
constexpr int BMAX_WARPS = BMAX_NT / 32;
constexpr int RS_NT = 256;    // rescore threads per block, at most
constexpr size_t RS_GROUP_SMEM = 131072;  // shared-form tables of a query group, at most
constexpr int RS_GROUP_NT = 512;  // shared-form threads per block (all stage, some score)
constexpr int RS_GROUP_PER_SM = 1;  // shared-form blocks an SM (each stages its tables)
// steps whose codes a shared-form thread loads at once, before the tables
// are staged (a per-query run of 16 takes 64 more registers for as many
// steps: fewer blocks an SM, measured slower)
constexpr int HEAD_GROUP = 16;
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

// lets `kern` take every shared-memory size the device can hold (a larger
// request fails its launch)
inline cudaError_t allow_smem(const void* kern) {
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e == cudaSuccess ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most)
                          : e;
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
  static const cudaError_t attr = allow_smem(reinterpret_cast<const void*>(kern));
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

// ---------------------------------------------------------------------------
// B11: the rescore
// ---------------------------------------------------------------------------

// the k-th code byte of a run's words (a byte load leaves it alone in w[0])
template <int CW>
__device__ __forceinline__ uint32_t code_byte(const uint32_t (&w)[(CW + 3) / 4], int k) {
  return CW == 1 ? w[0] : (w[k / 4] >> (8 * (k % 4))) & 0xffu;
}

// The codes of the first HEAD steps of a run of RUN candidates from c (step
// j at c + j S, lane-major), loaded at once: they are in flight while the
// block stages its tables.
template <int RUN, int HEAD>
__device__ __forceinline__ void load_head(const int8_t* c, int m, int S,
                                          uint32_t (&w)[HEAD > 0 ? HEAD : 1][(RUN + 3) / 4]) {
#pragma unroll
  for (int u = 0; u < HEAD; ++u)
    if (u < m) load_codes<RUN>(c + static_cast<size_t>(u) * S, w[u]);
}

// Walks the m steps of the run in j order, each look(j, code byte,
// candidate): the head's codes first, then four steps' codes loaded before
// their lookups.
template <int RUN, int HEAD, typename Look>
__device__ __forceinline__ void walk_codes(const int8_t* c, int m, int S,
                                           const uint32_t (&head)[HEAD > 0 ? HEAD : 1][(RUN + 3) / 4],
                                           Look look) {
  constexpr int NW = (RUN + 3) / 4;
#pragma unroll
  for (int u = 0; u < HEAD; ++u)
    if (u < m)
#pragma unroll
      for (int r = 0; r < RUN; ++r) look(u, code_byte<RUN>(head[u], r), r);
  int j = HEAD;
  for (; j + 4 <= m; j += 4) {
    uint32_t w[4][NW];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_codes<RUN>(c + static_cast<size_t>(j + u) * S, w[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < RUN; ++r) look(j + u, code_byte<RUN>(w[u], r), r);
  }
  for (; j < m; ++j) {
    uint32_t w[NW];
    load_codes<RUN>(c + static_cast<size_t>(j) * S, w);
#pragma unroll
    for (int r = 0; r < RUN; ++r) look(j, code_byte<RUN>(w, r), r);
  }
}

// One query's table (row qi of each step j of tables (m, q, K)) -> shared
// [j][raw byte] bf16: entry b holds code b ^ 0x80 (int8 code c, table index
// c + 128). 16 bytes at a time where the tables are 16-byte aligned: a row's
// halves swap.
__device__ __forceinline__ void stage_query(const bf16* tables, unsigned char* smem, int m, int q,
                                            int qi) {
  if ((reinterpret_cast<uintptr_t>(tables) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(tables);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int e = threadIdx.x; e < m * (K / 8); e += blockDim.x) {
      const int j = e / (K / 8), c = e % (K / 8);
      dst[j * (K / 8) + (c ^ (K / 16))] = __ldg(src + (static_cast<size_t>(j) * q + qi) * (K / 8) + c);
    }
  } else {
    const unsigned short* src = reinterpret_cast<const unsigned short*>(tables);
    unsigned short* dst = reinterpret_cast<unsigned short*>(smem);
    for (int e = threadIdx.x; e < m * K; e += blockDim.x) {
      const int j = e / K, b = e % K;
      dst[j * K + (b ^ 0x80)] = __ldg(src + (static_cast<size_t>(j) * q + qi) * K + b);
    }
  }
}

// Per query: a thread scores RUN consecutive candidates of one query (codes
// in one 16- or 4-byte load a step, or a byte), a block a tile of them
// against its query's table in shared memory. codes: (q, m, S), or (1, m, S)
// with shared.
template <int RUN>
__global__ void __launch_bounds__(RS_NT)
    adc_rescore_kernel(const bf16* __restrict__ tables, const int8_t* __restrict__ codes,
                       const float* __restrict__ bias, float* __restrict__ out, int m, int q,
                       int S, int shared) {
  extern __shared__ __align__(16) unsigned char rs_raw[];
  const int qi = blockIdx.y;
  const long long s0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * RUN;
  const bool live = s0 < S;
  const size_t row = static_cast<size_t>(qi) * S + s0;
  const int8_t* c = codes + (shared ? 0 : static_cast<size_t>(qi) * m * S) + s0;
  float bv[RUN];
  if (live) mm::load_vals<RUN>(bias + row, bv);  // in flight while the table is staged
  stage_query(tables, rs_raw, m, q, qi);
  __syncthreads();
  if (!live) return;
  float acc[RUN];
#pragma unroll
  for (int r = 0; r < RUN; ++r) acc[r] = 0.f;
  const uint32_t no_head[1][(RUN + 3) / 4] = {};
  walk_codes<RUN, 0>(c, m, S, no_head, [&](int j, uint32_t b, int r) {
    acc[r] += bf_lo(*reinterpret_cast<const unsigned short*>(rs_raw + (j * K + b) * 2));
  });
#pragma unroll
  for (int r = 0; r < RUN; ++r) acc[r] += bv[r];
  mm::store_vals<RUN>(out + row, acc);
}

// A shared-form table's slot of raw byte b: its low three bits XORed with
// the next three, so that the staging's stores of 8 neighbouring entries
// fall in 8 different bank groups (a bijection on each step's 256 slots).
__device__ __forceinline__ uint32_t slot(uint32_t b) { return b ^ ((b >> 3) & 7u); }

// QC bf16 values (the low halves of h) as one entry of QC queries
template <int QC>
__device__ __forceinline__ void store_entry(unsigned char* dst, const uint32_t (&h)[QC]) {
  if constexpr (QC == 1) {
    *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(h[0]);
  } else {
    uint32_t w[QC / 2];
#pragma unroll
    for (int i = 0; i < QC / 2; ++i) w[i] = (h[2 * i] & 0xffffu) | (h[2 * i + 1] << 16);
    if constexpr (QC == 8) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (QC == 4) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    }
  }
}

// The tables of queries q0 .. q0 + qc - 1 -> shared [j][slot][QC] bf16
// (queries past qc are zero). 16-byte loads where the tables are aligned: a
// thread takes 8 neighbouring entries of one step for every query of the
// group and stores them entry by entry.
template <int QC>
__device__ __forceinline__ void stage_group(const bf16* tables, unsigned char* smem, int m, int q,
                                            int q0, int qc) {
  constexpr int STRIDE = QC * 2;
  if ((reinterpret_cast<uintptr_t>(tables) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(tables);
    for (int e = threadIdx.x; e < m * (K / 8); e += blockDim.x) {
      const int j = e / (K / 8), c = e % (K / 8);
      uint32_t u[QC][4];
#pragma unroll
      for (int p = 0; p < QC; ++p) {
        const uint4 v = p < qc ? __ldg(src + (static_cast<size_t>(j) * q + q0 + p) * (K / 8) + c)
                               : make_uint4(0, 0, 0, 0);
        u[p][0] = v.x;
        u[p][1] = v.y;
        u[p][2] = v.z;
        u[p][3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t h[QC];
#pragma unroll
        for (int p = 0; p < QC; ++p) h[p] = u[p][k / 2] >> (16 * (k % 2));
        store_entry<QC>(smem + (static_cast<size_t>(j) * K + slot((8 * c + k) ^ 0x80)) * STRIDE, h);
      }
    }
  } else {
    const unsigned short* src = reinterpret_cast<const unsigned short*>(tables);
    for (int e = threadIdx.x; e < m * K; e += blockDim.x) {
      const int j = e / K, b = e % K;
      uint32_t h[QC];
#pragma unroll
      for (int p = 0; p < QC; ++p)
        h[p] = p < qc ? __ldg(src + (static_cast<size_t>(j) * q + q0 + p) * K + b) : 0u;
      store_entry<QC>(smem + (static_cast<size_t>(j) * K + slot(b ^ 0x80)) * STRIDE, h);
    }
  }
}

// Shared form (codes (1, m, S), the same candidates for every query): a
// block stages the tables of a group of QC queries (blockIdx.y) once and
// walks runs of RUN candidates; each code byte is read once and looked up
// for the whole group with one QC-wide load.
template <int QC, int RUN>
__global__ void __launch_bounds__(RS_GROUP_NT)
    adc_rescore_shared_kernel(const bf16* __restrict__ tables, const int8_t* __restrict__ codes,
                              const float* __restrict__ bias, float* __restrict__ out, int m,
                              int q, int S) {
  extern __shared__ __align__(16) unsigned char rs_raw[];
  constexpr int STRIDE = QC * 2;
  const int q0 = blockIdx.y * QC;
  const int qc = q - q0 < QC ? q - q0 : QC;
  // the block's even share of the runs (RUN divides S), walked by its threads
  const long long runs = S / RUN;
  const long long share = (runs + gridDim.x - 1) / gridDim.x;
  const long long end = (blockIdx.x + 1) * share < runs ? (blockIdx.x + 1) * share : runs;
  long long r = blockIdx.x * share + threadIdx.x;
  float bv[QC][RUN];
  uint32_t head[HEAD_GROUP][(RUN + 3) / 4];
  // a run's bias and first codes; the block's first run's are in flight
  // while it stages the tables
  const auto load_run = [&](long long s0) {
#pragma unroll
    for (int p = 0; p < QC; ++p) {
      if (p < qc) {
        mm::load_vals<RUN>(bias + static_cast<size_t>(q0 + p) * S + s0, bv[p]);
      } else {
#pragma unroll
        for (int i = 0; i < RUN; ++i) bv[p][i] = 0.f;
      }
    }
    load_head<RUN, HEAD_GROUP>(codes + s0, m, S, head);
  };
  if (r < end) load_run(r * RUN);
  stage_group<QC>(tables, rs_raw, m, q, q0, qc);
  __syncthreads();
  for (bool first = true; r < end; r += blockDim.x, first = false) {
    const long long s0 = r * RUN;
    if (!first) load_run(s0);
    float acc[RUN][QC];
#pragma unroll
    for (int i = 0; i < RUN; ++i)
#pragma unroll
      for (int p = 0; p < QC; ++p) acc[i][p] = 0.f;
    walk_codes<RUN, HEAD_GROUP>(codes + s0, m, S, head, [&](int j, uint32_t b, int i) {
      lookup_add<QC>(rs_raw + (static_cast<size_t>(j) * K + slot(b)) * STRIDE, acc[i]);
    });
#pragma unroll
    for (int p = 0; p < QC; ++p) {
      if (p < qc) {
        float o[RUN];
#pragma unroll
        for (int i = 0; i < RUN; ++i) o[i] = acc[i][p] + bv[p][i];
        mm::store_vals<RUN>(out + static_cast<size_t>(q0 + p) * S + s0, o);
      }
    }
  }
}

template <int RUN>
int launch_rescore(const bf16* t, const int8_t* c, const float* b, float* o, int m, int q, int S,
                   int shared, cudaStream_t st) {
  auto kern = adc_rescore_kernel<RUN>;
  static const cudaError_t attr = allow_smem(reinterpret_cast<const void*>(kern));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // blocks of 256 threads, halved (down to 64) until the busiest SM holds
  // at most about 10% more blocks than the average
  const long long runs = (S + RUN - 1) / RUN;
  const long long sms = mm::sm_count();
  long long nt = RS_NT;
  for (; nt > 64; nt >>= 1) {
    const long long blocks = q * ((runs + nt - 1) / nt);
    if (blocks * 10 >= (blocks + sms - 1) / sms * sms * 9) break;
  }
  const dim3 grid(static_cast<unsigned>((runs + nt - 1) / nt), q);
  kern<<<grid, static_cast<unsigned>(nt), static_cast<size_t>(m) * K * 2, st>>>(t, c, b, o, m, q,
                                                                                  S, shared);
  return static_cast<int>(cudaGetLastError());
}

template <int QC, int RUN>
int launch_rescore_shared(const bf16* t, const int8_t* c, const float* b, float* o, int m, int q,
                          int S, cudaStream_t st) {
  auto kern = adc_rescore_shared_kernel<QC, RUN>;
  static const cudaError_t attr = allow_smem(reinterpret_cast<const void*>(kern));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // about one block an SM in all, each staging its group's tables once (all
  // its threads take part) and scoring an even share of the group's runs
  const int groups = (q + QC - 1) / QC;
  const long long runs = S / RUN;
  const long long per_group = (RS_GROUP_PER_SM * mm::sm_count() + groups - 1) / groups;
  const long long bx = runs < per_group ? runs : per_group;
  const size_t smem = static_cast<size_t>(m) * K * QC * 2;
  kern<<<dim3(static_cast<unsigned>(bx), groups), RS_GROUP_NT, smem, st>>>(
      t, c, b, o, m, q, S);
  return static_cast<int>(cudaGetLastError());
}

template <int QC>
int rescore_shared_by_layout(const bf16* t, const int8_t* c, const float* b, float* o, int m,
                             int q, int S, bool run4, cudaStream_t st) {
  if (run4) return launch_rescore_shared<QC, 4>(t, c, b, o, m, q, S, st);
  return launch_rescore_shared<QC, 1>(t, c, b, o, m, q, S, st);
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
  const bf16* t = static_cast<const bf16*>(tables);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // runs of 16 or 4 candidates where their codes, bias and scores are
  // aligned for 16- or 4-byte code loads and 16-byte f32 loads, else of 1
  const uintptr_t ca = reinterpret_cast<uintptr_t>(codes);
  const bool io16 = reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool run16 = io16 && S % 16 == 0 && ca % 16 == 0;
  const bool run4 = io16 && S % 4 == 0 && ca % 4 == 0;
  if (shared && q > 1) {
    // query groups of up to 8 whose tables fit RS_GROUP_SMEM
    int qc = q > 4 ? 8 : q > 2 ? 4 : 2;
    while (qc > 1 && static_cast<size_t>(m) * K * qc * 2 > RS_GROUP_SMEM) qc >>= 1;
    if (qc == 8) return rescore_shared_by_layout<8>(t, c, b, o, m, q, S, run4, st);
    if (qc == 4) return rescore_shared_by_layout<4>(t, c, b, o, m, q, S, run4, st);
    if (qc == 2) return rescore_shared_by_layout<2>(t, c, b, o, m, q, S, run4, st);
    return rescore_shared_by_layout<1>(t, c, b, o, m, q, S, run4, st);
  }
  // runs of 4 when runs of 16 would not give the grid two 64-thread blocks an SM (q 1)
  const long long blocks16 = static_cast<long long>(q) * ((S / 16 + 63) / 64);
  if (run16 && (blocks16 >= 2 * mm::sm_count() || !run4))
    return launch_rescore<16>(t, c, b, o, m, q, S, shared, st);
  if (run4) return launch_rescore<4>(t, c, b, o, m, q, S, shared, st);
  return launch_rescore<1>(t, c, b, o, m, q, S, shared, st);
}
