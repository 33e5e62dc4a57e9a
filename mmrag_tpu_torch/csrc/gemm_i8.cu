// K-gemm-i8: C = epi(((Aq . Wq) * row_scale) * col_scale + bias) [+ R].
//
// The int8 products of B6 (mmrag_tpu/ops/attention.py::_attn_block_kernel_q8:
// the q|k|v projection and the output projection) and of B7
// (mmrag_tpu/ops/mlp.py::_mlp_kernel_q8: fc1 with its activation, fc2 with
// the residual), in the scheme of mmrag_tpu/ops/quant.py: per-row int8
// activations Aq (M, K) with an f32 scale a row, per-output-channel int8
// weights with an f32 scale a column. The int8 x int8 -> int32 sum is exact.
// The epilogue keeps the JAX kernels' order and rounding points, each step
// rounded on its own (__fmul_rn / __fadd_rn: no contraction into an FMA):
// ((float(acc) * row_scale) * col_scale) + bias, then the activation in f32
// (none, quick_gelu, gelu_tanh, gelu_erf), then + R in f32 (R is the
// residual stream, bf16 or f32), one cast to the output dtype (bf16 or f32).
//
// Bound on an H100: bytes or operations, by shape. The cross-encoder's
// q|k|v product at 65536 x 384 -> 1152 is 58 G int8 ops, 0.029 ms at 1,979
// TOPS, against 25 MB of codes in and 151 MB of bf16 out, 0.053 ms at 3.35
// TB/s: bytes bound it; B7's CLIP fc1 at 7168 x 768 x 3072 is 33.8 G ops,
// 0.017 ms, against 2.4 MB of weights. With an activation the epilogue's
// f32 transcendentals, on the SIMT cores, can cost more than the product.
//
// Design (Hopper's warpgroup products fed by the tensor memory accelerator,
// the skeleton of the bf16 K-gemm in gemm.cu). A persistent grid, one block
// a SM, walks 128 x 128 output tiles, N fastest (the blocks that share a row
// block of A run together, so A streams from device memory once). Warpgroup
// 0 is the producer: one thread keeps a ring of 5 K-slices of 128 bytes (one
// 128-byte swizzle row) in flight with TMA, 16 KB of A and 16 KB of W a
// stage, signalling a "full" mbarrier per stage by transaction bytes; it
// gives registers back (setmaxnreg 40). Warpgroups 1 and 2 (setmaxnreg 232)
// each own 64 rows of the tile and run wgmma.mma_async m64n128k32 s8 x s8 ->
// s32 from the swizzled shared memory, 4 products a stage, with the int32
// accumulators in registers; they keep one wgmma group in flight and release
// a stage on its "empty" mbarrier once its group has retired. For .s8,
// wgmma reads both operands K-major only (the transpose flags exist for f16
// and bf16 alone), so W is stored N x K: the wrapper takes the (in, out)
// weight as the (K, N) view of an (N, K) contiguous buffer, strides (1, K)
// (ops/quant.py::quantize_weight gives that layout; torch._int_mm wants it
// too) and raises on any other. Both operands are then the same box: 128
// rows of 128 bytes, descriptor stride byte offset 1 KB between 8-row groups,
// the start advanced 32 bytes a k32 product.
//
// The epilogue runs on the accumulator registers: the row scales, column
// scales and bias are loaded at the tile's start, every residual load is in
// flight before the last products retire, and each warpgroup writes its 64 x
// 128 result into shared memory in the 128-byte swizzle of 128-byte-wide TMA
// boxes, then one thread stores the boxes with TMA (cp.async.bulk.tensor,
// clipped at M and N) while the warpgroup goes on to the next tile's
// products: on an H100 the direct pair stores from the registers cost more
// than the tile's products at the rerank's K = 384. Each activation,
// residual type and output type is its own instance: with the activation
// chosen at run time, the unrolled epilogue inlined every activation 64
// times and took most of a tile's time. Ragged M, N
// and K are zero-filled by TMA past the tensors' bounds (a zero code adds 0
// to the exact sum). TMA's 16-byte strides need K % 16 == 0 and N % 16 == 0;
// the wrapper checks both and 16-byte-aligned bases. M = 0 launches nothing.
//
// -Xptxas -v (CUDA 12.8, sm_90a): every instance 168 registers at entry (the
// setmaxnreg split moves them to the consumers), no spills, 16 named
// barriers; chip_smoke.py's build phase prints the report.
#include <type_traits>

#include "common.cuh"

using mm::bf16;
using mm::fence_acc;
using mm::mbar_arrive;
using mm::mbar_expect_tx;
using mm::mbar_init;
using mm::mbar_wait;
using mm::sm_count;
using mm::smem_desc;
using mm::smem_u32;
using mm::store2;
using mm::tma_load;
using mm::wgmma_commit;
using mm::wgmma_fence;
using mm::wgmma_wait;

namespace {

constexpr int BM = 128, BN = 128, BK = 128, STAGES = 5;  // BK in int8 elements (bytes)
constexpr int TILE = BM * BK;                             // 16 KB: 128 rows of 128 B
constexpr int STAGE = 2 * TILE;                           // A rows, then W rows (N)
constexpr int THREADS = 384;  // warpgroup 0 loads, 1 and 2 multiply
constexpr int OUT_BOX = 64 * 128;  // 8 KB: 64 output rows of 128 B (one swizzle row)
// the ring, each consumer warpgroup's 64 x 128 output tile (To is 2 or 4
// bytes: that many 128-byte boxes), 1 KB of alignment slack, the mbarriers
template <typename To>
constexpr int smem_bytes() {
  return STAGES * STAGE + 2 * static_cast<int>(sizeof(To)) * OUT_BOX + 1024 + 2 * STAGES * 8;
}

// the TMA store of one 128-byte-wide box of the output tile from shared
// memory, and the waits on this thread's bulk groups
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // the sources may be overwritten
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {  // the writes are done
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the 128 threads of one consumer warpgroup (named barrier 1 or 2)
__device__ __forceinline__ void warpgroup_sync(int half) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
}

enum { EPI_NONE = 0, EPI_QUICK_GELU = 1, EPI_GELU_TANH = 2, EPI_GELU_ERF = 3 };

template <int EPI>
__device__ __forceinline__ float activation(float v) {
  if constexpr (EPI == EPI_QUICK_GELU) return v / (1.f + expf(-1.702f * v));
  if constexpr (EPI == EPI_GELU_TANH) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanhf(inner));
  }
  if constexpr (EPI == EPI_GELU_ERF) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  return v;
}

// the residual: none, or a bf16 or f32 stream; a column pair is held as
// loaded (a bf16 pair in 32 bits, or two floats) until the epilogue widens it
struct NoResidual {};
__device__ __forceinline__ uint32_t load_pair(const NoResidual*) { return 0u; }
__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 widen(uint32_t u) {  // low half is the first column
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}
__device__ __forceinline__ float2 widen(float2 v) { return v; }

// D (64 x 128, s32 registers) += A (64 x 32, K-major) . B (32 x 128, K-major)
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// one instance per activation, residual type and output type: the epilogue
// is unrolled over the 64 accumulators, so a runtime choice would inline
// every activation 64 times (measured: the epilogue then took 85% of the
// q|k|v product's time)
template <int EPI, typename Tr, typename To>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_i8_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_c, const float* __restrict__ row_scale,
                   const float* __restrict__ col_scale, const float* __restrict__ bias,
                   const Tr* __restrict__ R, int M, int N, int K) {
  constexpr bool kRes = !std::is_same<Tr, NoResidual>::value;
  constexpr int kBoxes = sizeof(To);           // 128-byte boxes across a tile's 128 columns
  constexpr int kBoxCols = 128 / sizeof(To);  // columns of one box
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atom is 1 KB
  unsigned char* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t out = base + STAGES * STAGE;              // the two warpgroups' output tiles
  const uint32_t bars = out + 2 * kBoxes * OUT_BOX;        // full[STAGES], empty[STAGES]
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);             // the producer's arrive + the bytes
      mbar_init(bars + 8 * (STAGES + s), 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
          const uint32_t full = bars + 8 * s, a = base + s * STAGE;
          mbar_expect_tx(full, STAGE);
          tma_load(a, &map_a, full, kt * BK, m0);
          tma_load(a + TILE, &map_w, full, kt * BK, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1;  // rows half * 64 .. + 63 of the tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    int acc[64];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
      // accumulator i of this thread: row r0 (+ 8 for i % 4 >= 2), column
      // c0 + 8 (i / 4) (+ 1 for odd i)
      const int r0 = m0 + half * 64 + warp * 16 + lane / 4;
      const int c0 = n0 + (lane % 4) * 2;
      float rs[2];  // loaded now, used after the products
      float2 cs[BN / 8], bb[BN / 8];
#pragma unroll
      for (int h = 0; h < 2; ++h) rs[h] = r0 + 8 * h < M ? row_scale[r0 + 8 * h] : 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const bool in = c0 + 8 * j < N;
        cs[j] = in ? *reinterpret_cast<const float2*>(col_scale + c0 + 8 * j)
                   : make_float2(0.f, 0.f);
        bb[j] = in ? *reinterpret_cast<const float2*>(bias + c0 + 8 * j) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(bars + 8 * s, (it / STAGES) & 1);
        const uint32_t a = base + s * STAGE + half * (64 * BK), w = base + s * STAGE + TILE;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)  // 32 k: 32 B along the rows of A and of W
          wgmma_m64n128k32_s8(acc, smem_desc(a + kk * 32, 16, 1024),
                              smem_desc(w + kk * 32, 16, 1024));
        wgmma_commit();
        if (kt > 0) {  // the previous stage's products have retired: release it
          wgmma_wait<1>();
          if (threadIdx.x % 128 == 0) mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
        }
      }
      // every residual load in flight before the last products retire and
      // before any store (one round trip a tile, not one a pair)
      decltype(load_pair(R)) res[BN / 8][2];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, c = c0 + 8 * j;
          res[j][h] = kRes && r < M && c < N ? load_pair(R + static_cast<size_t>(r) * N + c)
                                             : decltype(load_pair(R)){};
        }
      wgmma_wait<0>();
      fence_acc(acc);
      if (threadIdx.x % 128 == 0) {
        mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
        bulk_wait_read();  // the previous tile's stores have read this output tile
      }
      warpgroup_sync(half);

      // the values go to this warpgroup's output tile in shared memory, in
      // the TMA boxes' 128-byte swizzle (16-byte chunk ^ row % 8: the 8 rows
      // a warp writes at once fall in 8 distinct chunks); one TMA store a box
      // then writes them out, clipped at M and N, while the next tile's
      // products run
      const uint32_t tile_out = out + half * kBoxes * OUT_BOX;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), rs[h]), cs[j].x);
          float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i + 1]), rs[h]), cs[j].y);
          v0 = activation<EPI>(__fadd_rn(v0, bb[j].x));
          v1 = activation<EPI>(__fadd_rn(v1, bb[j].y));
          if constexpr (kRes) {
            const float2 rv = widen(res[j][h]);
            v0 = __fadd_rn(v0, rv.x);
            v1 = __fadd_rn(v1, rv.y);
          }
          const int row = warp * 16 + lane / 4 + 8 * h, col = (lane % 4) * 2 + 8 * j;
          const int byte = (col % kBoxCols) * static_cast<int>(sizeof(To));
          const uint32_t at = tile_out + (col / kBoxCols) * OUT_BOX + row * 128 +
                              ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
          store2(reinterpret_cast<To*>(base_ptr + (at - base)), v0, v1);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
      warpgroup_sync(half);
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          tma_store(&map_c, tile_out + b * OUT_BOX, n0 + b * kBoxCols, m0 + half * 64);
        bulk_commit();
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

template <int EPI, typename Tr, typename To>
int launch(const void* A, const void* rs, const void* W, const void* cs, const void* bias,
           const void* R, void* C, int M, int N, int K, cudaStream_t st) {
  CUtensorMap map_a, map_w, map_c;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // the bytes of the int8 codes
  const CUtensorMapDataType tc = sizeof(To) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!mm::tensor_map(&map_a, u8, 1, A, K, M, BK, BM) ||
      !mm::tensor_map(&map_w, u8, 1, W, K, N, BK, BN) ||
      !mm::tensor_map(&map_c, tc, sizeof(To), C, N, M, 128 / sizeof(To), 64))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<To>();
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_i8_kernel<EPI, Tr, To>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_i8_kernel<EPI, Tr, To><<<grid, THREADS, smem, st>>>(
      map_a, map_w, map_c, static_cast<const float*>(rs), static_cast<const float*>(cs),
      static_cast<const float*>(bias), static_cast<const Tr*>(R), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI, typename Tr>
int by_out(int out_dt, const void* A, const void* rs, const void* W, const void* cs,
           const void* bias, const void* R, void* C, int M, int N, int K, cudaStream_t st) {
  if (out_dt == mm::DT_F32) return launch<EPI, Tr, float>(A, rs, W, cs, bias, R, C, M, N, K, st);
  if (out_dt == mm::DT_BF16) return launch<EPI, Tr, bf16>(A, rs, W, cs, bias, R, C, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int EPI>
int by_residual(const void* R, int r_dt, int out_dt, const void* A, const void* rs,
                const void* W, const void* cs, const void* bias, void* C, int M, int N, int K,
                cudaStream_t st) {
  if (R == nullptr) return by_out<EPI, NoResidual>(out_dt, A, rs, W, cs, bias, R, C, M, N, K, st);
  if (r_dt == mm::DT_BF16) return by_out<EPI, bf16>(out_dt, A, rs, W, cs, bias, R, C, M, N, K, st);
  if (r_dt == mm::DT_F32) return by_out<EPI, float>(out_dt, A, rs, W, cs, bias, R, C, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// A: (M, K) int8 row-major, row_scale: (M,) f32; W: the (N, K) int8 buffer
// (row n holds output column n's K codes), col_scale and bias: (N,) f32;
// R: (M, N) of r_dt or null; C: (M, N) of out_dt. epi 0 none, 1 quick_gelu,
// 2 gelu_tanh, 3 gelu_erf.
extern "C" int mm_gemm_i8(void* A, void* row_scale, void* W, void* col_scale, void* bias,
                          void* R, int r_dt, void* C, int out_dt, int M, int N, int K, int epi,
                          void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || K % 16 || N % 16 || epi < 0 || epi > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case EPI_NONE:
      return by_residual<EPI_NONE>(R, r_dt, out_dt, A, row_scale, W, col_scale, bias, C, M, N,
                                   K, st);
    case EPI_QUICK_GELU:
      return by_residual<EPI_QUICK_GELU>(R, r_dt, out_dt, A, row_scale, W, col_scale, bias, C,
                                         M, N, K, st);
    case EPI_GELU_TANH:
      return by_residual<EPI_GELU_TANH>(R, r_dt, out_dt, A, row_scale, W, col_scale, bias, C,
                                        M, N, K, st);
    default:
      return by_residual<EPI_GELU_ERF>(R, r_dt, out_dt, A, row_scale, W, col_scale, bias, C,
                                       M, N, K, st);
  }
}
