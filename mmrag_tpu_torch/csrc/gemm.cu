// K-gemm: C = epi(A . W + bias) [+ R], f32 accumulation.
//
// The matrix products of B1 (mmrag_tpu/ops/attention.py::_attn_block_kernel:
// the fused q|k|v projection and the output projection) and of B3
// (mmrag_tpu/ops/mlp.py::_mlp_kernel: fc1 with quick_gelu, fc2 with the
// residual). The TPU kernels held whole weight matrices resident in VMEM and
// kept every intermediate on chip; here each product is its own launch and
// its output goes through device memory.
//
// A (M, K) and W (K, N) are row-major in the stream dtype (W in the JAX
// (in, out) layout); bias is (N,) f32; R, when given, is (M, N) in the
// stream dtype and is added in f32 after the bias; C is the stream dtype or
// f32. epi 1 applies quick_gelu v / (1 + exp(-1.702 v)) in f32 (HF CLIP).
// The rounding points are those of the JAX kernels: f32 sums, bias,
// activation and residual in f32, one cast.
//
// Bound on an H100: operations. The CLIP fc1 at 7168 x 768 x 3072 is
// 33.8 GFLOP, 0.034 ms at 989 TFLOP/s bf16, against 4.7 MB of weights and
// 11 MB of activations (0.005 ms at 3.35 TB/s); the MiniLM q|k|v projection
// of the rerank at 65536 x 384 x 1152 is 58 GFLOP, 0.059 ms. The (rows,
// 3072) inner activation of B3 going through device memory costs 88 MB,
// 0.026 ms: the product rate, not that round trip, is what matters.
//
// bf16 design (Hopper's warpgroup products fed by the tensor memory
// accelerator). A persistent grid, one block a SM, walks 128 x 128 output
// tiles, N fastest: the blocks that share a row block of A run together, so
// A streams from device memory once and W stays in L2 (walking M fastest
// re-read the 50 MB A of the rerank's q|k|v projection once per column tile:
// 0.29 ms against 0.22). Warpgroup 0 is the producer: one thread keeps a
// ring of 6 K-slices of 64 in flight with TMA (A: one 64 x 128-row box, W:
// two 64-column x 64-row boxes, 32 KB a stage, 128-byte swizzle), signalling
// a "full" mbarrier per stage by transaction bytes; the ring holds a whole
// K of 384, so the next tile's loads run under this tile's epilogue.
// Warpgroups 1 and 2 each own 64 rows of the tile and run wgmma.mma_async
// m64n128k16 (bf16 in, f32 accumulate in registers) straight from the
// swizzled shared memory, keep one wgmma group in flight, and release a
// stage on its "empty" mbarrier once its group has retired. W stays in its
// (K, N) layout: N contiguous is the MN-major B operand (the transpose flag
// of wgmma; descriptor leading byte offset 8 KB between the two 64-column
// boxes, stride byte offset 1 KB between 8-row groups), so the weights,
// params_from_jax, the plain version and the f32 form keep one layout.
// Ragged M, N and K are zero-filled by TMA past the tensor's bounds; the
// stores are masked. The epilogue (bias, activation, residual, cast) runs on
// the accumulator registers and stores column pairs (4 or 8 bytes); the
// bias is loaded at the tile's start and every residual load is in flight
// before the last products retire. 256 x 128 tiles (two accumulators a
// warpgroup, setmaxnreg) measured no faster on these shapes and were
// dropped. TMA's 16-byte global strides need K % 8 == 0 and N % 8 == 0 and
// 16-byte-aligned A and W; the wrapper checks. The tensor maps are encoded
// on the host at every call (cuTensorMapEncodeTiled, fetched with
// cudaGetDriverEntryPoint: no -lcuda). The f32 form
// (TPU_COMPUTE_DTYPE=float32) is a plain FMA tile loop: full f32, no TF32.
//
// -Xptxas -v (CUDA 12.8, sm_90a): the bf16 kernel 155-156 registers, the
// f32 one 64 and 9 KB of static shared memory; no spills. chip_smoke.py's
// build phase prints the report.
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

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed shared memory
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 6;
constexpr int A_TILE = BM * BK * 2;  // 16 KB: 128 rows of 128 B
constexpr int W_BOX = BK * 64 * 2;   // 8 KB: 64 k-rows x 64 columns (128 B)
constexpr int STAGE = A_TILE + 2 * W_BOX;
constexpr int THREADS = 384;  // warpgroup 0 loads, 1 and 2 multiply
constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;  // + 1 KB alignment, mbarriers

// D (64 x 128, f32 registers) += A (64 x 16, K-major) . B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <typename To>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                     const bf16* __restrict__ R, To* __restrict__ C, int M, int N, int K,
                     int epi) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atom is 1 KB
  const uint32_t bars = base + STAGES * STAGE;                 // full[STAGES], empty[STAGES]
  // tiles walk N fastest: the CTAs that share a row block of A run together,
  // so A streams from device memory once and W stays in L2
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
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
          const uint32_t full = bars + 8 * s, a = base + s * STAGE, w = a + A_TILE;
          mbar_expect_tx(full, STAGE);
          tma_load(a, &map_a, full, kt * BK, m0);
          tma_load(w, &map_w, full, n0, kt * BK);
          tma_load(w + W_BOX, &map_w, full, n0 + 64, kt * BK);
        }
      }
    }
    return;
  }

  const int half = wg - 1;  // rows half * 64 .. + 63 of the tile
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[64];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    // accumulator i of this thread: row r0 (+ 8 for i % 4 >= 2), column
    // c0 + 8 (i / 4) (+ 1 for odd i)
    const int r0 = m0 + half * 64 + warp * 16 + lane / 4;
    const int c0 = n0 + (lane % 4) * 2;
    float2 bb[BN / 8];  // loaded now, used after the products
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      bb[j] = c0 + 8 * j < N ? *reinterpret_cast<const float2*>(bias + c0 + 8 * j)
                             : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(bars + 8 * s, (it / STAGES) & 1);
      const uint32_t a = base + s * STAGE + half * (64 * BK * 2), w = base + s * STAGE + A_TILE;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 k: 32 B along A's rows, 16 rows of W
        wgmma_m64n128k16(acc, smem_desc(a + kk * 32, 16, 1024),
                         smem_desc(w + kk * 16 * 128, W_BOX, 1024));
      wgmma_commit();
      if (kt > 0) {  // the previous stage's products have retired: release it
        wgmma_wait<1>();
        if (threadIdx.x % 128 == 0) mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
      }
    }
    // every residual load in flight before the last products retire and
    // before any store (one round trip a tile, not one a pair)
    uint32_t res[BN / 8][2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, c = c0 + 8 * j;
        res[j][h] = R != nullptr && r < M && c < N
                        ? *reinterpret_cast<const uint32_t*>(R + static_cast<size_t>(r) * N + c)
                        : 0u;
      }
    wgmma_wait<0>();
    fence_acc(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));

#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c >= N) continue;  // N % 8 == 0: c + 1 < N as well
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
        float v0 = acc[4 * j + 2 * h] + bb[j].x, v1 = acc[4 * j + 2 * h + 1] + bb[j].y;
        if (epi == 1) {
          v0 = v0 / (1.f + expf(-1.702f * v0));
          v1 = v1 / (1.f + expf(-1.702f * v1));
        }
        if (R != nullptr) {  // bf16 pair: low half is column c
          v0 += __uint_as_float(res[j][h] << 16);
          v1 += __uint_as_float(res[j][h] & 0xFFFF0000u);
        }
        store2(C + static_cast<size_t>(r) * N + c, v0, v1);
      }
    }
  }
}

template <typename Tr, typename To>
__device__ __forceinline__ void epilogue_store(float v, int gm, int gn, int N,
                                               const float* __restrict__ bias,
                                               const Tr* __restrict__ R, To* __restrict__ C,
                                               int epi) {
  v += bias[gn];
  if (epi == 1) v = v / (1.f + expf(-1.702f * v));
  const size_t off = static_cast<size_t>(gm) * N + gn;
  if (R != nullptr) v += mm::to_f(R[off]);
  C[off] = mm::from_f<To>(v);
}

// f32 x f32 -> f32 with plain FMAs: 256 threads, each a 4 x 4 sub-tile.
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                    const float* __restrict__ bias, const float* __restrict__ R,
                    float* __restrict__ C, int M, int N, int K, int epi) {
  __shared__ float As[FK][FM + 4];  // transposed: As[k][m]
  __shared__ float Ws[FK][FN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      const int r = e / FK, k = e % FK;
      const int gm = m0 + r, gk = k0 + k;
      As[k][r] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0.f;
      const int wk = e / FN, wc = e % FN;
      const int gk2 = k0 + wk, gn = n0 + wc;
      Ws[wk][wc] = (gk2 < K && gn < N) ? W[static_cast<size_t>(gk2) * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gm < M && gn < N) epilogue_store(acc[i][j], gm, gn, N, bias, R, C, epi);
    }
}


template <typename To>
int launch_bf16(const void* A, const void* W, const float* bias, const bf16* R, To* C, int M,
                int N, int K, int epi, cudaStream_t st) {
  CUtensorMap map_a, map_w;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!mm::tensor_map(&map_a, bf, 2, A, K, M, BK, BM) ||
      !mm::tensor_map(&map_w, bf, 2, W, N, K, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_bf16_kernel<To>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_bf16_kernel<To><<<grid, THREADS, SMEM, st>>>(map_a, map_w, bias, R, C, M, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dt: dtype of A, W and R (0 f32, 1 bf16); out_dt: dtype of C.
extern "C" int mm_gemm(void* A, void* W, void* bias, void* R, void* C, int M, int N, int K,
                       int dt, int out_dt, int epi, void* stream) {
  if (M < 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == mm::DT_BF16) {
    if (K % 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
    const float* b = static_cast<const float*>(bias);
    const bf16* r = static_cast<const bf16*>(R);
    if (out_dt == mm::DT_BF16)
      return launch_bf16<bf16>(A, W, b, r, static_cast<bf16*>(C), M, N, K, epi, st);
    if (out_dt == mm::DT_F32)
      return launch_bf16<float>(A, W, b, r, static_cast<float*>(C), M, N, K, epi, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dt == mm::DT_F32) {
    if (out_dt != mm::DT_F32) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    gemm_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(A), static_cast<const float*>(W),
        static_cast<const float*>(bias), static_cast<const float*>(R),
        static_cast<float*>(C), M, N, K, epi);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
