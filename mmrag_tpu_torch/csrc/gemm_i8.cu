// K-gemm-i8: C = epi(((Aq . Wq) * row_scale) * col_scale + bias) [+ R].
//
// The int8 products of B6 (mmrag_tpu/ops/attention.py::_attn_block_kernel_q8:
// the q|k|v projection and the output projection) and of B7
// (mmrag_tpu/ops/mlp.py::_mlp_kernel_q8: fc1 with its activation, fc2 with
// the residual), in the scheme of mmrag_tpu/ops/quant.py: per-row int8
// activations Aq (M, K) with an f32 scale a row, per-output-channel int8
// weights Wq (K, N) (the JAX (in, out) layout, row-major) with an f32 scale
// a column. The int8 x int8 -> int32 sum is exact. The epilogue keeps the
// JAX kernels' order and rounding points, each step rounded on its own
// (__fmul_rn / __fadd_rn: no contraction into an FMA):
// ((float(acc) * row_scale) * col_scale) + bias, then the activation in f32
// (none, quick_gelu, gelu_tanh, gelu_erf), then + R in f32 (R is the
// residual stream, bf16 or f32), one cast to the output dtype (bf16 or f32).
//
// Bound on an H100: operations. B7's CLIP fc1 at 7168 x 768 x 3072 is 33.8
// G int8 ops, 17 us at 1,979 TOPS; the weights are 2.4 MB. The products run
// on the int8 tensor cores through WMMA (s8 16x16x16, int32 accumulate) on
// 64 x 64 block tiles with a 64-deep, cp.async double-buffered k loop. In
// shared memory each operand tile is stored in 16-byte-wide k (A) or n (W)
// slabs, so every fragment pointer is 32-byte aligned and every fragment row
// is one 16-byte line. The epilogue runs from a shared-memory copy of the
// int32 tile. wgmma s8 with TMA, and keeping B7's inner tile on chip, are
// later work. Requires K % 16 == 0 and N % 16 == 0; the wrapper checks.
#include <mma.h>

#include "common.cuh"

using mm::bf16;
using mm::cp_async16;
using mm::cp_async_commit;
using mm::cp_async_wait;
using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 64;  // BK in int8 elements (bytes)
constexpr int SL = 16;                    // slab width: one 16-byte line
constexpr int CP = BN + 4;                // smem row pitch of the int32 result tile

enum { EPI_NONE = 0, EPI_QUICK_GELU = 1, EPI_GELU_TANH = 2, EPI_GELU_ERF = 3 };

__device__ __forceinline__ float activation(float v, int epi) {
  if (epi == EPI_QUICK_GELU) return v / (1.f + expf(-1.702f * v));
  if (epi == EPI_GELU_TANH) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanhf(inner));
  }
  if (epi == EPI_GELU_ERF) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  return v;
}

template <typename Tr, typename To>
__global__ void __launch_bounds__(128)
    gemm_i8_kernel(const int8_t* __restrict__ A, const float* __restrict__ row_scale,
                   const int8_t* __restrict__ W, const float* __restrict__ col_scale,
                   const float* __restrict__ bias, const Tr* __restrict__ R,
                   To* __restrict__ C, int M, int N, int K, int epi) {
  // As[buf][k slab][row][16], Ws[buf][n slab][k][16]
  __shared__ __align__(128) int8_t As[2][BK / SL][BM][SL];
  __shared__ __align__(128) int8_t Ws[2][BN / SL][BK][SL];
  __shared__ __align__(128) int Cs[BM * CP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  auto load_tiles = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128;  // 256 16-byte chunks per tile
      // A tile: 64 rows x 4 chunks (neighbouring threads read one row)
      const int ar = c >> 2, ak = c & 3;
      const int gm = m0 + ar, gk = k0 + ak * SL;
      const bool pa = gm < M && gk < K;
      cp_async16(&As[buf][ak][ar][0], pa ? A + static_cast<size_t>(gm) * K + gk : A, pa);
      // W tile: 64 k-rows x 4 chunks of 16 columns
      const int wr = c >> 2, wc = c & 3;
      const int gk2 = k0 + wr, gn = n0 + wc * SL;
      const bool pw = gk2 < K && gn < N;
      cp_async16(&Ws[buf][wc][wr][0], pw ? W + static_cast<size_t>(gk2) * N + gn : W, pw);
    }
    cp_async_commit();
  };

  const int nk = (K + BK - 1) / BK;
  load_tiles(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_tiles(buf ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / SL; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], reinterpret_cast<const signed char*>(&As[buf][ks][wm + i * 16][0]), SL);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], reinterpret_cast<const signed char*>(&Ws[buf][(wn >> 4) + j][ks * SL][0]), SL);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + i * 16) * CP + wn + j * 16], acc[i][j], CP,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += 128) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float v = static_cast<float>(Cs[r * CP + c]);
    v = __fmul_rn(v, row_scale[gm]);
    v = __fmul_rn(v, col_scale[gn]);
    v = __fadd_rn(v, bias[gn]);
    v = activation(v, epi);
    const size_t off = static_cast<size_t>(gm) * N + gn;
    if (R != nullptr) v = __fadd_rn(v, mm::to_f(R[off]));
    C[off] = mm::from_f<To>(v);
  }
}

template <typename Tr, typename To>
int launch(const void* A, const void* rs, const void* W, const void* cs, const void* bias,
           const void* R, void* C, int M, int N, int K, int epi, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<Tr, To><<<grid, 128, 0, st>>>(
      static_cast<const int8_t*>(A), static_cast<const float*>(rs),
      static_cast<const int8_t*>(W), static_cast<const float*>(cs),
      static_cast<const float*>(bias), static_cast<const Tr*>(R), static_cast<To*>(C), M, N, K,
      epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tr>
int by_out(int out_dt, const void* A, const void* rs, const void* W, const void* cs,
           const void* bias, const void* R, void* C, int M, int N, int K, int epi,
           cudaStream_t st) {
  if (out_dt == mm::DT_F32) return launch<Tr, float>(A, rs, W, cs, bias, R, C, M, N, K, epi, st);
  if (out_dt == mm::DT_BF16) return launch<Tr, bf16>(A, rs, W, cs, bias, R, C, M, N, K, epi, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// A: (M, K) int8, row_scale: (M,) f32; W: (K, N) int8, col_scale and bias:
// (N,) f32; R: (M, N) of r_dt or null; C: (M, N) of out_dt. epi 0 none,
// 1 quick_gelu, 2 gelu_tanh, 3 gelu_erf.
extern "C" int mm_gemm_i8(void* A, void* row_scale, void* W, void* col_scale, void* bias,
                          void* R, int r_dt, void* C, int out_dt, int M, int N, int K, int epi,
                          void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || K % 16 || N % 16 || epi < 0 || epi > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r_dt == mm::DT_BF16) {
    return by_out<bf16>(out_dt, A, row_scale, W, col_scale, bias, R, C, M, N, K, epi, st);
  }
  if (r_dt == mm::DT_F32) {
    return by_out<float>(out_dt, A, row_scale, W, col_scale, bias, R, C, M, N, K, epi, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
