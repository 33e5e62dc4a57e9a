// Shared helpers for the port's hand-written Hopper kernels.
//
// Every source in this directory is compiled on its own into a shared
// library with a plain C interface (nvcc -gencode arch=compute_90a,
// code=sm_90a -shared) and loaded with ctypes by mmrag_tpu_torch/ops/kernels.py.
// Each C entry launches on the stream it is given and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mm {

typedef __nv_bfloat16 bf16;

// dtype codes shared with the Python side
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, the rounding of jnp's astype(bfloat16)
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; pred false reads 0 source bytes and
// zero-fills the 16 shared bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N values from p as f32, in the widest loads N allows (16 bytes, 8, or one value)
template <int N>
__device__ __forceinline__ void load_vals(const bf16* p, float (&f)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + k);
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[8 * k + 2 * i] = __uint_as_float(u[i] << 16);
        f[8 * k + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    }
  } else if constexpr (N == 4) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    f[0] = __uint_as_float(w.x << 16);
    f[1] = __uint_as_float(w.x & 0xffff0000u);
    f[2] = __uint_as_float(w.y << 16);
    f[3] = __uint_as_float(w.y & 0xffff0000u);
  } else {
    static_assert(N == 1, "bf16 values come 8, 4 or 1 at a time");
    f[0] = __bfloat162float(p[0]);
  }
}
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(p) + k);
      f[4 * k] = w.x;
      f[4 * k + 1] = w.y;
      f[4 * k + 2] = w.z;
      f[4 * k + 3] = w.w;
    }
  } else {
    static_assert(N == 1, "f32 values come 4k or 1 at a time");
    f[0] = __ldg(p);
  }
}

// N values to p, rounded once to the output type, in the widest stores N allows
template <int N>
__device__ __forceinline__ void store_vals(bf16* p, const float (&f)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[8 * k + 2 * i], f[8 * k + 2 * i + 1]);
      reinterpret_cast<uint4*>(p)[k] = *reinterpret_cast<const uint4*>(h);
    }
  } else if constexpr (N == 4) {
    const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(f[0], f[1]), __floats2bfloat162_rn(f[2], f[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  } else {
    static_assert(N == 1, "bf16 values go 8k, 4 or 1 at a time");
    p[0] = __float2bfloat16_rn(f[0]);
  }
}
template <int N>
__device__ __forceinline__ void store_vals(float* p, const float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
  } else {
    static_assert(N == 1, "f32 values go 4k or 1 at a time");
    p[0] = f[0];
  }
}

// two adjacent outputs: a bf16 pair (round to nearest even) or a float2
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------------------
// Hopper: mbarriers, TMA and wgmma (K-gemm and K-gemm-i8)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!ok);
}
// one 2-D box from the tensor behind `map` at (c0 inner, c1 outer), counted
// on the mbarrier `bar` by its bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start, leading and
// stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator uses across an async product
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched at run time (no link against libcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a row-major (outer, inner) matrix of `elem_bytes`-byte elements read in
// (box_outer, box_inner) boxes, 128-byte swizzle, zeros past its bounds
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                       const void* ptr, int inner, int outer, int box_inner, int box_outer) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// streaming multiprocessors of the current device (persistent grids)
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace mm

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
