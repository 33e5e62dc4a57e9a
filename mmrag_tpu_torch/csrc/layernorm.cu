// K-ln: out = LayerNorm(x [+ delta]) per row, f32 statistics; and K-quant:
// per-row symmetric int8 of x, or of LayerNorm(x), with its f32 row scale.
//
// Replaces mmrag_tpu/ops/layernorm.py::_add_ln_kernel (B2), and is the LN
// step of the B1 and B3 compositions. The TPU kernel tiled 1024 rows through
// VMEM and fell back to plain jnp on shapes that did not tile (rows % 8,
// h % 128); here one warp owns one row, keeps it in registers (h <= 1024,
// 32 values a lane), and masks the ragged edge itself, so every shape runs
// the kernel.
//
// Bound on an H100: bytes. LN(x + delta) at 4096 x 384 bf16 moves
// 3 x 4096 x 384 x 2 B = 9.4 MB, 2.8 us at 3.35 TB/s; it does 10 flops a
// value, far below the 295 flop/byte ridge. The design reads each input
// once with lane-contiguous (coalesced) loads, reduces mean and variance with
// warp shuffles (two passes over registers, as jnp.mean(square(x - mean))
// does), and writes each output once.
//
// K-quant is the activation quantizer of B6 and B7
// (mmrag_tpu/ops/attention.py::_attn_block_kernel_q8,
// mmrag_tpu/ops/mlp.py::_mlp_kernel_q8, both through
// mmrag_tpu/ops/quant.py::quantize_rows): scale = max(amax(|a|) * (1/127),
// 1e-12), q = round(a / scale) to int8, with the f32 LayerNorm of the
// pre-LN blocks computed first in the same registers. The codes are those of
// quantize_rows bit for bit: the IEEE quotient a / scale (no division
// instruction: a correctly rounded reciprocal and two FMA corrections, see
// quotient()), rounded half to even (as jnp.round and torch.round).
//
// Bound on an H100: bytes. 65536 x 384 bf16 in, int8 out is 76 MB, 23 us at
// 3.35 TB/s; 65536 x 1536 f32 is 503 MB, 150 us. The work a value is small
// but not free (an IEEE division is a multi-instruction routine), so the
// kernel is bound by instruction rate and latency unless each instruction
// moves many bytes. Every load is 16 bytes (8 bf16 or 4 f32 values); L
// lanes own a row (16 for a 384-wide bf16 row, 32 from 768 values up: a
// warp holds 2 or 1 rows) and each lane keeps V vectors, L and V fixed per
// width class so that no register slot is dead at the path's widths; the
// codes leave as packed 8- or 4-byte words; the amax is a shuffle tree over
// the row's lanes; and a value costs a multiply, four FMAs and an add (the
// quotient and its rounding). Widths or addresses the 16-byte loads cannot
// take (h % (16 / itemsize), unaligned views) run the same kernel with
// scalar loads.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kMaxPerLane = 32;   // h <= 32 * 32 = 1024

template <typename Tx, typename Td, typename To>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    add_ln_kernel(const Tx* __restrict__ x, const Td* __restrict__ d,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  To* __restrict__ out, int rows, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * h;
  float v[kMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + i * 32;
    float t = 0.f;
    if (c < h) {
      t = mm::to_f(x[base + c]);
      if (d != nullptr) t += mm::to_f(d[base + c]);
    }
    v[i] = t;
    s += t;
  }
  const float mean = mm::warp_sum(s) / static_cast<float>(h);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < h) {
      const float dv = v[i] - mean;
      q += dv * dv;
    }
  }
  const float var = mm::warp_sum(q) / static_cast<float>(h);
  const float r = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < h) out[base + c] = mm::from_f<To>((v[i] - mean) * r * scale[c] + bias[c]);
  }
}

template <typename Tx, typename Td, typename To>
void launch(const void* x, const void* d, const void* scale, const void* bias, void* out,
            int rows, int h, float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  add_ln_kernel<Tx, Td, To><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const Tx*>(x), static_cast<const Td*>(d),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<To*>(out), rows, h, eps);
}

template <typename Tx, typename Td>
bool dispatch_out(int out_dt, const void* x, const void* d, const void* scale,
                  const void* bias, void* out, int rows, int h, float eps,
                  cudaStream_t stream) {
  if (out_dt == mm::DT_F32) {
    launch<Tx, Td, float>(x, d, scale, bias, out, rows, h, eps, stream);
  } else if (out_dt == mm::DT_BF16) {
    launch<Tx, Td, bf16>(x, d, scale, bias, out, rows, h, eps, stream);
  } else {
    return false;
  }
  return true;
}

template <typename Tx>
bool dispatch_delta(int d_dt, int out_dt, const void* x, const void* d, const void* scale,
                    const void* bias, void* out, int rows, int h, float eps,
                    cudaStream_t stream) {
  if (d_dt == mm::DT_F32) {
    return dispatch_out<Tx, float>(out_dt, x, d, scale, bias, out, rows, h, eps, stream);
  }
  if (d_dt == mm::DT_BF16) {
    return dispatch_out<Tx, bf16>(out_dt, x, d, scale, bias, out, rows, h, eps, stream);
  }
  return false;
}

// f32(1/127) as the JAX package forms it: the double 1/127 rounded to f32
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr int kQuantThreads = 256;  // 8 warps a block

// VEC values of a row from one 16-byte load (VEC 1: a scalar load)
template <typename Tx, int VEC>
__device__ __forceinline__ void load_vec(const Tx* p, float (&f)[VEC]);
template <>
__device__ __forceinline__ void load_vec<bf16, 8>(const bf16* p, float (&f)[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float (&f)[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = w.x;
  f[1] = w.y;
  f[2] = w.z;
  f[3] = w.w;
}
template <>
__device__ __forceinline__ void load_vec<bf16, 1>(const bf16* p, float (&f)[1]) {
  f[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float (&f)[1]) {
  f[0] = __ldg(p);
}

// f32 LayerNorm vectors at the VEC columns from c
template <int VEC>
__device__ __forceinline__ void load_cols(const float* p, float (&f)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(p + i));
      f[i] = w.x;
      f[i + 1] = w.y;
      f[i + 2] = w.z;
      f[i + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __ldg(p + i);
  }
}

// sum / max over the L lanes of a row (L divides 32; every lane takes part)
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The IEEE quotient a / sc without a division: y = RN(1/sc) is given, and
// a * y is within 1.5 ulps of a / sc. One FMA correction (the residual
// a - q * sc is exact in an FMA) makes it faithful; a second one, from a
// faithful q and a correctly rounded reciprocal, gives the correctly rounded
// quotient (Markstein's theorem). Both need the residual above the subnormal
// range, which holds wherever |a / sc| >= 0.25 (sc >= 1e-12); below that the
// code is 0 either way.
__device__ __forceinline__ float quotient(float a, float sc, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-q, sc, a), y, q);
  return __fmaf_rn(__fmaf_rn(-q, sc, a), y, q);
}

// the int8 code of q (|q| <= 128) in the low byte: adding 1.5 * 2^23 rounds
// to an integer half to even (the sum's ulp is 1), and the float's low byte
// is then that integer's two's-complement byte
__device__ __forceinline__ uint32_t code_bits(float q) {
  return __float_as_uint(__fadd_rn(q, 12582912.0f));
}

// VEC codes (low bytes of b) stored as one packed word or byte
template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* p, const uint32_t (&b)[VEC]) {
  if constexpr (VEC == 1) {
    *p = static_cast<int8_t>(b[0] & 0xffu);
  } else {
    uint32_t w[VEC / 4];
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      w[i] = __byte_perm(__byte_perm(b[4 * i], b[4 * i + 1], 0x0040),
                         __byte_perm(b[4 * i + 2], b[4 * i + 3], 0x0040), 0x5410);
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

// L lanes own a row (32 / L rows a warp); lane g of a row loads the VEC-value
// vectors g, g + L, ..., g + (V - 1) L, so each load instruction of a warp
// reads contiguous 16-byte runs, and V is the width class's own count.
template <typename Tx, int VEC, int L, int V, bool LN>
__global__ void __launch_bounds__(kQuantThreads)
    row_quant_kernel(const Tx* __restrict__ x, const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias, int8_t* __restrict__ q,
                     float* __restrict__ qscale, int rows, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const int g = lane % L;
  const int row = (blockIdx.x * (kQuantThreads / 32) + (threadIdx.x >> 5)) * (32 / L) + lane / L;
  const bool live = row < rows;  // dead rows still take part in the shuffles
  const int nv = h / VEC;
  const size_t base = static_cast<size_t>(live ? row : 0) * h;
  float v[V][VEC];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (live && g + i * L < nv) {
      load_vec<Tx, VEC>(x + base + (g + i * L) * VEC, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i][e] = 0.f;
    }
  }
  if (LN) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += v[i][e];
    const float mean = group_sum<L>(s) / static_cast<float>(h);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (g + i * L < nv) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float dv = v[i][e] - mean;
          sq += dv * dv;
        }
      }
    }
    const float r = rsqrtf(group_sum<L>(sq) / static_cast<float>(h) + eps);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = (g + i * L) * VEC;
      if (g + i * L < nv) {
        float s4[VEC], b4[VEC];
        load_cols<VEC>(ln_scale + c, s4);
        load_cols<VEC>(ln_bias + c, b4);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i][e] = (v[i][e] - mean) * r * s4[e] + b4[e];
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i][e] = 0.f;
      }
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(v[i][e]));
  const float sc = fmaxf(group_max<L>(amax) * kInv127, 1e-12f);
  const float y = __frcp_rn(sc);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (live && g + i * L < nv) {
      uint32_t b[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) b[e] = code_bits(quotient(v[i][e], sc, y));
      store_codes<VEC>(q + base + (g + i * L) * VEC, b);
    }
  }
  if (live && g == 0) qscale[row] = sc;
}

template <typename Tx, int VEC, int L, int V, bool LN>
void launch_quant(const void* x, const void* ln_scale, const void* ln_bias, void* q,
                  void* qscale, int rows, int h, float eps, cudaStream_t stream) {
  constexpr int rows_per_block = (kQuantThreads / 32) * (32 / L);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  row_quant_kernel<Tx, VEC, L, V, LN><<<blocks, kQuantThreads, 0, stream>>>(
      static_cast<const Tx*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<int8_t*>(q),
      static_cast<float*>(qscale), rows, h, eps);
}

// the width class of a row of nv vectors: lanes a row and vectors a lane
template <typename Tx, int VEC, bool LN>
void quant_by_width(const void* x, const void* ln_scale, const void* ln_bias, void* q,
                    void* qscale, int rows, int h, float eps, cudaStream_t st) {
  const int nv = h / VEC;
#define MM_QUANT(L_, V_) \
  return launch_quant<Tx, VEC, L_, V_, LN>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st)
  if constexpr (VEC == 1) {  // a width or an address the 16-byte loads cannot take
    if (nv <= 128) MM_QUANT(32, 4);
    if (nv <= 384) MM_QUANT(32, 12);
    if (nv <= 768) MM_QUANT(32, 24);
    if (nv <= 1536) MM_QUANT(32, 48);
    MM_QUANT(32, 96);
  } else {
    if (nv <= 8) MM_QUANT(8, 1);
    if (nv <= 16) MM_QUANT(16, 1);
    if (nv <= 32) MM_QUANT(16, 2);
    if (nv <= 48) MM_QUANT(16, 3);  // 384 bf16
    if (nv <= 64) MM_QUANT(32, 2);
    if (nv <= 96) MM_QUANT(32, 3);  // 768 bf16, 384 f32
    if (nv <= 192) MM_QUANT(32, 6);  // 1536 bf16, 768 f32
    if (nv <= 384) MM_QUANT(32, 12);  // 3072 bf16, 1536 f32
    MM_QUANT(32, 24);  // 3072 f32
  }
#undef MM_QUANT
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Tx, bool LN>
void quant_by_layout(const void* x, const void* ln_scale, const void* ln_bias, void* q,
                     void* qscale, int rows, int h, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(Tx);
  const bool vec = h % VEC == 0 && aligned(x, 16) && aligned(q, VEC) &&
                   (!LN || (aligned(ln_scale, 16) && aligned(ln_bias, 16)));
  if (vec) {
    quant_by_width<Tx, VEC, LN>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
  } else {
    quant_by_width<Tx, 1, LN>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
  }
}

template <typename Tx>
void quant_dispatch(const void* x, const void* ln_scale, const void* ln_bias, void* q,
                    void* qscale, int rows, int h, float eps, cudaStream_t st) {
  if (ln_scale != nullptr) {
    quant_by_layout<Tx, true>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
  } else {
    quant_by_layout<Tx, false>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
  }
}

}  // namespace

// x: (rows, h) of x_dt; d: (rows, h) of d_dt or null; scale/bias: (h,) f32;
// out: (rows, h) of out_dt. Pass d_dt = x_dt when d is null.
extern "C" int mm_add_ln(void* x, int x_dt, void* d, int d_dt, void* scale, void* bias,
                         void* out, int out_dt, int rows, int h, float eps, void* stream) {
  if (h <= 0 || h > 32 * kMaxPerLane || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (x_dt == mm::DT_F32) {
    ok = dispatch_delta<float>(d_dt, out_dt, x, d, scale, bias, out, rows, h, eps, st);
  } else if (x_dt == mm::DT_BF16) {
    ok = dispatch_delta<bf16>(d_dt, out_dt, x, d, scale, bias, out, rows, h, eps, st);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, h) of x_dt; ln_scale/ln_bias: (h,) f32, or both null for no
// LayerNorm; q: (rows, h) int8; qscale: (rows,) f32. h <= 3072.
extern "C" int mm_row_quant(void* x, int x_dt, void* ln_scale, void* ln_bias, float eps,
                            void* q, void* qscale, int rows, int h, void* stream) {
  if (h <= 0 || h > 3072 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((ln_scale == nullptr) != (ln_bias == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dt == mm::DT_F32) {
    quant_dispatch<float>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
  } else if (x_dt == mm::DT_BF16) {
    quant_dispatch<bf16>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
