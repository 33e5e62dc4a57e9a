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
// pre-LN blocks computed first in the same registers. The rounding points
// are those of quantize_rows: the division is IEEE (__fdiv_rn; the sources
// are built without --use_fast_math) and the rounding is half to even
// (__float2int_rn, as jnp.round and torch.round; roundf would round halves
// away from zero). One warp owns a row as above, up to h = 3072 (96 values
// a lane: the B7 inner activation of CLIP's fc1). Bound: bytes, like K-ln
// (7168 x 3072 f32 in, int8 out: 110 MB, 33 us at 3.35 TB/s).
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

template <typename Tx, int VPL, bool LN>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    row_quant_kernel(const Tx* __restrict__ x, const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias, int8_t* __restrict__ q,
                     float* __restrict__ qscale, int rows, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * h;
  float v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + i * 32;
    v[i] = c < h ? mm::to_f(x[base + c]) : 0.f;
  }
  if (LN) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) s += v[i];
    const float mean = mm::warp_sum(s) / static_cast<float>(h);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const float dv = lane + i * 32 < h ? v[i] - mean : 0.f;
      sq += dv * dv;
    }
    const float r = rsqrtf(mm::warp_sum(sq) / static_cast<float>(h) + eps);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + i * 32;
      v[i] = c < h ? (v[i] - mean) * r * ln_scale[c] + ln_bias[c] : 0.f;
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float sc = fmaxf(mm::warp_max(amax) * kInv127, 1e-12f);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + i * 32;
    if (c < h) q[base + c] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(v[i], sc)));
  }
  if (lane == 0) qscale[row] = sc;
}

template <typename Tx, int VPL>
void launch_quant(const void* x, const void* ln_scale, const void* ln_bias, void* q,
                  void* qscale, int rows, int h, float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const Tx* xp = static_cast<const Tx*>(x);
  const float* s = static_cast<const float*>(ln_scale);
  const float* b = static_cast<const float*>(ln_bias);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(qscale);
  if (ln_scale != nullptr) {
    row_quant_kernel<Tx, VPL, true><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
        xp, s, b, qp, sp, rows, h, eps);
  } else {
    row_quant_kernel<Tx, VPL, false><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
        xp, s, b, qp, sp, rows, h, eps);
  }
}

template <typename Tx>
void quant_by_width(const void* x, const void* ln_scale, const void* ln_bias, void* q,
                    void* qscale, int rows, int h, float eps, cudaStream_t stream) {
  if (h <= 32 * kMaxPerLane) {
    launch_quant<Tx, kMaxPerLane>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, stream);
  } else {
    launch_quant<Tx, 3 * kMaxPerLane>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, stream);
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
  if (h <= 0 || h > 3 * 32 * kMaxPerLane || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((ln_scale == nullptr) != (ln_bias == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dt == mm::DT_F32) {
    quant_by_width<float>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
  } else if (x_dt == mm::DT_BF16) {
    quant_by_width<bf16>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
