// K-ln: out = LayerNorm(x [+ delta]) per row, f32 statistics; and K-quant:
// per-row symmetric int8 of x, or of LayerNorm(x), with its f32 row scale.
// Both are one row kernel (row_kernel) whose tail either stores the row or
// quantizes it.
//
// K-ln replaces mmrag_tpu/ops/layernorm.py::_add_ln_kernel (B2, :43, launched
// at :58), and is the LN step of the B1, B3, B6 and B7 compositions
// (mmrag_tpu/ops/attention.py:371 and :440, mmrag_tpu/ops/mlp.py:29 and
// :114). The TPU kernel tiled 1024 rows through VMEM and fell back to plain
// jnp on shapes that did not tile (rows % 8, h % 128); here the kernel masks
// the ragged edge itself, so every shape runs it (h <= 1024).
//
// Bound on an H100: bytes. LN(x + delta) at 4096 x 384 bf16 moves
// 3 x 4096 x 384 x 2 B = 9.4 MB, 2.8 us at 3.35 TB/s; the post-LN rerank
// shape (65536 x 384, f32 in, bf16 out) 151 MB, 45 us. It does 10 flops a
// value, far below the 295 flop/byte ridge. Most launches are small (512
// rows of 384 in the query towers: 1.2 MB, 0.35 us, below a launch's own
// cost), so what counts is few, wide instructions and a grid that reaches
// every SM. The design:
// * L lanes own a row (32 / L rows a warp) and each lane keeps V vectors,
//   each one 16-byte load of x (8 bf16 or 4 f32 values), L and V fixed per
//   width class so that no register slot is dead at the path's widths (384
//   bf16: 16 lanes x 3, two rows a warp; 384 f32 and 768 bf16: 32 x 3; 1024
//   f32: 32 x 8). The delta's values follow x's vectors (16 or 8 bytes of
//   bf16, 32 or 16 of f32), and the output leaves as packed stores of as
//   many values (16 bytes of bf16 from bf16 x, 8 from f32 x; vectors of 8
//   f32 values, two loads each, measured slower). Widths the 16-byte loads
//   cannot take and unaligned views run the same kernel with scalar loads.
// * The statistics are f32, two passes over registers (the mean, then the
//   mean of squared deviations, as jnp.mean(jnp.square(x - mean)) does),
//   reduced with a shuffle tree over the row's L lanes; eps inside rsqrt,
//   and (v - mean) * r * scale + bias rounded once to the output type. The
//   sums are taken in another order than the plain version's: f32 outputs
//   within 1e-4 of it, bf16 within 2 ulps (times the scale's magnitude).
// * scale and bias come in as 16-byte f32 vectors. In a launch whose rows
//   the card holds at once (the query towers' 512-4096 rows) they are loaded
//   with the row, so one memory latency covers both; in a larger one (the
//   rerank's 65536 rows, CLIP vision's 7168) they are loaded from L1 after
//   the statistics, which leaves registers for more rows in flight. A lane
//   group takes one row: a persistent grid whose warps walk rows, keeping
//   scale and bias in registers across them, measured slower on an H100 at
//   65536 rows (K-quant's too, which shares the kernel).
// * Small launches take blocks of fewer warps (down to one), so that the
//   grid spreads over the 132 SMs: 512 rows of 384 make 256 one-warp blocks.
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
// moves many bytes. It is the row kernel above with 16-byte loads of x (8
// bf16 or 4 f32 values a vector, 16 lanes for a 384-wide bf16 row, 32 from
// 768 values up); the codes leave as packed 8- or 4-byte words; the amax is
// a shuffle tree over the row's lanes; and a value costs a multiply, four
// FMAs and an add (the quotient and its rounding).
#include <type_traits>

#include "common.cuh"

using mm::bf16;
using mm::load_vals;
using mm::store_vals;

namespace {

constexpr int kRowThreads = 256;  // the most threads a block (8 warps)
constexpr int kMaxLnWidth = 1024;
constexpr int kMaxQuantWidth = 3072;

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

// K-ln's tail: the normalized row stored as f32 or bf16 (`f32` is the same
// for every row of a launch)
struct StoreTail {
  void* out;
  bool f32;
  template <int L, int V, int VEC>
  __device__ __forceinline__ void apply(float (&v)[V][VEC], size_t base, int g, int nv, int,
                                        bool live) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (live && g + i * L < nv) {
        const size_t off = base + static_cast<size_t>(g + i * L) * VEC;
        if (f32) {
          store_vals<VEC>(static_cast<float*>(out) + off, v[i]);
        } else {
          store_vals<VEC>(static_cast<bf16*>(out) + off, v[i]);
        }
      }
    }
  }
};

// f32(1/127) as the JAX package forms it: the double 1/127 rounded to f32
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

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

// K-quant's tail: the row's amax over its lanes, the scale, the codes
struct QuantTail {
  int8_t* q;
  float* qscale;
  template <int L, int V, int VEC>
  __device__ __forceinline__ void apply(float (&v)[V][VEC], size_t base, int g, int nv, int row,
                                        bool live) const {
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
};

// A lane's V vectors of a row (zeros past the row or for a dead row), all
// loads issued before any is used
template <int L, typename T, int V, int VEC>
__device__ __forceinline__ void load_row(const T* p, size_t base, int g, int nv, bool live,
                                         float (&v)[V][VEC]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (live && g + i * L < nv) {
      load_vals<VEC>(p + base + static_cast<size_t>(g + i * L) * VEC, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i][e] = 0.f;
    }
  }
}

// The row kernel. L lanes own a row (32 / L rows a warp); lane g of a row
// holds the VEC-value vectors g, g + L, ..., g + (V - 1) L, so each load
// instruction of a warp reads contiguous runs. d (of type d_dt) is added to
// x when it is given; LN normalizes the row with f32 statistics; then the
// tail stores or quantizes it. Dead rows of a warp take part in the
// shuffles. EARLY: scale and bias are loaded with the row, so their latency
// hides behind the row's; else after the statistics, from L1, which keeps
// them out of the registers while the row's loads are in flight.
template <typename Tx, int VEC, int L, int V, bool LN, bool EARLY, typename Tail>
__global__ void __launch_bounds__(kRowThreads)
    row_kernel(const Tx* __restrict__ x, const void* __restrict__ d, int d_dt,
               const float* __restrict__ ln_scale, const float* __restrict__ ln_bias, Tail tail,
               int rows, int h, float eps) {
  static_assert(LN || !EARLY, "scale and bias are LayerNorm's");
  const int lane = threadIdx.x & 31;
  const int g = lane % L;
  const int nv = h / VEC;
  const int row = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * (32 / L) + lane / L;
  const bool live = row < rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * h;
  float sc[EARLY ? V : 1][VEC], bi[EARLY ? V : 1][VEC];
  if constexpr (EARLY) {
    load_row<L>(ln_scale, 0, g, nv, true, sc);
    load_row<L>(ln_bias, 0, g, nv, true, bi);
  }
  float v[V][VEC];
  load_row<L>(x, base, g, nv, live, v);
  if (d != nullptr) {  // the same for every row: all of its loads go out together
    float t[V][VEC];
    if (d_dt == mm::DT_F32) {
      load_row<L>(static_cast<const float*>(d), base, g, nv, live, t);
    } else {
      load_row<L>(static_cast<const bf16*>(d), base, g, nv, live, t);
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i][e] += t[i][e];
  }
  if constexpr (LN) {
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
      if (g + i * L < nv) {
        float s4[VEC], b4[VEC];
        if constexpr (EARLY) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            s4[e] = sc[i][e];
            b4[e] = bi[i][e];
          }
        } else {
          load_vals<VEC>(ln_scale + (g + i * L) * VEC, s4);
          load_vals<VEC>(ln_bias + (g + i * L) * VEC, b4);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i][e] = (v[i][e] - mean) * r * s4[e] + b4[e];
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i][e] = 0.f;
      }
    }
  }
  tail.template apply<L>(v, base, g, nv, row, live);
}

// One launch of a width class: a lane group a row, blocks of 8 warps, or of
// fewer when the rows are few, so that the grid spreads over the SMs.
// K-ln loads scale and bias with the row (EARLY) when the launch's rows fit
// on the card at once, where latency is all there is to hide; a larger
// launch, or K-quant's, loads them late and so holds more rows in flight.
template <typename Tx, int VEC, int L, int V, bool LN, typename Tail>
int launch_rows(const Tx* x, const void* d, int d_dt, const float* ln_scale,
                const float* ln_bias, Tail tail, int rows, int h, float eps, cudaStream_t st) {
  const long long warps = (rows + 32 / L - 1) / (32 / L);
  int wpb = kRowThreads / 32;
  while (wpb > 1 && warps < static_cast<long long>(wpb) * mm::sm_count()) wpb >>= 1;
  const dim3 grid(static_cast<unsigned>((warps + wpb - 1) / wpb)), block(wpb * 32);
  if constexpr (std::is_same<Tail, StoreTail>::value) {
    auto early = row_kernel<Tx, VEC, L, V, LN, true, Tail>;
    // rows the card holds at once with early loads, asked once per instance
    // (host time counts at the small shapes); negative: the query's error
    static const long long wave = [&] {
      int blocks = 0;
      const cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, early, kRowThreads, 0);
      return e == cudaSuccess ? static_cast<long long>(blocks) * kRowThreads / L * mm::sm_count()
                              : -static_cast<long long>(e);
    }();
    if (wave < 0) return static_cast<int>(-wave);
    if (rows <= wave) {
      early<<<grid, block, 0, st>>>(x, d, d_dt, ln_scale, ln_bias, tail, rows, h, eps);
      return static_cast<int>(cudaGetLastError());
    }
  }
  row_kernel<Tx, VEC, L, V, LN, false, Tail><<<grid, block, 0, st>>>(
      x, d, d_dt, ln_scale, ln_bias, tail, rows, h, eps);
  return static_cast<int>(cudaGetLastError());
}

// The width class of a row of nv vectors (lanes a row, vectors a lane), up
// to nv <= MAXNV: the 8-, 4-value classes (16-byte loads), then those of
// scalar loads (VEC 1).
template <typename Tx, int VEC, int MAXNV, bool LN, typename Tail>
int by_width(const Tx* x, const void* d, int d_dt, const float* ln_scale, const float* ln_bias,
             Tail tail, int rows, int h, float eps, cudaStream_t st) {
  const int nv = h / VEC;
#define MM_ROWS(N_, L_, V_) \
  if (nv <= N_)           \
  return launch_rows<Tx, VEC, L_, V_, LN, Tail>(x, d, d_dt, ln_scale, ln_bias, tail, rows, h, \
                                                eps, st)
  if constexpr (VEC == 1) {
    MM_ROWS(128, 32, 4);
    if constexpr (MAXNV > 128) MM_ROWS(384, 32, 12);
    if constexpr (MAXNV > 384) MM_ROWS(768, 32, 24);
    if constexpr (MAXNV > 768) MM_ROWS(1024, 32, 32);
    if constexpr (MAXNV > 1024) MM_ROWS(1536, 32, 48);
    if constexpr (MAXNV > 1536) MM_ROWS(3072, 32, 96);
  } else {
    MM_ROWS(8, 8, 1);
    MM_ROWS(16, 16, 1);
    MM_ROWS(32, 16, 2);
    MM_ROWS(48, 16, 3);  // 384 values of 8
    MM_ROWS(64, 32, 2);
    MM_ROWS(96, 32, 3);  // 768 values of 8, 384 f32 of 4
    MM_ROWS(128, 32, 4);  // 1024 values of 8
    if constexpr (MAXNV > 128) MM_ROWS(192, 32, 6);
    if constexpr (MAXNV > 192) MM_ROWS(256, 32, 8);  // 1024 f32 of 4
    if constexpr (MAXNV > 256) MM_ROWS(384, 32, 12);
    if constexpr (MAXNV > 384) MM_ROWS(768, 32, 24);
  }
#undef MM_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Tx>
int ln_dispatch(const void* x, const void* d, int d_dt, const float* scale, const float* bias,
                void* out, bool out_f32, int rows, int h, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(Tx);
  const Tx* xt = static_cast<const Tx*>(x);
  const StoreTail tail{out, out_f32};
  // a vector of x is 16 bytes; the delta's and the output's as many values
  const auto vec_aligned = [](const void* p, int dt) {
    const int bytes = VEC * (dt == mm::DT_F32 ? 4 : 2);
    return aligned(p, bytes < 16 ? bytes : 16);
  };
  const bool vec = h % VEC == 0 && aligned(x, 16) && (d == nullptr || vec_aligned(d, d_dt)) &&
                   vec_aligned(out, out_f32 ? mm::DT_F32 : mm::DT_BF16) && aligned(scale, 16) &&
                   aligned(bias, 16);
  if (vec) return by_width<Tx, VEC, kMaxLnWidth / VEC, true>(xt, d, d_dt, scale, bias, tail, rows,
                                                             h, eps, st);
  return by_width<Tx, 1, kMaxLnWidth, true>(xt, d, d_dt, scale, bias, tail, rows, h, eps, st);
}

template <typename Tx, bool LN>
int quant_by_layout(const void* x, const float* ln_scale, const float* ln_bias, void* q,
                    void* qscale, int rows, int h, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(Tx);
  const Tx* xt = static_cast<const Tx*>(x);
  const QuantTail tail{static_cast<int8_t*>(q), static_cast<float*>(qscale)};
  const bool vec = h % VEC == 0 && aligned(x, 16) && aligned(q, VEC) &&
                   (!LN || (aligned(ln_scale, 16) && aligned(ln_bias, 16)));
  if (vec) return by_width<Tx, VEC, kMaxQuantWidth / VEC, LN>(xt, nullptr, 0, ln_scale, ln_bias,
                                                              tail, rows, h, eps, st);
  return by_width<Tx, 1, kMaxQuantWidth, LN>(xt, nullptr, 0, ln_scale, ln_bias, tail, rows, h,
                                             eps, st);
}

template <typename Tx>
int quant_dispatch(const void* x, const float* ln_scale, const float* ln_bias, void* q,
                   void* qscale, int rows, int h, float eps, cudaStream_t st) {
  if (ln_scale != nullptr)
    return quant_by_layout<Tx, true>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
  return quant_by_layout<Tx, false>(x, ln_scale, ln_bias, q, qscale, rows, h, eps, st);
}

}  // namespace

// x: (rows, h) of x_dt; d: (rows, h) of d_dt or null; scale/bias: (h,) f32;
// out: (rows, h) of out_dt. Pass d_dt = x_dt when d is null.
extern "C" int mm_add_ln(void* x, int x_dt, void* d, int d_dt, void* scale, void* bias,
                         void* out, int out_dt, int rows, int h, float eps, void* stream) {
  if (h <= 0 || h > kMaxLnWidth || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto known = [](int dt) { return dt == mm::DT_F32 || dt == mm::DT_BF16; };
  if (!known(x_dt) || !known(d_dt) || !known(out_dt)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const bool out_f32 = out_dt == mm::DT_F32;
  if (x_dt == mm::DT_F32) return ln_dispatch<float>(x, d, d_dt, s, b, out, out_f32, rows, h, eps, st);
  return ln_dispatch<bf16>(x, d, d_dt, s, b, out, out_f32, rows, h, eps, st);
}

// x: (rows, h) of x_dt; ln_scale/ln_bias: (h,) f32, or both null for no
// LayerNorm; q: (rows, h) int8; qscale: (rows,) f32. h <= 3072.
extern "C" int mm_row_quant(void* x, int x_dt, void* ln_scale, void* ln_bias, float eps,
                            void* q, void* qscale, int rows, int h, void* stream) {
  if (h <= 0 || h > kMaxQuantWidth || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((ln_scale == nullptr) != (ln_bias == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(ln_scale);
  const float* b = static_cast<const float*>(ln_bias);
  if (x_dt == mm::DT_F32) return quant_dispatch<float>(x, s, b, q, qscale, rows, h, eps, st);
  if (x_dt == mm::DT_BF16) return quant_dispatch<bf16>(x, s, b, q, qscale, rows, h, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
