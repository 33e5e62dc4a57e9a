// K-attn: multi-head attention over (b*s, h) q, k and v read by row stride.
//
// Replaces four TPU kernels of mmrag_tpu/ops/attention.py: the MHA step of B1
// (_attn_block_kernel) and of B6 (_attn_block_kernel_q8), the whole of B5
// (_attn_kernel, the CLIP text tower's attention) and the whole of B12
// (_attn_kernel2d, three separate (b*s, h) operands). The softmax is the JAX
// _softmax_ctx in one pass: scores = q.k * hd^-0.5 + bias,
// p = exp(min(score, 80)) rounded to the stream dtype, then sum(p v) and
// sum(p) accumulate in f32 over the rounded p and the context is
// sum(p v) / max(sum(p), 1e-30). There is no max subtraction (the cap keeps
// exp finite; softmax is shift-invariant), so the sums need no rescaling
// between key tiles, and a query whose keys are all masked gets exactly 0.
//
// q, k and v are read by stride, head n at column n*hd of each: the thirds of
// the fused (b*s, 3h) projection of B1/B6 (row stride 3h), the strided views
// of B5, or B12's separate tensors (row stride h); no transposes are made.
// Modes, all compile-time:
//   * bias: B1/B6/B12's (b, s) key row, or FULL: B5's (b, s, s) f32 bias at
//     [b * bias_bstride + query * s + key], a batch stride of 0 taking one
//     shared (s, s) bias;
//   * context in the stream dtype, or in f32 with a bf16 stream (B6 quantizes
//     the f32 context and never rounds it to bf16);
//   * hd 16, 32 or 64. Ragged s (50/56, 77, 512) is masked in loads and stores.
//
// What bounds it on an H100: at the rerank's 128 x 512 tokens, 12 heads of
// 32, with every key live, the products are 51.5 GFLOP (0.052 ms at 989
// TFLOP/s on the tensor cores), the exps 403 M (0.104 ms at the SFU's 16 a
// clock per SM x 132 SMs x 1.83 GHz), and q, k, v and the context 201 MB
// (0.060 ms at 3.35 TB/s): exp and bytes, not the tensor cores. At s 56-77
// (CLIP) it is bytes. The design:
//   * bf16 operands run on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//     sum) fed by ldmatrix, FlashAttention-2 style. Each of 4 warps owns 16
//     queries of the block's 64; its q fragments stay in registers for the
//     whole key loop. 64-key tiles of k and v come through a two-stage
//     cp.async ring of 16-byte copies into shared rows padded by 8 elements
//     (ldmatrix reads 8 rows at distinct 16-byte bank groups); rows past s
//     are zero-filled. The 16 x 64 score accumulators are scaled, biased,
//     capped, exponentiated (ex2 in the log2 domain: one SFU op a score) and
//     rounded to bf16 in registers, then reused directly as the A fragments
//     of p.v (the C layout of one mma is the A layout of the next); v is read
//     with ldmatrix.trans. sum(p) is taken per thread from the rounded p and
//     reduced across each quad at the end. wgmma and TMA are later work: the
//     tensor cores are not what bounds this kernel.
//   * Key-row mode skips key tiles that are all padding. The block first
//     marks each 64-key tile of its batch row live when any of its keys has
//     a bias above -1e8, compacts the live tiles into a list in shared memory
//     and loops over that list only, before any k or v is loaded. A skipped
//     tile adds exactly 0 to both sums: every score there is at most
//     |q.k| * hd^-0.5 - 1e8, below -104 whenever |q.k| * hd^-0.5 < 1e8 - 104
//     (encoder activations are many orders below that), and exp of anything
//     below -104 underflows to 0 in f32 (and in bf16). The mask may have
//     holes anywhere. The cross-encoder pads every pair to 512 tokens, so
//     most of the rerank's key tiles are skipped. Full-bias mode (B5, 2 tiles
//     at s 77) computes every tile.
//   * f32 operands keep a SIMT form (f32 FMAs from shared-memory tiles):
//     TF32 is off in the port, and the f32 runs are the 1e-4 reference
//     checks. The choice is by dtype at the C entry, not a fallback: every
//     call on the card launches one of the two or returns an error.
#include "common.cuh"

using mm::bf16;
using mm::cp_async16;
using mm::cp_async_commit;
using mm::cp_async_wait;
using mm::ldmatrix_x4;
using mm::mma_bf16;
using mm::smem_u32;
using mm::store2;

namespace {

constexpr float kLogitCap = 80.f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kDeadBias = -1e8f;  // key-row tiles whose biases are all <= this are skipped

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// ---------------------------------------------------------------------------
// bf16 operands: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TQ = 64;   // queries per block: 4 warps x 16
constexpr int TK = 64;   // keys per tile
constexpr int TC_NT = 128;

template <int HD>
__host__ __device__ constexpr int pitch() { return HD + 8; }  // bf16 elements per shared row

template <int HD>
size_t tc_smem_bytes(int ntiles) {
  // q, two stages of k and v, two stages of the key row, tile flags and list
  return sizeof(bf16) * pitch<HD>() * (TQ + 4 * TK) + sizeof(float) * 2 * TK +
         sizeof(int) * (2 * ntiles + 1);
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to nearest-even bf16, lo in the low half (the lower column
// of an mma fragment); their rounded values are added to sum
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi, float& sum) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  sum += __uint_as_float(u << 16) + __uint_as_float(u & 0xffff0000u);
  return u;
}

template <typename To, int HD, bool FULL>
__global__ void __launch_bounds__(TC_NT)
    attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int rs, const float* __restrict__ bias,
                         long long bias_bstride, To* __restrict__ ctx, int s, int h,
                         float scale) {
  constexpr int P = pitch<HD>();
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);       // [TQ][P]
  bf16* ks = qs + TQ * P;                             // [2][TK][P]
  bf16* vs = ks + 2 * TK * P;                         // [2][TK][P]
  float* kb = reinterpret_cast<float*>(vs + 2 * TK * P);  // [2][TK], times log2(e)
  int* flags = reinterpret_cast<int*>(kb + 2 * TK);   // [ntiles]
  int* list = flags + (s + TK - 1) / TK;              // [ntiles + 1]: count, then tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // the mma fragment's row group and column pair
  const int q0 = blockIdx.x * TQ, head = blockIdx.y, b = blockIdx.z;
  const size_t row0 = static_cast<size_t>(b) * s;
  const int hoff = head * HD;
  const int ntiles = (s + TK - 1) / TK;

  int n_live = ntiles;
  if (!FULL) {
    for (int t = warp; t < ntiles; t += TC_NT / 32) {
      const int k0 = t * TK + lane, k1 = k0 + 32;
      const bool live = (k0 < s && bias[row0 + k0] > kDeadBias) ||
                        (k1 < s && bias[row0 + k1] > kDeadBias);
      const bool any = __any_sync(0xffffffffu, live);
      if (lane == 0) flags[t] = any;
    }
    __syncthreads();
    if (warp == 0) {
      int count = 0;
      for (int base = 0; base < ntiles; base += 32) {
        const int t = base + lane;
        const bool f = t < ntiles && flags[t];
        const unsigned m = __ballot_sync(0xffffffffu, f);
        if (f) list[1 + count + __popc(m & ((1u << lane) - 1u))] = t;
        count += __popc(m);
      }
      if (lane == 0) list[0] = count;
    }
    __syncthreads();
    n_live = list[0];
  }

  auto tile_of = [&](int i) { return FULL ? i : list[1 + i]; };
  auto load_tile = [&](int t, int stage) {
    const int k0 = t * TK;
    bf16* kd = ks + stage * TK * P;
    bf16* vd = vs + stage * TK * P;
    for (int c = tid; c < TK * CH; c += TC_NT) {
      const int r = c / CH, cc = c % CH;
      const int kj = k0 + r;
      const bool ok = kj < s;
      const size_t off = (row0 + (ok ? kj : 0)) * rs + hoff + cc * 8;
      cp_async16(kd + r * P + cc * 8, k + off, ok);
      cp_async16(vd + r * P + cc * 8, v + off, ok);
    }
    if (!FULL && tid < TK) {
      const int kj = k0 + tid;
      kb[stage * TK + tid] = kj < s ? bias[row0 + kj] * kLog2e : neg_inf();
    }
  };

  if (n_live > 0) {
    for (int c = tid; c < TQ * CH; c += TC_NT) {
      const int r = c / CH, cc = c % CH;
      const int qi = q0 + r;
      const bool ok = qi < s;
      cp_async16(qs + r * P + cc * 8, q + (row0 + (ok ? qi : 0)) * rs + hoff + cc * 8, ok);
    }
    load_tile(tile_of(0), 0);
  }
  cp_async_commit();

  // FULL: the bias rows of this thread's two queries (row 0 stands in for
  // the tile's padding rows, whose context is not stored)
  const int qa = q0 + warp * 16 + g, qb = qa + 8;
  const float* bra = nullptr;
  const float* brb = nullptr;
  if (FULL) {
    const float* bb = bias + static_cast<size_t>(b) * bias_bstride;
    bra = bb + static_cast<size_t>(qa < s ? qa : 0) * s;
    brb = bb + static_cast<size_t>(qb < s ? qb : 0) * s;
  }

  const float sl2 = scale * kLog2e, cap2 = kLogitCap * kLog2e;
  unsigned qf[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float den_a = 0.f, den_b = 0.f;  // rows g and g + 8 of this warp

  for (int i = 0; i < n_live; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_live) load_tile(tile_of(i + 1), stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: this tile (and q) arrived
    __syncthreads();
    if (i == 0) {
      const bf16* qw = qs + warp * 16 * P;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], qw + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = ks + stage * TK * P;
    const bf16* vt = vs + stage * TK * P;

    // s = q . k^T: 8 n-tiles of 8 keys, 4 floats each
    float sc[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < TK / 16; ++jp) {
        unsigned bf[4];  // b0, b1 of keys jp*16 + 0..7, then of keys + 8..15
        ldmatrix_x4(bf, kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * jp], qf[kk], bf[0], bf[1]);
        mma_bf16(sc[2 * jp + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // p = exp(min(s * scale + bias, 80)) in the log2 domain, rounded to bf16:
    // [j][0] row g, [j][1] row g + 8, keys j*8 + 2*tq and + 1
    const int k0 = tile_of(i) * TK;
    unsigned pf[TK / 8][2];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const int kc = j * 8 + 2 * tq;
      float ba0, ba1, bb0, bb1;
      if (FULL) {
        const int kj = k0 + kc;
        ba0 = kj < s ? bra[kj] * kLog2e : neg_inf();
        ba1 = kj + 1 < s ? bra[kj + 1] * kLog2e : neg_inf();
        bb0 = kj < s ? brb[kj] * kLog2e : neg_inf();
        bb1 = kj + 1 < s ? brb[kj + 1] * kLog2e : neg_inf();
      } else {
        const float2 kv = *reinterpret_cast<const float2*>(kb + stage * TK + kc);
        ba0 = bb0 = kv.x;
        ba1 = bb1 = kv.y;
      }
      pf[j][0] = pack_bf16(ex2(fminf(fmaf(sc[j][0], sl2, ba0), cap2)),
                           ex2(fminf(fmaf(sc[j][1], sl2, ba1), cap2)), den_a);
      pf[j][1] = pack_bf16(ex2(fminf(fmaf(sc[j][2], sl2, bb0), cap2)),
                           ex2(fminf(fmaf(sc[j][3], sl2, bb1), cap2)), den_b);
    }

    // o += p . v: the score accumulators are the A fragments, v via ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const unsigned a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned bf[4];  // b0, b1 of dims dp*16 + 0..7, then of dims + 8..15
        ldmatrix_x4_trans(bf, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is refilled next iteration
  }
  cp_async_wait<0>();

  den_a += __shfl_xor_sync(0xffffffffu, den_a, 1);
  den_a += __shfl_xor_sync(0xffffffffu, den_a, 2);
  den_b += __shfl_xor_sync(0xffffffffu, den_b, 1);
  den_b += __shfl_xor_sync(0xffffffffu, den_b, 2);
  const float inv_a = 1.f / fmaxf(den_a, 1e-30f), inv_b = 1.f / fmaxf(den_b, 1e-30f);
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = hoff + d * 8 + 2 * tq;
    if (qa < s) store2(ctx + (row0 + qa) * h + col, o[d][0] * inv_a, o[d][1] * inv_a);
    if (qb < s) store2(ctx + (row0 + qb) * h + col, o[d][2] * inv_b, o[d][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// f32 operands: the SIMT kernel
// ---------------------------------------------------------------------------

constexpr int QT = 64;    // queries per block
constexpr int KT = 64;    // keys per tile
constexpr int NT = 256;   // threads: 4 per query

template <int HD>
constexpr size_t simt_smem_bytes() {
  // q, k (padded pitch HD + 1), v (pitch HD), p (pitch KT + 1), key bias
  return sizeof(float) * (QT * (HD + 1) + KT * (HD + 1) + KT * HD + QT * (KT + 1) + KT);
}

template <int HD, bool FULL>
__global__ void __launch_bounds__(NT)
    attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, int rs, const float* __restrict__ bias,
                         long long bias_bstride, float* __restrict__ ctx, int s, int h,
                         float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [QT][HD + 1]
  float* ks = qs + QT * (HD + 1);      // [KT][HD + 1]
  float* vs = ks + KT * (HD + 1);      // [KT][HD]
  float* ps = vs + KT * HD;            // [QT][KT + 1]
  float* kb = ps + QT * (KT + 1);      // [KT]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t batch_row0 = static_cast<size_t>(b) * s;
  const int hoff = head * HD;

  for (int e = tid; e < QT * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int qi = q0 + r;
    qs[r * (HD + 1) + d] = qi < s ? q[(batch_row0 + qi) * rs + hoff + d] : 0.f;
  }

  const int my_q = tid >> 2;  // this thread's query within the tile
  const int part = tid & 3;   // its quarter of the keys / output dims
  const int qi = q0 + my_q;
  // FULL: this query's bias row (row 0 stands in for the tile's padding rows)
  const float* brow = nullptr;
  if (FULL) {
    brow = bias + static_cast<size_t>(b) * bias_bstride + static_cast<size_t>(qi < s ? qi : 0) * s;
  }
  constexpr int DPT = HD / 4;
  float num[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) num[t] = 0.f;
  float den = 0.f;

  for (int k0 = 0; k0 < s; k0 += KT) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int e = tid; e < KT * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < s) {
        const size_t off = (batch_row0 + kj) * rs + hoff + d;
        kv = k[off];
        vv = v[off];
      }
      ks[r * (HD + 1) + d] = kv;
      vs[r * HD + d] = vv;
    }
    if (!FULL && tid < KT) kb[tid] = (k0 + tid < s) ? bias[batch_row0 + k0 + tid] : 0.f;
    __syncthreads();

    // scores and unnormalized probabilities: keys part, part + 4, ...
    const float* qrow = qs + my_q * (HD + 1);
#pragma unroll 4
    for (int t = 0; t < KT / 4; ++t) {
      const int j = part + 4 * t;
      const float* krow = ks + j * (HD + 1);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qrow[d], krow[d], acc);
      float p = 0.f;
      if (k0 + j < s) {
        const float bj = FULL ? brow[k0 + j] : kb[j];
        p = expf(fminf(acc * scale + bj, kLogitCap));
      }
      ps[my_q * (KT + 1) + j] = p;
    }
    __syncthreads();

    // context: output dims part, part + 4, ...
    const float* prow = ps + my_q * (KT + 1);
    for (int j = 0; j < KT; ++j) {
      const float p = prow[j];
      den += p;
      const float* vrow = vs + j * HD;
#pragma unroll
      for (int t = 0; t < DPT; ++t) num[t] = fmaf(p, vrow[part + 4 * t], num[t]);
    }
  }

  if (qi < s) {
    const float inv = 1.f / fmaxf(den, 1e-30f);
    float* out = ctx + (batch_row0 + qi) * static_cast<size_t>(h) + hoff;
#pragma unroll
    for (int t = 0; t < DPT; ++t) out[part + 4 * t] = num[t] * inv;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *bias;
  void* ctx;
  int rs, b, s, h, nh;
  long long bias_bstride;
  cudaStream_t stream;
};

// The dynamic shared-memory attribute is per kernel; raise it as needed.
template <typename Kernel>
int reserve_smem(Kernel kernel, size_t bytes, size_t& reserved) {
  if (bytes <= reserved) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  reserved = bytes;
  return 0;
}

template <typename To, int HD, bool FULL>
int launch_mma(const Args& a) {
  static size_t reserved = 0;
  const size_t bytes = tc_smem_bytes<HD>((a.s + TK - 1) / TK);
  if (int err = reserve_smem(attention_mma_kernel<To, HD, FULL>, bytes, reserved)) return err;
  dim3 grid((a.s + TQ - 1) / TQ, a.nh, a.b);
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  attention_mma_kernel<To, HD, FULL><<<grid, TC_NT, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.rs, static_cast<const float*>(a.bias), a.bias_bstride,
      static_cast<To*>(a.ctx), a.s, a.h, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool FULL>
int launch_f32(const Args& a) {
  static size_t reserved = 0;
  const size_t bytes = simt_smem_bytes<HD>();
  if (int err = reserve_smem(attention_f32_kernel<HD, FULL>, bytes, reserved)) return err;
  dim3 grid((a.s + QT - 1) / QT, a.nh, a.b);
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  attention_f32_kernel<HD, FULL><<<grid, NT, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.rs, static_cast<const float*>(a.bias), a.bias_bstride,
      static_cast<float*>(a.ctx), a.s, a.h, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool FULL>
int by_dtype(const Args& a, int dt, int out_dt) {
  if (dt == mm::DT_BF16) {
    if (out_dt == mm::DT_BF16) return launch_mma<bf16, HD, FULL>(a);
    if (out_dt == mm::DT_F32) return launch_mma<float, HD, FULL>(a);
  } else if (dt == mm::DT_F32 && out_dt == mm::DT_F32) {
    return launch_f32<HD, FULL>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool FULL>
int by_head_dim(const Args& a, int dt, int out_dt) {
  const int hd = a.h / a.nh;
  if (hd == 16) return by_dtype<16, FULL>(a, dt, out_dt);
  if (hd == 32) return by_dtype<32, FULL>(a, dt, out_dt);
  if (hd == 64) return by_dtype<64, FULL>(a, dt, out_dt);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q, k, v: row i of batch row b at element (b*s + i) * rs of each pointer,
// dtype dt; head n at columns [n*hd, (n+1)*hd). bias: full == 0, the (b, s)
// f32 key row; full == 1, f32 (s, s) blocks at batch stride bias_bstride.
// ctx: contiguous (b*s, h) of out_dt (dt, or f32). hd = h / nh must be 16,
// 32 or 64; q, k and v 16-byte aligned with rs a multiple of 8 elements (the
// tensor-core kernel's 16-byte copies).
extern "C" int mm_attention(void* q, void* k, void* v, int rs, void* bias, int full,
                            long long bias_bstride, void* ctx, int out_dt, int b, int s, int h,
                            int nh, int dt, void* stream) {
  if (b < 0 || s <= 0 || nh <= 0 || h % nh || rs < h) return static_cast<int>(cudaErrorInvalidValue);
  if (rs % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (b == 0) return 0;
  const Args a{q, k, v, bias, ctx, rs, b, s, h, nh, bias_bstride, static_cast<cudaStream_t>(stream)};
  return full ? by_head_dim<true>(a, dt, out_dt) : by_head_dim<false>(a, dt, out_dt);
}
