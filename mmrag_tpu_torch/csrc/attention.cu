// K-attn: multi-head attention over (b*s, h) q, k and v read by row stride.
//
// The MHA step of B1 (mmrag_tpu/ops/attention.py::_attn_block_kernel) and of
// B6 (::_attn_block_kernel_q8), and the whole of B5 (::_attn_kernel, the
// CLIP text tower's attention); the softmax is _softmax_ctx. For each batch
// row, head and 64-query tile one block loops over 64-key tiles: scores =
// q.k * hd^-0.5 + bias, p = exp(min(score, 80)) rounded to the stream dtype,
// then sum(p v) and sum(p) accumulate in f32 and the context is
// sum(p v) / max(sum(p), 1e-30). That is the JAX kernel's one-pass form: no
// max subtraction (the cap at 80 keeps exp finite, and softmax is
// shift-invariant), so the running sums need no rescaling between key tiles;
// a query whose keys are all masked gets a context of exactly 0.
//
// q, k and v are read by stride, head n at column n*hd of each: from the
// fused (b*s, 3h) projection output of B1/B6 (row stride 3h) or from
// separate (b, s, h) tensors or views (B5), so no transposes are made. Two
// compile-time modes sit beside B1's form, which keeps its code and time:
//   * FULL: a (b, s, s) f32 additive bias (B5: causal plus padding), read
//     at [b * bias_bstride + query * s + key]; a batch stride of 0 takes a
//     shared (s, s) bias. Otherwise the bias is B1's (b, s) key row, staged
//     in shared memory once per key tile.
//   * To = float with a bf16 stream: the context is written in f32 (B6
//     quantizes the f32 context for its int8 output projection and never
//     rounds it to the stream dtype).
// The ragged edges (s = 77 of CLIP text is a multiple of neither the 64-row
// tiles nor 16) are masked in the loads and the stores.
//
// Bound on an H100: operations for B1 at seq 512 (the rerank layer, 8 x 512
// tokens, 12 heads of 32, does 4 x 4096 x 512 x 384 = 3.2 GFLOP, 3.3 us at
// 989 TFLOP/s); bytes for B5 at 16 x 77 x 512 (5.4 MB of q, k, v, bias and
// context, 1.6 us at 3.35 TB/s, against 0.16 GFLOP). This first form runs
// the products as f32 FMAs on the CUDA cores from shared-memory tiles
// (67 TFLOP/s peak), so it sits well above either bound. Tensor-core (mma)
// tiles are later work.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int QT = 64;    // queries per block
constexpr int KT = 64;    // keys per tile
constexpr int NT = 256;   // threads: 4 per query
constexpr float kLogitCap = 80.f;

template <int HD>
constexpr size_t smem_bytes() {
  // q, k (padded pitch HD + 1), v (pitch HD), p (pitch KT + 1), key bias
  return sizeof(float) * (QT * (HD + 1) + KT * (HD + 1) + KT * HD + QT * (KT + 1) + KT);
}

template <typename T, typename To, int HD, bool FULL>
__global__ void __launch_bounds__(NT)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     int rs, const float* __restrict__ bias, long long bias_bstride,
                     To* __restrict__ ctx, int s, int h, float scale) {
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
    qs[r * (HD + 1) + d] = qi < s ? mm::to_f(q[(batch_row0 + qi) * rs + hoff + d]) : 0.f;
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
        kv = mm::to_f(k[off]);
        vv = mm::to_f(v[off]);
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
        const float sc = acc * scale + bj;
        // cast to the stream dtype as p.astype(v.dtype) does before the dot
        p = mm::to_f(mm::from_f<T>(expf(fminf(sc, kLogitCap))));
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
    To* out = ctx + (batch_row0 + qi) * static_cast<size_t>(h) + hoff;
#pragma unroll
    for (int t = 0; t < DPT; ++t) out[part + 4 * t] = mm::from_f<To>(num[t] * inv);
  }
}

struct Args {
  const void *q, *k, *v, *bias;
  void* ctx;
  int rs, b, s, h, nh;
  long long bias_bstride;
  cudaStream_t stream;
};

template <typename T, typename To, int HD, bool FULL>
int launch(const Args& a) {
  const size_t bytes = smem_bytes<HD>();
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, To, HD, FULL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((a.s + QT - 1) / QT, a.nh, a.b);
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  attention_kernel<T, To, HD, FULL><<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.rs,
      static_cast<const float*>(a.bias), a.bias_bstride, static_cast<To*>(a.ctx), a.s, a.h,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename To, bool FULL>
int by_head_dim(const Args& a) {
  const int hd = a.h / a.nh;
  if (hd == 32) return launch<T, To, 32, FULL>(a);
  if (hd == 64) return launch<T, To, 64, FULL>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename To>
int by_mode(const Args& a, int full) {
  return full ? by_head_dim<T, To, true>(a) : by_head_dim<T, To, false>(a);
}

}  // namespace

// q, k, v: row i of batch row b at element (b*s + i) * rs of each pointer,
// dtype dt; head n at columns [n*hd, (n+1)*hd). bias: full == 0, the (b, s)
// f32 key row; full == 1, f32 (s, s) blocks at batch stride bias_bstride.
// ctx: contiguous (b*s, h) of out_dt (dt, or f32). hd = h / nh must be 32
// or 64.
extern "C" int mm_attention(void* q, void* k, void* v, int rs, void* bias, int full,
                            long long bias_bstride, void* ctx, int out_dt, int b, int s, int h,
                            int nh, int dt, void* stream) {
  if (b < 0 || s <= 0 || nh <= 0 || h % nh || rs < h) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const Args a{q, k, v, bias, ctx, rs, b, s, h, nh, bias_bstride, static_cast<cudaStream_t>(stream)};
  if (dt == mm::DT_BF16) {
    if (out_dt == mm::DT_BF16) return by_mode<bf16, bf16>(a, full);
    if (out_dt == mm::DT_F32) return by_mode<bf16, float>(a, full);
  } else if (dt == mm::DT_F32 && out_dt == mm::DT_F32) {
    return by_mode<float, float>(a, full);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
