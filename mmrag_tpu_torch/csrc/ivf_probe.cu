// K-probe: the predicated IVF probe. For each query q and each of its nprobe
// probed clusters p = probes[q, i], the dot of the query with every slot of
// bucket p, where the slot is live, of the query's tenant and (with a
// document filter) of its document; else a filler. Row ids are copied out
// beside the scores. Outputs (q, nprobe, B) f32 scores and int32 ids.
//
// Replaces mmrag_tpu/ops/ivf.py::_probe_kernel (B8; bf16 or f32 buckets,
// filler -1e30) and ::_probe_kernel_q (B9; int8 buckets: exact integer dot
// times the slot's f32 scale, filler -inf). The TPU kernels used scalar
// prefetch: the probe ids reached the BlockSpec index maps before the body
// ran and the pipeline DMA'd exactly the probed (B, d) blocks. Here one
// block owns one (query, probe) pair, reads the probe id from device memory
// itself and indexes the (C, B, d) bucket tensor in place, so no gathered
// copy of the probed blocks is ever written.
//
// Bound on an H100: bytes. Each probed block is read once per query that
// probes it: at the text shape (q 16, nprobe 64, B 768, d 384, bf16) that
// is 604 MB, 0.18 ms at 3.35 TB/s, against 2 * 16 * 64 * 768 * 384 = 0.6
// GFLOP. This first form holds the query row in shared memory as f32 (int8
// for B9), gives each warp one slot at a time and reads the slot's row with
// 16-byte loads (8 bf16, 4 f32 or 16 int8 a lane), sums in f32 (B9: __dp4a
// into int32, exact), reduces with warp shuffles, and evaluates the
// (C, 1, B) predicate planes in the same pass. A block that several queries
// probe is read again for each of them; sharing it across those queries
// (with mma) is later work.
#include "common.cuh"

using mm::bf16;

namespace {

constexpr int NT = 256;  // 8 warps, one slot each at a time
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float dot_vec(const float* row, const float* qs, int d, int lane) {
  float acc = 0.f;
  if ((d & 3) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int v = lane; v < d / 4; v += 32) {
      const float4 a = __ldg(r4 + v);
      const float4 b = q4[v];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int c = lane; c < d; c += 32) acc = fmaf(__ldg(row + c), qs[c], acc);
  }
  return acc;
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float dot_vec(const bf16* row, const float* qs, int d, int lane) {
  float acc = 0.f;
  if ((d & 7) == 0) {
    const uint4* r8 = reinterpret_cast<const uint4*>(row);
    for (int v = lane; v < d / 8; v += 32) {
      const uint4 w = __ldg(r8 + v);
      const float* q = qs + v * 8;
      acc = fmaf(bf_lo(w.x), q[0], acc);
      acc = fmaf(bf_hi(w.x), q[1], acc);
      acc = fmaf(bf_lo(w.y), q[2], acc);
      acc = fmaf(bf_hi(w.y), q[3], acc);
      acc = fmaf(bf_lo(w.z), q[4], acc);
      acc = fmaf(bf_hi(w.z), q[5], acc);
      acc = fmaf(bf_lo(w.w), q[6], acc);
      acc = fmaf(bf_hi(w.w), q[7], acc);
    }
  } else {
    for (int c = lane; c < d; c += 32) acc = fmaf(mm::to_f(row[c]), qs[c], acc);
  }
  return acc;
}

__device__ __forceinline__ bool slot_valid(const int* users, const int* docs, const int* live,
                                           size_t s, int uid, int did) {
  return live[s] != 0 && users[s] == uid && (did < 0 || docs[s] == did);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    probe_kernel(const T* __restrict__ q, const T* __restrict__ buckets,
                 const int* __restrict__ bucket_ids, const int* __restrict__ users,
                 const int* __restrict__ docs, const int* __restrict__ live,
                 const int* __restrict__ probes, const int* __restrict__ uids,
                 const int* __restrict__ dids, float* __restrict__ scores,
                 int* __restrict__ ids_out, int nprobe, int B, int d) {
  extern __shared__ __align__(16) float qs[];  // the query row, f32
  const int i = blockIdx.x, qi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int c = tid; c < d; c += NT) qs[c] = mm::to_f(q[static_cast<size_t>(qi) * d + c]);
  __syncthreads();
  const int p = probes[static_cast<size_t>(qi) * nprobe + i];
  const int uid = uids[qi], did = dids[qi];
  const size_t plane0 = static_cast<size_t>(p) * B;
  const size_t out0 = (static_cast<size_t>(qi) * nprobe + i) * B;
  for (int b = warp; b < B; b += NT / 32) {
    const float acc = mm::warp_sum(dot_vec(buckets + (plane0 + b) * d, qs, d, lane));
    if (lane == 0) {
      const size_t s = plane0 + b;
      scores[out0 + b] = slot_valid(users, docs, live, s, uid, did) ? acc : kNeg;
      ids_out[out0 + b] = bucket_ids[s];
    }
  }
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT)
    probe_kernel_q(const int8_t* __restrict__ q, const int8_t* __restrict__ buckets,
                   const float* __restrict__ scales, const int* __restrict__ bucket_ids,
                   const int* __restrict__ users, const int* __restrict__ docs,
                   const int* __restrict__ live, const int* __restrict__ probes,
                   const int* __restrict__ uids, const int* __restrict__ dids,
                   float* __restrict__ scores, int* __restrict__ ids_out, int nprobe, int B,
                   int d) {
  extern __shared__ __align__(16) int8_t qb[];  // the quantized query row
  const int i = blockIdx.x, qi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int c = tid; c < d; c += NT) qb[c] = q[static_cast<size_t>(qi) * d + c];
  __syncthreads();
  const int p = probes[static_cast<size_t>(qi) * nprobe + i];
  const int uid = uids[qi], did = dids[qi];
  const size_t plane0 = static_cast<size_t>(p) * B;
  const size_t out0 = (static_cast<size_t>(qi) * nprobe + i) * B;
  for (int b = warp; b < B; b += NT / 32) {
    const int8_t* row = buckets + (plane0 + b) * d;
    int acc = 0;
    if ((d & 15) == 0) {
      const int4* r16 = reinterpret_cast<const int4*>(row);
      const int4* q16 = reinterpret_cast<const int4*>(qb);
      for (int v = lane; v < d / 16; v += 32) {
        const int4 a = __ldg(r16 + v);
        const int4 w = q16[v];
        acc = __dp4a(a.x, w.x, acc);
        acc = __dp4a(a.y, w.y, acc);
        acc = __dp4a(a.z, w.z, acc);
        acc = __dp4a(a.w, w.w, acc);
      }
    } else {
      for (int c = lane; c < d; c += 32) acc += static_cast<int>(row[c]) * static_cast<int>(qb[c]);
    }
    acc = warp_sum_int(acc);  // exact: |sum| < 2^24, so the f32 below is too
    if (lane == 0) {
      const size_t s = plane0 + b;
      scores[out0 + b] = slot_valid(users, docs, live, s, uid, did)
                             ? __fmul_rn(static_cast<float>(acc), scales[s])
                             : __int_as_float(static_cast<int>(0xff800000u));  // -inf
      ids_out[out0 + b] = bucket_ids[s];
    }
  }
}

int check_args(int nq, int nprobe, int B, int d) {
  if (nq < 0 || nprobe < 0 || B < 0 || d <= 0 || nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// q: (nq, d) of dt; buckets: (C, B, d) of dt; bucket_ids, users, docs, live:
// (C, 1, B) int32; probes: (nq, nprobe) int32; uids, dids: (nq,) int32;
// scores: (nq, nprobe, B) f32; ids_out: (nq, nprobe, B) int32.
extern "C" int mm_ivf_probe(void* q, void* buckets, void* bucket_ids, void* users, void* docs,
                            void* live, void* probes, void* uids, void* dids, void* scores,
                            void* ids_out, int nq, int nprobe, int B, int d, int dt,
                            void* stream) {
  if (int rc = check_args(nq, nprobe, B, d)) return rc;
  if (nq == 0 || nprobe == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nprobe, nq);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int *bi = static_cast<const int*>(bucket_ids), *us = static_cast<const int*>(users),
            *dc = static_cast<const int*>(docs), *lv = static_cast<const int*>(live),
            *pr = static_cast<const int*>(probes), *ui = static_cast<const int*>(uids),
            *di = static_cast<const int*>(dids);
  float* sc = static_cast<float*>(scores);
  int* io = static_cast<int*>(ids_out);
  if (dt == mm::DT_BF16) {
    probe_kernel<bf16><<<grid, NT, smem, st>>>(static_cast<const bf16*>(q),
                                               static_cast<const bf16*>(buckets), bi, us, dc, lv,
                                               pr, ui, di, sc, io, nprobe, B, d);
  } else if (dt == mm::DT_F32) {
    probe_kernel<float><<<grid, NT, smem, st>>>(static_cast<const float*>(q),
                                                static_cast<const float*>(buckets), bi, us, dc,
                                                lv, pr, ui, di, sc, io, nprobe, B, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The int8 form: q (nq, d) int8 quantized query values; buckets (C, B, d)
// int8; scales (C, 1, B) f32; the rest as above.
extern "C" int mm_ivf_probe_q(void* q, void* buckets, void* scales, void* bucket_ids,
                              void* users, void* docs, void* live, void* probes, void* uids,
                              void* dids, void* scores, void* ids_out, int nq, int nprobe, int B,
                              int d, void* stream) {
  if (int rc = check_args(nq, nprobe, B, d)) return rc;
  if (nq == 0 || nprobe == 0 || B == 0) return 0;
  if (d > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nprobe, nq);
  probe_kernel_q<<<grid, NT, static_cast<size_t>(d), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(buckets),
      static_cast<const float*>(scales), static_cast<const int*>(bucket_ids),
      static_cast<const int*>(users), static_cast<const int*>(docs),
      static_cast<const int*>(live), static_cast<const int*>(probes),
      static_cast<const int*>(uids), static_cast<const int*>(dids), static_cast<float*>(scores),
      static_cast<int*>(ids_out), nprobe, B, d);
  return static_cast<int>(cudaGetLastError());
}
