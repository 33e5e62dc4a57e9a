// K-probe: the predicated IVF probe. For each query q and each of its nprobe
// probed clusters p = probes[q, i], the dot of the query with every slot of
// bucket p, where the slot is live, of the query's tenant and (with a
// document filter) of its document; else a filler. Row ids are copied out
// beside the scores. Outputs (q, nprobe, B) f32 scores and int32 ids.
//
// Replaces mmrag_tpu/ops/ivf.py::_probe_kernel (B8; bf16 or f32 buckets,
// filler -1e30) and ::_probe_kernel_q (B9; int8 buckets: exact integer dot
// times the slot's f32 scale, filler -inf). The TPU kernels ran one grid step
// a (query, probe) pair: scalar prefetch brought the probe ids to the
// BlockSpec index maps and the pipeline DMA'd each probed (B, d) block once
// a pair, so a block that k queries probe was read k times.
//
// Bound on an H100: bytes. Every distinct probed block read once with its
// predicate planes: at the text shape (q 16, nprobe 64, C 2048, B 768,
// d 384, bf16) 828 of the 1,024 probed blocks are distinct, 505 MB, 0.151 ms
// at 3.35 TB/s; at q1 64 blocks, 39 MB. A bf16 element meets the queries
// that probe its block (1.2 on average at q16): far below any compute limit.
//
// Design. Two launches on the caller's stream, no host synchronisation:
//
// 1. probe_group_kernel (one block) groups the (query, probe) pairs by
//    cluster: a count per cluster with atomics, a scan in cluster order, and
//    a list of jobs, each a cluster with at most kGP (16) of its probing
//    pairs; the pairs go to a padded table, kGP entries a job, (pair, query,
//    tenant, document) each. The unit is the pair: a query that lists a
//    cluster twice gets both of its rows. A 16-query batch (the coalesced
//    search) is one job a cluster, so each probed block is read once; a
//    cluster with more pairs is streamed again for each further 16, by the
//    same block right after, while the tile is still in L2.
// 2. probe_kernel: persistent blocks of 4 warps, 4 an SM (f32: 3), each take a
//    contiguous run of work items, an item being one job over one tile of
//    kSlots (64) slots, so a cluster's tiles spread over many blocks (q1's
//    64 blocks still fill the SMs). An item streams its tile through a ring
//    of 4 stages of 64 slots x 128 bytes of the row (64 bf16, 128 int8 or 32
//    f32 columns), filled by cp.async (16-byte copies, 8 or 4 for rows that
//    are not 16-byte aligned, plain loads for rows that are not 4-byte
//    aligned; a 16-byte chunk XOR-swizzled by row so the ldmatrix and float4
//    reads are free of bank conflicts; the ragged end of d zero-filled by
//    the copy's source size). Each stage also carries the job's query rows
//    for the same columns, and an item's first stage its predicate planes
//    (ids, users, docs, live and, int8, scales: 4 bytes a slot, coalesced)
//    and its pair table, so the predicate never waits on a load of its own.
//    Four small blocks an SM rather than one large one: a block waits at
//    each stage for the last of its copies, and four independent rings hide
//    one another's waits (96 KB in flight an SM; one block of 8 warps and
//    8 stages an SM was slower on the card at every shape).
//    bf16 and int8 run on the tensor cores, the slots as the m16 rows (a
//    warp owns 16), the job's pairs as the n8 columns (1-2 tiles): bf16 by
//    mma.sync m16n8k16 with f32 sums, int8 by m16n8k32 s8 x s8 -> s32, which
//    is exact; both read 32 bytes of a row a k-step, so their ldmatrix
//    addressing is the same. f32 stays off the tensor cores (TF32 would
//    break the 1e-5 contract): two lanes a slot split the 32 columns of a
//    stage and dot them with every pair's query row on the CUDA cores. The
//    epilogue applies the predicate from the staged planes and writes each
//    pair's row of scores and ids (8 consecutive slots of 4 pairs a store).
//
// The descriptors of an item (its cluster and the query rows it gathers) are
// loaded two items ahead, so the copies are issued without a round trip.
//
// -Xptxas -v (CUDA 12.8, sm_90a; chip_smoke.py's build phase prints it): the
// bf16 and int8 instances with 4- to 16-byte copies 95-100 registers, no
// spills; those with byte copies reach the 128 that 4 blocks an SM allow,
// with 24 bytes of spills.
#include <type_traits>

#include "common.cuh"

using mm::ldmatrix_x4;
using mm::smem_u32;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // a warp owns 16 slots
constexpr int kSlots = 16 * kWarps;    // slots a work item
constexpr int kBlocksPerSM = 4;        // independent rings an SM (f32: 3, below)
constexpr int kRowBytes = 128;         // bytes of a row a stage: 8 chunks of 16
constexpr int kGP = 16;                // probing pairs a job: 2 n8 tiles of the product
constexpr int kStages = 4;
static_assert(kGP * 8 <= kThreads && kGP % 8 == 0, "a thread copies a chunk of one query row");
constexpr int kPlanes = 5;       // ids, users, docs, live, scales (int8 form)
constexpr int kGroupThreads = 1024;
constexpr float kNeg = -1e30f;

enum { KIND_BF16 = 0, KIND_I8 = 1, KIND_F32 = 2 };

// f32 keeps a row's 16 floats and 16 sums a lane: 4 blocks an SM would cap
// it at 128 registers and spill, so it runs 3
__host__ __device__ constexpr int blocks_per_sm(int kind) {
  return kind == KIND_F32 ? 3 : kBlocksPerSM;
}

// stage layout, bytes
constexpr int kQOff = kSlots * kRowBytes;                     // the job's query rows
constexpr int kSideOff = kQOff + kGP * kRowBytes;             // planes, pairs, meta
constexpr int kPairOff = kPlanes * kSlots * 4;                // within the side area
constexpr int kMetaOff = kPairOff + kGP * 16;                 // (np, tile) of the item
constexpr int kSideBytes = kMetaOff + 16;
constexpr int kStageBytes = ((kSideOff + kSideBytes + 127) / 128) * 128;
constexpr int kSmemBytes = kStages * kStageBytes + kSideBytes;

// ---------------------------------------------------------------------------
// scratch: the groups, laid out by the wrapper's buffer
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// jobs a call can make: each holds at least one pair, and a cluster makes at
// most one job that is not full
inline long long max_jobs(long long pairs, long long C) {
  const long long by_cluster = (pairs + kGP - 1) / kGP + C;
  return pairs < by_cluster ? pairs : by_cluster;
}

struct Scratch {
  int4* pinfo;  // [jobs][kGP]: (pair, query, tenant, document)
  int4* jobs;   // [jobs]: (cluster, its pairs, its first job, its jobs)
  int* njobs;
  int* cnt;     // [C]: pairs of a cluster, then its first job (past kGroupSmemClusters)
  int* pos;     // [pairs]: a pair's place among its cluster's
};

inline size_t scratch_bytes(long long pairs, long long C) {
  const long long jobs = max_jobs(pairs, C);
  return static_cast<size_t>(jobs) * kGP * 16 + static_cast<size_t>(jobs) * 16 + 16 +
         align16(static_cast<size_t>(C) * 4) + align16(static_cast<size_t>(pairs) * 4);
}

inline Scratch scratch_layout(void* base, long long pairs, long long C) {
  const long long jobs = max_jobs(pairs, C);
  char* p = static_cast<char*>(base);
  Scratch s;
  s.pinfo = reinterpret_cast<int4*>(p);
  p += static_cast<size_t>(jobs) * kGP * 16;
  s.jobs = reinterpret_cast<int4*>(p);
  p += static_cast<size_t>(jobs) * 16;
  s.njobs = reinterpret_cast<int*>(p);
  p += 16;
  s.cnt = reinterpret_cast<int*>(p);
  p += align16(static_cast<size_t>(C) * 4);
  s.pos = reinterpret_cast<int*>(p);
  return s;
}

// ---------------------------------------------------------------------------
// 1. group the pairs by cluster
// ---------------------------------------------------------------------------

// the counts live in shared memory up to this many clusters, else in the
// scratch buffer (atomics on a generic address serve both)
constexpr int kGroupSmemClusters = 11264;  // 44 KB, under the 48 KB a launch may take unasked

__global__ void __launch_bounds__(kGroupThreads)
    probe_group_kernel(const int* __restrict__ probes, const int* __restrict__ uids,
                       const int* __restrict__ dids, int pairs, int nprobe, int C, Scratch s) {
  __shared__ int wsum[kGroupThreads / 32];
  extern __shared__ int scnt[];
  int* cnt = C <= kGroupSmemClusters ? scnt : s.cnt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < C; c += kGroupThreads) cnt[c] = 0;
  __syncthreads();
  for (int p = tid; p < pairs; p += kGroupThreads) {
    const int c = probes[p];
    s.pos[p] = (c >= 0 && c < C) ? atomicAdd(cnt + c, 1) : -1;  // out of range: no row
  }
  __syncthreads();
  // jobs of each cluster, ceil(count / kGP), scanned in cluster order: each
  // thread owns a contiguous run of clusters
  const int per = (C + kGroupThreads - 1) / kGroupThreads;
  const int c0 = min(C, tid * per), c1 = min(C, c0 + per);
  int mine = 0;
  for (int c = c0; c < c1; ++c) mine += (cnt[c] + kGP - 1) / kGP;
  int inc = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int v = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    wsum[lane] = v;
  }
  __syncthreads();
  int base = inc - mine + (warp ? wsum[warp - 1] : 0);
  for (int c = c0; c < c1; ++c) {
    const int n = cnt[c], nk = (n + kGP - 1) / kGP;
    cnt[c] = base;
    for (int k = 0; k < nk; ++k) s.jobs[base + k] = make_int4(c, n, base, nk);
    base += nk;
  }
  if (tid == kGroupThreads - 1) *s.njobs = base;
  __syncthreads();
  for (int p = tid; p < pairs; p += kGroupThreads) {
    const int k = s.pos[p];
    if (k < 0) continue;
    const int qi = p / nprobe;
    s.pinfo[static_cast<size_t>(cnt[probes[p]] + k / kGP) * kGP + k % kGP] =
        make_int4(p, qi, uids[qi], dids[qi]);
  }
}

// ---------------------------------------------------------------------------
// 2. the probe
// ---------------------------------------------------------------------------

// N-byte async copy (4, 8 or 16) of which the first n are read, the rest
// zero-filled
template <int N>
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem, int n) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
                 "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(smem)),
                 "l"(gmem), "n"(N), "r"(n));
  }
}

// 16 bytes at byte `off` of a row segment `src` of `valid` bytes into `dst`,
// zero past them; VEC is the copy width the row's alignment allows (0: plain
// byte loads, for rows that are not 4-byte aligned)
template <int VEC>
__device__ __forceinline__ void fetch16(unsigned char* dst, const unsigned char* src, int off,
                                        int valid) {
  if constexpr (VEC == 0) {
#pragma unroll
    for (int b = 0; b < 16; ++b) dst[b] = off + b < valid ? src[off + b] : 0;
  } else {
#pragma unroll
    for (int e = 0; e < 16; e += VEC) {
      const int n = min(max(valid - off - e, 0), VEC);
      cp_async_n<VEC>(dst + e, n > 0 ? src + off + e : src, n);
    }
  }
}

__device__ __forceinline__ int swz(int row, int chunk) {  // byte offset of a 16-byte chunk
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x2(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  mm::mma_bf16(d, a, b0, b1);
}

// d += a (16 x 32, row) . b (32 x 8, col), s8 in, exact s32 sum
__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Planes {
  const int* p[kPlanes];  // ids, users, docs, live, scales (as int bits; int8 form)
};

struct Item {
  int c, tile, job, np, qi;  // cluster, slot tile, job, its pairs, this thread's query row
};

template <int KIND, int VEC>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(KIND))
    probe_kernel(const unsigned char* __restrict__ q, const unsigned char* __restrict__ buckets,
                 Planes planes, Scratch s, float* __restrict__ scores,
                 int* __restrict__ ids_out, int B, int row_bytes, int ntiles, int nchunk) {
  constexpr int NPL = KIND == KIND_I8 ? 5 : 4;
  using Acc = std::conditional_t<KIND == KIND_I8, int, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* side = smem + kStages * kStageBytes;  // the current item's planes and pairs
  const int* spl = reinterpret_cast<const int*>(side);
  const int4* spair = reinterpret_cast<const int4*>(side + kPairOff);
  const int* smeta = reinterpret_cast<const int*>(side + kMetaOff);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long nitems = static_cast<long long>(*s.njobs) * ntiles;
  const long long w0 = nitems * blockIdx.x / gridDim.x;
  const int my_items = static_cast<int>(nitems * (blockIdx.x + 1) / gridDim.x - w0);
  const int total = my_items * nchunk;
  if (total == 0) return;

  // descriptors: the job record two items ahead, the item (and the query row
  // this thread copies) one ahead
  auto record = [&](int il) -> int4 {
    return il < my_items ? __ldg(s.jobs + (w0 + il) / ntiles) : make_int4(0, 0, 0, 1);
  };
  auto item = [&](int il, int4 rec) -> Item {
    Item it{0, 0, 0, 0, -1};
    if (il < my_items) {
      const int local = static_cast<int>(w0 + il - static_cast<long long>(rec.z) * ntiles);
      const int k = local % rec.w;
      it.c = rec.x;
      it.tile = local / rec.w;
      it.job = rec.z + k;
      it.np = min(kGP, rec.y - k * kGP);
      const int r = tid >> 3;
      if (r < it.np) it.qi = __ldg(&s.pinfo[static_cast<size_t>(it.job) * kGP + r].y);
    }
    return it;
  };
  Item cur = item(0, record(0));
  int4 rec2 = record(1);
  Item nxt = item(1, rec2);
  rec2 = record(2);

  auto fetch = [&](int step) {
    if (step < total) {
      const int il = step / nchunk, chunk = step % nchunk;
      if (chunk == 0 && il > 0) {
        cur = nxt;
        nxt = item(il + 1, rec2);
        rec2 = record(il + 2);
      }
      unsigned char* st = smem + (step % kStages) * kStageBytes;
      const int col0 = chunk * kRowBytes;
      const int valid = min(kRowBytes, row_bytes - col0);
      const size_t slot0 = static_cast<size_t>(cur.c) * B + static_cast<size_t>(cur.tile) * kSlots;
      const int nslots = min(kSlots, B - cur.tile * kSlots);
#pragma unroll
      for (int i = 0; i < kSlots * 8 / kThreads; ++i) {
        const int e = tid + i * kThreads;  // 16-byte chunk: slot e / 8, chunk e % 8
        const int r = e >> 3, ch = e & 7;
        if (r < nslots)
          fetch16<VEC>(st + swz(r, ch), buckets + (slot0 + r) * row_bytes + col0, ch * 16, valid);
      }
      {  // the job's query rows: one 16-byte chunk a thread
        const int r = tid >> 3, ch = tid & 7;
        if (r < cur.np)
          fetch16<VEC>(st + kQOff + swz(r, ch),
                       q + static_cast<size_t>(cur.qi) * row_bytes + col0, ch * 16, valid);
      }
      if (chunk == 0) {  // the item's predicate planes, pair table and meta
        unsigned char* sd = st + kSideOff;
        for (int e = tid; e < NPL * kSlots; e += kThreads) {
          const int k = e / kSlots, r = e % kSlots;
          const int* src = k == 0   ? planes.p[0]
                           : k == 1 ? planes.p[1]
                           : k == 2 ? planes.p[2]
                           : k == 3 ? planes.p[3]
                                    : planes.p[4];
          if (r < nslots) cp_async_n<4>(sd + e * 4, src + slot0 + r, 4);
        }
        if (tid < cur.np)
          cp_async_n<16>(sd + kPairOff + tid * 16,
                         s.pinfo + static_cast<size_t>(cur.job) * kGP + tid, 16);
        if (tid == 0) {
          int* meta = reinterpret_cast<int*>(sd + kMetaOff);
          meta[0] = cur.np;
          meta[1] = cur.tile;
        }
      }
    }
    mm::cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) fetch(st);

  Acc acc[kGP / 8][4];  // tensor cores: n8 tile x the m16n8 fragment
  float facc[kGP];      // f32: a pair each
#pragma unroll
  for (int t = 0; t < kGP / 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0;
#pragma unroll
  for (int r = 0; r < kGP; ++r) facc[r] = 0.f;

  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix rows: A = 16 slots x 32 bytes (rows 0-7 | 8-15) x (bytes 0-15 |
  // 16-31); B = 8 query rows x (bytes 0-15 | 16-31), lanes 0-15
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;
  const int b_row = lane & 7, b_half = (lane >> 3) & 1;
  // f32: two lanes a slot, 16 columns each
  const int f_row = warp * 16 + (lane >> 1), f_half = lane & 1;

  for (int step = 0; step < total; ++step) {
    mm::cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(step + kStages - 1);
    const int chunk = step % nchunk;
    const unsigned char* st = smem + (step % kStages) * kStageBytes;
    if (chunk == 0) {  // the item's planes and pairs stay in `side` until its epilogue
      const int4* from = reinterpret_cast<const int4*>(st + kSideOff);
      for (int e = tid; e < kSideBytes / 16; e += kThreads)
        reinterpret_cast<int4*>(side)[e] = from[e];
      __syncthreads();
    }
    const int np = smeta[0];
    const unsigned char* qs = st + kQOff;

    if constexpr (KIND == KIND_F32) {
      // a lane's 4 chunks: 4 slots x 2 halves of a quarter-warp hit 8 bank groups
      float4 rv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rv[j] = *reinterpret_cast<const float4*>(st + swz(f_row, f_half * 4 + j));
#pragma unroll
      for (int r = 0; r < kGP; ++r) {
        if (r < np) {
          float a = facc[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + swz(r, f_half * 4 + j));
            a = fmaf(rv[j].x, qv.x, a);
            a = fmaf(rv[j].y, qv.y, a);
            a = fmaf(rv[j].z, qv.z, a);
            a = fmaf(rv[j].w, qv.w, a);
          }
          facc[r] = a;
        }
      }
    } else {
      const int nt = (np + 7) >> 3;
#pragma unroll
      for (int kk = 0; kk < kRowBytes / 32; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, st + swz(a_row, kk * 2 + a_half));
#pragma unroll
        for (int t = 0; t < kGP / 8; ++t) {
          if (t < nt) {
            unsigned b0, b1;
            ldmatrix_x2(b0, b1, qs + swz(t * 8 + b_row, kk * 2 + b_half));
            mma(acc[t], a, b0, b1);
          }
        }
      }
    }

    if (chunk == nchunk - 1) {  // the item is done: predicate, fillers, rows out
      const int tile0 = smeta[1] * kSlots;
      auto emit = [&](int r, int sl, Acc v) {
        const int slot = tile0 + sl;
        if (r >= np || slot >= B) return;
        const int4 pr = spair[r];  // pair, query, tenant, document
        const bool ok = spl[3 * kSlots + sl] != 0 && spl[kSlots + sl] == pr.z &&
                        (pr.w < 0 || spl[2 * kSlots + sl] == pr.w);
        float out;
        if constexpr (KIND == KIND_I8) {
          out = ok ? __fmul_rn(static_cast<float>(v), __int_as_float(spl[4 * kSlots + sl]))
                   : __int_as_float(static_cast<int>(0xff800000u));  // -inf
        } else {
          out = ok ? v : kNeg;
        }
        const size_t o = static_cast<size_t>(pr.x) * B + slot;
        scores[o] = out;
        ids_out[o] = spl[sl];
      };
      if constexpr (KIND == KIND_F32) {
#pragma unroll
        for (int r = 0; r < kGP; ++r) {
          if (r < np) {
            const float v = facc[r] + __shfl_xor_sync(0xffffffffu, facc[r], 1);
            if (f_half == (r & 1)) emit(r, f_row, v);
          }
          facc[r] = 0.f;
        }
      } else {
#pragma unroll
        for (int t = 0; t < kGP / 8; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            emit(t * 8 + tq * 2 + (i & 1), warp * 16 + g + (i >> 1) * 8, acc[t][i]);
            acc[t][i] = 0;
          }
      }
    }
  }
  mm::cp_async_wait<0>();
}

template <int KIND, int VEC>
int launch_probe(int grid, const void* q, const void* buckets, const Planes& planes,
                 const Scratch& s, void* scores, void* ids_out, int B, int row_bytes, int ntiles,
                 int nchunk, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_kernel<KIND, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  probe_kernel<KIND, VEC><<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const unsigned char*>(q), static_cast<const unsigned char*>(buckets), planes,
      s, static_cast<float*>(scores), static_cast<int*>(ids_out), B, row_bytes, ntiles, nchunk);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_vec(int vec, int grid, const void* q, const void* buckets, const Planes& planes,
               const Scratch& s, void* scores, void* ids_out, int B, int row_bytes, int ntiles,
               int nchunk, cudaStream_t st) {
  switch (vec) {
    case 16:
      return launch_probe<KIND, 16>(grid, q, buckets, planes, s, scores, ids_out, B, row_bytes,
                                    ntiles, nchunk, st);
    case 8:
      return launch_probe<KIND, 8>(grid, q, buckets, planes, s, scores, ids_out, B, row_bytes,
                                   ntiles, nchunk, st);
    case 4:
      return launch_probe<KIND, 4>(grid, q, buckets, planes, s, scores, ids_out, B, row_bytes,
                                   ntiles, nchunk, st);
    default:
      return launch_probe<KIND, 0>(grid, q, buckets, planes, s, scores, ids_out, B, row_bytes,
                                   ntiles, nchunk, st);
  }
}

// group the pairs, then probe; `kind` picks the product, the copy width
// follows the alignment of the rows and of the two row tensors
int run(int kind, const void* q, const void* buckets, const Planes& planes, const void* probes,
        const void* uids, const void* dids, void* scores, void* ids_out, void* scratch,
        long long scratch_size, int nq, int nprobe, int C, int B, int d, int esize,
        cudaStream_t st) {
  if (nq < 0 || nprobe < 0 || B < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || nprobe == 0 || B == 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(nq) * nprobe;
  if (pairs >= (1ll << 31) || static_cast<long long>(scratch_bytes(pairs, C)) > scratch_size)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_layout(scratch, pairs, C);
  const size_t group_smem = C <= kGroupSmemClusters ? static_cast<size_t>(C) * 4 : 0;
  probe_group_kernel<<<1, kGroupThreads, group_smem, st>>>(
      static_cast<const int*>(probes), static_cast<const int*>(uids),
      static_cast<const int*>(dids), static_cast<int>(pairs), nprobe, C, s);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const int row_bytes = d * esize;
  const int ntiles = (B + kSlots - 1) / kSlots;
  const int nchunk = (row_bytes + kRowBytes - 1) / kRowBytes;
  const long long items = max_jobs(pairs, C) * ntiles;
  const long long slots = static_cast<long long>(mm::sm_count()) * blocks_per_sm(kind);
  const int grid = static_cast<int>(items < slots ? items : slots);
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(buckets) |
                          static_cast<uintptr_t>(row_bytes);
  const int vec = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : 0;
  switch (kind) {
    case KIND_BF16:
      return launch_vec<KIND_BF16>(vec, grid, q, buckets, planes, s, scores, ids_out, B,
                                   row_bytes, ntiles, nchunk, st);
    case KIND_I8:
      return launch_vec<KIND_I8>(vec, grid, q, buckets, planes, s, scores, ids_out, B,
                                 row_bytes, ntiles, nchunk, st);
    default:
      return launch_vec<KIND_F32>(vec, grid, q, buckets, planes, s, scores, ids_out, B,
                                  row_bytes, ntiles, nchunk, st);
  }
}

}  // namespace

// Bytes of the scratch buffer a call over C clusters with nq x nprobe pairs
// needs (the wrapper allocates it).
extern "C" long long mm_ivf_probe_scratch(int C, int nq, int nprobe) {
  return static_cast<long long>(
      scratch_bytes(static_cast<long long>(nq) * nprobe, C > 0 ? C : 0));
}

// q: (nq, d) of dt; buckets: (C, B, d) of dt; bucket_ids, users, docs, live:
// (C, 1, B) int32; probes: (nq, nprobe) int32; uids, dids: (nq,) int32;
// scores: (nq, nprobe, B) f32; ids_out: (nq, nprobe, B) int32; scratch:
// mm_ivf_probe_scratch bytes.
extern "C" int mm_ivf_probe(void* q, void* buckets, void* bucket_ids, void* users, void* docs,
                            void* live, void* probes, void* uids, void* dids, void* scores,
                            void* ids_out, void* scratch, long long scratch_size, int nq,
                            int nprobe, int C, int B, int d, int dt, void* stream) {
  const Planes planes{{static_cast<const int*>(bucket_ids), static_cast<const int*>(users),
                       static_cast<const int*>(docs), static_cast<const int*>(live), nullptr}};
  int kind, esize;
  if (dt == mm::DT_BF16) {
    kind = KIND_BF16;
    esize = 2;
  } else if (dt == mm::DT_F32) {
    kind = KIND_F32;
    esize = 4;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(kind, q, buckets, planes, probes, uids, dids, scores, ids_out, scratch,
             scratch_size, nq, nprobe, C, B, d, esize, static_cast<cudaStream_t>(stream));
}

// The int8 form: q (nq, d) int8 quantized query values; buckets (C, B, d)
// int8; scales (C, 1, B) f32; the rest as above.
extern "C" int mm_ivf_probe_q(void* q, void* buckets, void* scales, void* bucket_ids,
                              void* users, void* docs, void* live, void* probes, void* uids,
                              void* dids, void* scores, void* ids_out, void* scratch,
                              long long scratch_size, int nq, int nprobe, int C, int B, int d,
                              void* stream) {
  const Planes planes{{static_cast<const int*>(bucket_ids), static_cast<const int*>(users),
                       static_cast<const int*>(docs), static_cast<const int*>(live),
                       static_cast<const int*>(scales)}};
  return run(KIND_I8, q, buckets, planes, probes, uids, dids, scores, ids_out, scratch,
             scratch_size, nq, nprobe, C, B, d, 1, static_cast<cudaStream_t>(stream));
}
