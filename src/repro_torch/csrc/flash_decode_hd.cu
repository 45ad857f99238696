// Kernels B2s and B2a: paged single-token decode attention split by
// head_dim (the head_dim layout of tensor parallelism), for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py::_splits_pallas (B2) where
// the reference's pool is sharded on head_dim: its kv heads do not divide
// the model axis, so each rank holds every kv head's head_dim slice of
// the pages (src/repro/parallel/sharding.py::_kv_model_axes), and a
// rank's keys give only partial dot products. The decode then runs in
// three steps, the middle one outside any kernel:
//   B2s  partial scores: for each (slot b, q head h, key j) the dot
//        product of the rank's q slice with key row j's slice, over the
//        slot's live keys, read through the trash-redirected page table;
//        dead and trash pages and keys outside the live range give 0
//        without a load; the last column is the new token's self term
//        (from k_new). Out: sc (B, H, T + 1) f32, T = NP * page.
//   an all-reduce of sc over the model axis, in rank order;
//   B2a  attend: s = sc * scale (hd^-0.5 of the whole head_dim), the masks
//        (kv_start <= j < pos, j > pos - window when window > 0; the self
//        column always live), one f32 softmax (max, sum of exp, each
//        probability divided by the sum and rounded to the output's
//        type), then the probabilities times the rank's V slice over the
//        same keys plus v_new, summed in f32. Out: (B, 1, H, D) in q's
//        type. A pos = -1 lane has no live key: its output is exactly its
//        v_new slice (probability 1).
// This is the arithmetic of the port's dense head_dim decode
// (models/layers.py::_sdpa_decode with tp): the scale after the
// all-reduce, probabilities in the activations' type, f32 sums. No online
// softmax: the value sum starts once each head's max and sum are final.
//
//   q (B, 1, KVH * G, D) f32|bf16 (the rank's head_dim slice, unscaled)
//   k_pages, v_pages (P+1, page, KVH, D) f32|bf16 (one layer of the
//     rank's pool; the last page is the trash page); k_new, v_new (B, 1,
//     KVH, D) in the pool's type
//   phys (B, NP) int32 physical page ids, trash-redirected
//   pos, kv_start (B,) int32; window (scalar)
//
// Bound on the H100: bytes. B2s reads each live key row slice once (D
// elements) and does 2 * G * D flops on it; B2a reads each live value row
// slice once and the scores, 2 * G * D flops a row. At D = 16 (qwen1.5-4b
// over 8 ranks) a row slice is 32 bytes of bf16, and one slot's live keys
// are a few hundred: far from either peak, the time goes to chains of
// dependent steps (positions, page ids, pages, scores, exchanges), each a
// memory round trip or a few hundred cycles of one thread's serial work
// (scripts/hd_phases.py). The design shortens those chains and spreads a
// slot over many SMs.
//
// Design (the plan's numbers come from the host rule
// kernels/flash_decode.py::hd_plan, a function of shapes alone):
//  * A page's slice in shared memory (SliceGeom): the rows (key t, kv head)
//    of the block's kv heads, each D elements as whole 16-byte chunks,
//    zero-padded; key t's rows at t * pitch chunks, pitch odd so that
//    lanes on consecutive keys read distinct banks. A page of the pool is
//    one contiguous (page, KVH, D) block: all the pages a block needs are
//    issued at once by 16-byte cp.async (each thread's chunk places set
//    once, PageCopy), in rounds of as many as RING_BYTES holds. A pool at
//    an offset that is not 16-byte aligned, or rows that are not whole
//    chunks, are copied element by element into the same layout, in the
//    same kernel: the arithmetic that follows is the same, so are the
//    bits. 256 threads a block; every loop's lanes are placed once
//    (Lanes), no division inside a loop.
//  * Kv heads: a block (B2s) or cluster (B2a) takes the kv heads of one
//    group (grid z), as many as keep a page's slice within HD_SLICE_BYTES
//    and B2a's value columns within the block; qwen1.5-4b's 20 take one.
//  * B2s: a block a (page range, slot, group), about two blocks an SM (8
//    slots x 32 blocks of one page at qwen's slice; one block an SM was
//    slower at gemma3-4b's). Every input load (position, the range's page
//    ids, q's slice, k_new) is in flight before the first is used; q and
//    k_new sit in shared memory in f32. The live pages land while the
//    block writes the self column (the block that holds the slot's last
//    live page, block 0 when none is live) and the dead and trash pages'
//    zeros (float4 where a 16-byte granule lies inside the row's dead
//    columns). Lanes map to (key, head), key fastest: each reads its row
//    in 16-byte chunks, and the score stores coalesce. Keys of a live page
//    outside the live range store 0 without a load.
//  * B2a: a thread block cluster of `cs` CTAs a (slot, group), one wave of
//    16-CTA clusters at qwen's slice; CTA r takes the r-th contiguous
//    chunk of the slot's live keys (ceil(n / cs) keys), so the live ranks
//    are a prefix. A rank without a key leaves at once, before any cluster
//    barrier (no rank then reads or writes its memory); with no live key
//    at all, rank 0 stays alone.
//     - Loads: the position, the slot's whole page table and the self
//       scores together; then the chunk's scores (aligned float4 granules
//       of sc, into a cache in shared memory by cp.async) and all its V
//       pages at once.
//     - Statistics: each head's max over the chunk (a fixed shuffle tree
//       over the lanes of a head), pushed into every live rank's shared
//       memory (st.async onto an mbarrier), folded in rank order with the
//       self term last; then the sum of exp(s - max) the same way. Every
//       rank holds the same final max and sum. (Every CTA computing both
//       over the whole live range, without the exchanges, measured
//       slower: its per-thread work grew with the slot.) A chunk too long
//       for the cache (HD_SCORE_BYTES) reads sc again.
//     - Value sum: the chunk's probabilities, rounded to q's type, in
//       place in the cache; threads map to (kv head, 16-byte chunk)
//       columns times key groups, and each adds p x v for all G query
//       heads of its kv head, so V is read once a slot whatever G is. Key
//       groups are added in order.
//     - Fold: the live ranks own contiguous slices of the (H, D) outputs;
//       each rank pushes its partial's slices to their owners (st.async),
//       an owner adds them in rank order, then p_self x v_new last, and
//       stores in q's type.
//    Every sum runs in one fixed order, so two launches give the same
//    bits; expf is the accurate one (no fast math).

#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flashc;

// Phase timestamps of each block, for scripts/hd_phases.py: built only
// with -DHD_PROFILE; thread 0 of each block writes clock64() at phase i
// to slot i of its 16 slots, and the global timer at its start and end
// to slots 14 and 15 (end: phase 13).
// The buffer's address is read once, at the kernel's start (PROF_INIT),
// so a stamp adds no memory round trip to the phase it ends.
#ifdef HD_PROFILE
__device__ long long* hd_prof = nullptr;
#define PROF_INIT                                                        \
  long long* const prof_ =                                               \
      threadIdx.x == 0 && hd_prof != nullptr                             \
          ? hd_prof + 16 * (blockIdx.x +                                 \
                            gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) \
          : nullptr
__device__ __forceinline__ void stamp_at(long long* p, int i) {
  if (p != nullptr) {
    p[i] = clock64();
    if (i == 0 || i == 13) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      p[i == 0 ? 14 : 15] = (long long)t;
    }
  }
}
#define stamp(i) stamp_at(prof_, i)
#else
#define PROF_INIT
#define stamp(i)
#endif

// Shared memory for a block's page slices at most: the pages it needs go
// in rounds of as many as fit.
constexpr size_t RING_BYTES = 96 * 1024;

template <typename T>
__device__ __forceinline__ float rounded(float x);
template <>
__device__ __forceinline__ float rounded<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__host__ __device__ inline size_t r16(size_t n) { return (n + 15) / 16 * 16; }

// One page's slice of kvhg kv heads in shared memory: rows of nch 16-byte
// chunks (epc elements each), key t's rows at t * pitch chunks; `round`
// slices a round of pages, for a block that needs `need` pages.
struct SliceGeom {
  int epc, nch, pitch, round;
  size_t bytes;
  __host__ __device__ SliceGeom(int kvhg, int D, int elsize, int ps,
                                int need) {
    epc = 16 / elsize;
    nch = (D + epc - 1) / epc;
    pitch = (kvhg * nch) | 1;
    bytes = (size_t)ps * pitch * 16;
    const size_t fit = RING_BYTES / bytes;
    round = fit < 1 ? 1 : (fit < (size_t)need ? (int)fit : need);
  }
  __host__ __device__ size_t ring_bytes() const { return round * bytes; }
};

// Threads of a block of B2s and of B2a.
constexpr int HT = 256;

// A lane's fixed place in a loop over n items of `groups` rows: lanes
// per row (a power of two >= n, at most 32, or n when n > 32 is cut into
// strides), rows at once, and this thread's row and lane. Computed once,
// so the loops that use it divide nothing.
struct Lanes {
  int per, rows, row, lane;
  __device__ __forceinline__ explicit Lanes(int n) {
    per = 1;
    while (per < n && per < 32) per *= 2;
    rows = HT / per;
    row = threadIdx.x / per;
    lane = threadIdx.x - row * per;
  }
};

// Copies of whole pages into slices: by 16-byte cp.async when `vec` (rows
// of whole chunks, the pool 16-byte aligned; each thread's chunks of a
// page, their (key, chunk) places, are set once), else element by element
// (only keys r0 .. r1-1), pads zeroed. All threads of the block call
// page().
template <typename KT>
struct PageCopy {
  const KT* pool;
  size_t tok;                 // elements a token of the pool
  int kvh0, ng, D, ps, per, r, c, dr, dc;
  bool vec;
  __device__ __forceinline__ PageCopy(const KT* pool_, int KVH, int kvh0_,
                                      int ng_, int D_, int ps_,
                                      const SliceGeom& s, bool vec_)
      : pool(pool_), tok((size_t)KVH * D_), kvh0(kvh0_), ng(ng_), D(D_),
        ps(ps_), vec(vec_) {
    per = ng * s.nch;
    r = threadIdx.x / per;
    c = threadIdx.x - r * per;
    dr = HT / per;
    dc = HT - dr * per;
  }
  __device__ __forceinline__ void page(unsigned char* dst, int id, int r0,
                                       int r1, const SliceGeom& s) const {
    const KT* base = pool + (size_t)id * ps * tok + (size_t)kvh0 * D;
    if (vec) {
      const int n = ps * per;
      int rr = r, cc = c;
      for (int i = threadIdx.x; i < n; i += HT) {
        cp_async16(dst + ((size_t)rr * s.pitch + cc) * 16,
                   reinterpret_cast<const unsigned char*>(base + rr * tok) +
                       (size_t)cc * 16);
        rr += dr;
        cc += dc;
        if (cc >= per) {
          cc -= per;
          ++rr;
        }
      }
    } else {
      using Raw =
          std::conditional_t<sizeof(KT) == 2, unsigned short, unsigned>;
      const Raw* src = reinterpret_cast<const Raw*>(base);
      const int w = s.nch * s.epc, pr = ng * w, n = (r1 - r0) * pr;
      for (int i = threadIdx.x; i < n; i += HT) {
        const int q = i / pr, rem = i - q * pr, k = rem / w, e = rem - k * w;
        const int t = r0 + q;
        Raw* d = reinterpret_cast<Raw*>(
            dst + ((size_t)t * s.pitch + (size_t)k * s.nch) * 16);
        d[e] = e < D ? src[t * tok + (size_t)k * D + e] : Raw(0);
      }
    }
  }
};

// Whether a pool's rows can go by cp.async.
template <typename KT>
__device__ __forceinline__ bool vector_rows(const KT* pool, int D,
                                            const SliceGeom& s) {
  return D % s.epc == 0 && (reinterpret_cast<uintptr_t>(pool) & 15) == 0;
}

// A row of nch chunks of KT in shared memory times q's row (f32, padded
// to whole chunks), in element order.
template <typename KT>
__device__ __forceinline__ float row_dot(const unsigned char* row,
                                         const float* qh, int nch) {
  constexpr int EPC = Elems<KT>::N;
  const float4* q4 = reinterpret_cast<const float4*>(qh);
  float acc = 0.f;
  for (int c = 0; c < nch; ++c) {
    float kf[EPC];
    Elems<KT>::get(reinterpret_cast<const uint4*>(row)[c], kf);
#pragma unroll
    for (int i = 0; i < EPC / 4; ++i) {
      const float4 qv = q4[c * (EPC / 4) + i];
      acc = fmaf(qv.x, kf[4 * i], acc);
      acc = fmaf(qv.y, kf[4 * i + 1], acc);
      acc = fmaf(qv.z, kf[4 * i + 2], acc);
      acc = fmaf(qv.w, kf[4 * i + 3], acc);
    }
  }
  return acc;
}

// Zeros to columns [c0, c1) of hg rows `row` floats apart from out: one
// 16-byte granule a lane, a float4 store where it lies inside.
__device__ __forceinline__ void zero_cols(float* out, size_t row, int hg,
                                          int c0, int c1) {
  if (c0 >= c1) return;
  const int U = (c1 - c0 + 3) / 4 + 1;            // granules a row touches
  const Lanes ln(U);
  for (int h = ln.row; h < hg; h += ln.rows) {
    float* lo = out + (size_t)h * row + c0;
    float* hi = lo + (c1 - c0);
    float* g0 = reinterpret_cast<float*>(reinterpret_cast<uintptr_t>(lo) &
                                         ~(uintptr_t)15);
    for (int u = ln.lane; u < U; u += ln.per) {
      float* g = g0 + 4 * u;
      if (g >= hi) break;
      if (g >= lo && g + 4 <= hi) {
        *reinterpret_cast<float4*>(g) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int k = 0; k < 4; ++k)
          if (g + k >= lo && g + k < hi) g[k] = 0.f;
      }
    }
  }
}

// Shared memory of a B2s block: q (kvhg * G rows of nch * epc floats),
// k_new (kvhg rows of D floats), the range's page ids, a round of pages.
struct ScoreSmem {
  size_t kn, ids, ring, total;
  __host__ __device__ ScoreSmem(const SliceGeom& s, int kvhg, int G, int D,
                                int ppb) {
    kn = r16(sizeof(float) * (size_t)kvhg * G * s.nch * s.epc);
    ids = kn + r16(sizeof(float) * (size_t)kvhg * D);
    ring = ids + r16(sizeof(int) * (size_t)ppb);
    total = ring + s.ring_bytes();
  }
};

template <typename KT, typename QT>
__global__ void __launch_bounds__(HT)
hd_scores_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                 const KT* __restrict__ k_new, const int* __restrict__ phys,
                 const int* __restrict__ pos, const int* __restrict__ kvs,
                 int window, float* __restrict__ sc, int KVH, int G, int D,
                 int ps, int NP, int kvhg, int ppb) {
  extern __shared__ __align__(16) unsigned char smem[];
  PROF_INIT;
  stamp(0);
  const int tid = threadIdx.x;
  const int c = blockIdx.x, b = blockIdx.y, kvh0 = blockIdx.z * kvhg;
  const int ng = min(kvhg, KVH - kvh0), hg = ng * G, H = KVH * G;
  const int T = NP * ps;
  const size_t row = (size_t)T + 1;
  const SliceGeom sg(kvhg, D, sizeof(KT), ps, ppb);
  const ScoreSmem L(sg, kvhg, G, D, ppb);
  float* q_s = reinterpret_cast<float*>(smem);
  float* kn_s = reinterpret_cast<float*>(smem + L.kn);
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  unsigned char* ring = smem + L.ring;
  const int p0 = c * ppb, p1 = min(NP, p0 + ppb), npr = p1 - p0;
  const int qw = sg.nch * sg.epc, nq = hg * D, nk = ng * D;
  const QT* qb = q + ((size_t)b * H + (size_t)kvh0 * G) * D;
  const KT* knb = k_new + ((size_t)b * KVH + kvh0) * D;
  // every input load in flight before the first is used: the position,
  // the range's page ids, q's slice and k_new
  const int p = pos[b];
  int lo = kvs[b];
  const int idv = tid < npr ? phys[(size_t)b * NP + p0 + tid] : 0;
  float qv[2], kv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * HT;
    qv[u] = i < nq ? to_f(qb[i]) : 0.f;
    kv[u] = i < nk ? to_f(knb[i]) : 0.f;
  }
  if (tid < npr) ids[tid] = idv;
  for (int i = tid + HT; i < npr; i += HT) ids[i] = phys[(size_t)b * NP + p0 + i];
  if (qw == D) {                     // q's rows need no padding
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (tid + u * HT < nq) q_s[tid + u * HT] = qv[u];
    for (int i = tid + 2 * HT; i < nq; i += HT) q_s[i] = to_f(qb[i]);
  } else {
    for (int i = tid; i < hg * qw; i += HT) {
      const int h = i / qw, d = i - h * qw;
      q_s[i] = d < D ? to_f(qb[(size_t)h * D + d]) : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (tid + u * HT < nk) kn_s[tid + u * HT] = kv[u];
  for (int i = tid + 2 * HT; i < nk; i += HT) kn_s[i] = to_f(knb[i]);
  if (window > 0 && p - window + 1 > lo) lo = p - window + 1;
  const int hi = min(p, T);
  const int a = max(lo, p0 * ps), e = min(hi, p1 * ps);
  const bool any = a < e;
  const int pa = any ? a / ps : p1, pb = any ? (e - 1) / ps + 1 : p1;
  float* out = sc + ((size_t)b * H + (size_t)kvh0 * G) * row;
  stamp(1);
  __syncthreads();                                  // ids, q_s, kn_s
  stamp(2);
  const PageCopy<KT> cp(kp, KVH, kvh0, ng, D, ps, sg, vector_rows(kp, D, sg));
  // a lane keeps its key t; heads step by hp, kv heads by hp / G
  const int tpl = min(ps, HT), hp = HT / tpl;
  const int t_l = tid % tpl, h_l = tid / tpl;
  const int dk = hp / G, dg = hp - dk * G;
  // the live pages in rounds, each round's pages all in flight at once
  for (int r0 = pa; r0 < pb; r0 += sg.round) {
    const int r1 = min(pb, r0 + sg.round);
    for (int pg = r0; pg < r1; ++pg) {
      const int t0 = pg * ps;
      cp.page(ring + (size_t)(pg - r0) * sg.bytes, ids[pg - p0],
              max(a - t0, 0), min(e - t0, ps), sg);
    }
    cp_async_commit();
    if (r0 == pa) {
      // while the first round lands: the self column, from the block
      // that holds the slot's last live page, and the dead pages' zeros
      const int last = lo < hi ? (hi - 1) / ps : 0;
      if (c == last / ppb) {
        for (int h = tid; h < hg; h += HT) {
          const float* k = kn_s + (size_t)(h / G) * D;
          const float* qh = q_s + (size_t)h * qw;
          float acc = 0.f;
          for (int d = 0; d < D; ++d) acc = fmaf(qh[d], k[d], acc);
          out[(size_t)h * row + T] = acc;
        }
      }
      zero_cols(out, row, hg, p0 * ps, pa * ps);
      zero_cols(out, row, hg, pb * ps, p1 * ps);
      stamp(3);
    }
    cp_async_wait(0);
    __syncthreads();
    if (r0 == pa) stamp(4);
    for (int pg = r0; pg < r1; ++pg) {
      const int t0 = pg * ps;
      const int k0 = max(a - t0, 0), k1 = min(e - t0, ps);
      const unsigned char* slot = ring + (size_t)(pg - r0) * sg.bytes;
      for (int t = t_l; t < ps; t += tpl) {
        const bool live = t >= k0 && t < k1;
        const unsigned char* krow = slot + (size_t)t * sg.pitch * 16;
        float* o = out + t0 + t;
        int kv_h = h_l / G, g = h_l - kv_h * G;
        for (int h = h_l; h < hg; h += hp) {
          const float v =
              live ? row_dot<KT>(krow + (size_t)kv_h * sg.nch * 16,
                                 q_s + (size_t)h * qw, sg.nch)
                   : 0.f;
          o[(size_t)h * row] = v;
          kv_h += dk;
          g += dg;
          if (g >= G) {
            g -= G;
            ++kv_h;
          }
        }
      }
    }
    __syncthreads();
  }
  if (!any) {                 // no live page: the self column and zeros
    const int last = lo < hi ? (hi - 1) / ps : 0;
    if (c == last / ppb) {
      for (int h = tid; h < hg; h += HT) {
        const float* k = kn_s + (size_t)(h / G) * D;
        const float* qh = q_s + (size_t)h * qw;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qh[d], k[d], acc);
        out[(size_t)h * row + T] = acc;
      }
    }
    zero_cols(out, row, hg, p0 * ps, p1 * ps);
  }
  stamp(13);
}

// The score cache of a B2a CTA: its chunk's scores for every head of the
// group, as the aligned 16-byte granules of sc that hold them (granule 0
// of head h holds key ka at element off(h)), at most kmax granules a
// head. Kept when it fits HD_SCORE_BYTES, else the chunk is read from sc
// again, in the same granules.
constexpr size_t HD_SCORE_BYTES = 96 * 1024;

// Shared memory of a B2a CTA: three mbarriers, the slot's page table, per
// head the self score, the CTA's partial, the final max and sum, the self
// term's probability and the chunk's offset in its first granule; the push slots of the max and the
// sum (cs x hg each) and of the outputs (at most hg * D + cs floats); the
// score cache; a round of pages, which the key groups' partials reuse
// once the last is read.
struct AttendSmem {
  size_t ptab, sself, part, mfin, lfin, psel, offs, slot_m, slot_l, slot_o,
      cache, ring, total;
  int kmax;
  bool cached;
  __host__ __device__ AttendSmem(const SliceGeom& s, int kvhg, int G, int D,
                                 int ps, int NP, int cs) {
    const size_t hg = (size_t)kvhg * G;
    const int chunk = (NP * ps + cs - 1) / cs;    // keys a CTA at most
    kmax = (chunk + 3) / 4 + 1;                   // granules a head
    cached = 16 * hg * kmax <= HD_SCORE_BYTES;
    ptab = 32;
    sself = ptab + r16(sizeof(int) * (size_t)NP);
    part = sself + r16(4 * hg);
    mfin = part + r16(4 * hg);
    lfin = mfin + r16(4 * hg);
    psel = lfin + r16(4 * hg);
    offs = psel + r16(4 * hg);
    slot_m = offs + r16(4 * hg);
    slot_l = slot_m + r16(4 * (size_t)cs * hg);
    slot_o = slot_l + r16(4 * (size_t)cs * hg);
    cache = slot_o + r16(4 * (hg * D + cs));
    ring = cache + (cached ? 16 * hg * kmax : 0);
    const size_t red = 4 * (size_t)HT * G * s.epc;
    total = ring + (s.ring_bytes() > red ? s.ring_bytes() : red);
  }
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Where a CTA reads its chunk of scores, keys [ka, ka + len) of each head
// h: the aligned granules of sc that hold them, in the cache or in sc.
struct Chunk {
  const float* sb;     // the group's first row of sc
  size_t row;          // floats a row
  int ka, len, kmax;
  const float* cache;  // null: read sc
  __device__ __forceinline__ const float* at(int h) const {
    return sb + (size_t)h * row + ka;
  }
  __device__ __forceinline__ int off(int h) const {
    return (int)((reinterpret_cast<uintptr_t>(at(h)) >> 2) & 3);
  }
  __device__ __forceinline__ const float4* granules(int h) const {
    if (cache != nullptr)
      return reinterpret_cast<const float4*>(cache) + (size_t)h * kmax;
    return reinterpret_cast<const float4*>(
        reinterpret_cast<uintptr_t>(at(h)) & ~(uintptr_t)15);
  }
};

// One statistic of the chunk's scores for each of hg heads, into part[h]:
// the max of s = sc * scale (MAX), else the sum of exp(s - mfin[h]). A
// head's granules go to the lanes of one Lanes row, each lane in order,
// then a fixed shuffle tree.
template <bool MAX>
__device__ __forceinline__ void chunk_stat(const Chunk& ch, const int* offs,
                                           int hg, float scale,
                                           const float* mfin, float* part) {
  const Lanes ln((ch.len + 3) / 4 + 1);
  for (int hb = 0; hb < hg; hb += ln.rows) {
    const int h = hb + ln.row;
    float acc = MAX ? NEG_INF : 0.f;
    if (h < hg && ch.len > 0) {
      const float4* g0 = ch.granules(h);
      const int off = offs[h], kn = (off + ch.len + 3) / 4;
      float m = 0.f;
      if constexpr (!MAX) m = mfin[h];
      for (int k = ln.lane; k < kn; k += ln.per) {
        const float4 v = g0[k];
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int e = 4 * k + x - off;              // key ka + e
          if (e < 0 || e >= ch.len) continue;
          const float sv = __fmul_rn(vv[x], scale);
          if constexpr (MAX)
            acc = fmaxf(acc, sv);
          else
            acc += expf(sv - m);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < ln.per) {
        const float y = __shfl_xor_sync(0xffffffffu, acc, o);
        if constexpr (MAX)
          acc = fmaxf(acc, y);
        else
          acc += y;
      }
    if (ln.lane == 0 && h < hg) part[h] = acc;
  }
}

// Push part[0 .. hg) into slot rank * hg of every owner's `slots`,
// completing on its mbarrier `bar`.
__device__ __forceinline__ void push_heads(const float* part, float* slots,
                                           uint64_t* bar, int rank,
                                           int owners, int hg) {
  for (int i = threadIdx.x; i < owners * hg; i += HT) {
    const int r = i / hg, h = i - r * hg;
    clus::store_async(clus::map_rank(slots + rank * hg + h, r), part[h],
                      clus::map_rank(bar, r));
  }
}

template <typename KT, typename QT, int G>
__global__ void __launch_bounds__(HT)
hd_attend_kernel(const float* __restrict__ sc, const KT* __restrict__ vp,
                 const KT* __restrict__ v_new, const int* __restrict__ phys,
                 const int* __restrict__ pos, const int* __restrict__ kvs,
                 int window, float scale, QT* __restrict__ out, int KVH,
                 int D, int ps, int NP, int kvhg) {
  constexpr int EPC = Elems<KT>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  PROF_INIT;
  stamp(0);
  const int tid = threadIdx.x;
  const int rank = blockIdx.x, cs = gridDim.x, b = blockIdx.y;
  const int kvh0 = blockIdx.z * kvhg;
  const int ng = min(kvhg, KVH - kvh0), hg = ng * G, H = KVH * G;
  const int T = NP * ps;
  const size_t row = (size_t)T + 1;
  const SliceGeom sg(kvhg, D, sizeof(KT), ps, (T + cs - 1) / cs / ps + 2);
  const AttendSmem L(sg, kvhg, G, D, ps, NP, cs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* ptab = reinterpret_cast<int*>(smem + L.ptab);
  float* sself = reinterpret_cast<float*>(smem + L.sself);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* mfin = reinterpret_cast<float*>(smem + L.mfin);
  float* lfin = reinterpret_cast<float*>(smem + L.lfin);
  float* psel = reinterpret_cast<float*>(smem + L.psel);
  int* offs = reinterpret_cast<int*>(smem + L.offs);
  float* slot_m = reinterpret_cast<float*>(smem + L.slot_m);
  float* slot_l = reinterpret_cast<float*>(smem + L.slot_l);
  float* slot_o = reinterpret_cast<float*>(smem + L.slot_o);
  float* cache = reinterpret_cast<float*>(smem + L.cache);
  unsigned char* ring = smem + L.ring;
  const float* sb = sc + ((size_t)b * H + (size_t)kvh0 * G) * row;
  // the position, the slot's page table and the self scores, all in
  // flight at once; the mbarriers set up while they come
  const int p = pos[b];
  int lo = kvs[b];
  int pt[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * HT;
    pt[u] = i < NP ? phys[(size_t)b * NP + i] : 0;
  }
  const float ssv = tid < hg ? sb[(size_t)tid * row + T] : 0.f;
  if (tid == HT - 1) {
    for (int i = 0; i < 3; ++i) clus::mbar_init(bars + i);
    clus::fence_init();
  }
  if (window > 0 && p - window + 1 > lo) lo = p - window + 1;
  const int hi = min(p, T);
  const int n = max(0, hi - lo);
  const int chunk = (n + cs - 1) / cs;
  const int owners = chunk > 0 ? (n + chunk - 1) / chunk : 1;
  if (rank >= owners) {             // no key: leave before any barrier
    stamp(13);
    return;
  }
  const bool sync = owners > 1;
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (tid + u * HT < NP) ptab[tid + u * HT] = pt[u];
  for (int i = tid + 2 * HT; i < NP; i += HT) ptab[i] = phys[(size_t)b * NP + i];
  if (tid < hg) sself[tid] = __fmul_rn(ssv, scale);
  for (int h = tid + HT; h < hg; h += HT)
    sself[h] = __fmul_rn(sb[(size_t)h * row + T], scale);
  const int n_out = hg * D, per = (n_out + owners - 1) / owners;
  const int o_lo = min(n_out, rank * per), o_hi = min(n_out, o_lo + per);
  if (tid == HT - 1) {
    clus::mbar_expect(bars + 0, 4u * owners * hg);
    clus::mbar_expect(bars + 1, 4u * owners * hg);
    clus::mbar_expect(bars + 2, 4u * owners * (o_hi - o_lo));
  }
  if (sync) clus::arrive_relaxed();
  const int ka = lo + rank * chunk, ke = min(hi, ka + chunk);
  const int len = max(0, ke - ka);
  const int pa = len > 0 ? ka / ps : 0;
  const int npg = len > 0 ? (ke - 1) / ps + 1 - pa : 0;
  const Chunk sc_g{sb, row, ka, len, L.kmax, nullptr};
  for (int h = tid; h < hg; h += HT) offs[h] = sc_g.off(h);
  __syncthreads();                                  // ptab, sself, offs
  stamp(1);
  // the chunk's scores into the cache (one group; else toward L2), then
  // the first round of its V pages (another), then v_new at this rank's
  // first output: all of them in flight at once
  if (L.cached) {
    const Lanes ln((len + 3) / 4 + 1);
    for (int h = ln.row; h < hg; h += ln.rows) {
      const float4* g0 = sc_g.granules(h);
      const int kn = len > 0 ? (offs[h] + len + 3) / 4 : 0;
      for (int k = ln.lane; k < kn; k += ln.per)
        cp_async16(cache + ((size_t)h * L.kmax + k) * 4, g0 + k);
    }
  } else if (len > 0) {
    const Lanes ln((len + 31) / 32 + 1);
    for (int h = ln.row; h < hg; h += ln.rows)
      for (int l = ln.lane; 32 * l < len + 32; l += ln.per)
        prefetch_l2(sc_g.at(h) + min(32 * l, len - 1));
  }
  cp_async_commit();
  const PageCopy<KT> cp(vp, KVH, kvh0, ng, D, ps, sg, vector_rows(vp, D, sg));
  auto issue = [&](int r0, int r1) {                // chunk pages r0 .. r1-1
    for (int k = r0; k < r1; ++k) {
      const int t0 = (pa + k) * ps;
      cp.page(ring + (size_t)(k - r0) * sg.bytes, ptab[pa + k],
              max(ka - t0, 0), min(ke - t0, ps), sg);
    }
    cp_async_commit();
  };
  issue(0, min(npg, sg.round));
  const KT* vn = v_new + ((size_t)b * KVH + kvh0) * D;
  float vd = 0.f;
  if (o_lo + tid < o_hi) {
    const int o = o_lo + tid, h = o / D;
    vd = to_f(vn[(size_t)(h / G) * D + (o - h * D)]);
  }
  cp_async_wait(1);                                 // the scores' group
  __syncthreads();
  stamp(2);
  const Chunk ch{sb, row, ka, len, L.kmax, L.cached ? cache : nullptr};

  // the max: this chunk's, then over the live ranks in rank order, then
  // the self term
  chunk_stat<true>(ch, offs, hg, scale, nullptr, part);
  __syncthreads();
  stamp(3);
  if (sync) clus::wait();          // every live rank started, its bars set
  push_heads(part, slot_m, bars + 0, rank, owners, hg);
  clus::mbar_wait(bars + 0);
  for (int h = tid; h < hg; h += HT) {
    float v[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      v[r] = r < owners ? slot_m[r * hg + h] : NEG_INF;
    float m = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) m = fmaxf(m, v[r]);
    mfin[h] = fmaxf(m, sself[h]);
  }
  __syncthreads();
  stamp(4);
  // the sum of exp(s - max) the same way, the self term last
  chunk_stat<false>(ch, offs, hg, scale, mfin, part);
  __syncthreads();
  stamp(5);
  push_heads(part, slot_l, bars + 1, rank, owners, hg);
  clus::mbar_wait(bars + 1);
  for (int h = tid; h < hg; h += HT) {      // ranks past the live ones add 0
    float v[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      v[r] = r < owners ? slot_l[r * hg + h] : 0.f;
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) l += v[r];
    const float lf = l + expf(sself[h] - mfin[h]);
    lfin[h] = lf;
    psel[h] = rounded<QT>(expf(sself[h] - mfin[h]) / lf);
  }
  __syncthreads();
  stamp(6);
  // cached: the chunk's probabilities in place, rounded to q's type, a
  // lane a (head, key)
  if (L.cached && len > 0) {
    const Lanes ln(len);
    for (int h = ln.row; h < hg; h += ln.rows) {
      float* c0 = cache + (size_t)h * L.kmax * 4 + offs[h];
      const float m = mfin[h], l = lfin[h];
      for (int j = ln.lane; j < len; j += ln.per)
        c0[j] = rounded<QT>(expf(__fmul_rn(c0[j], scale) - m) / l);
    }
    __syncthreads();
  }
  stamp(7);

  // the value sum: threads on (kv head, chunk) columns x key groups; a
  // key group steps through the round's keys, its (slot, row) carried
  const int cols = ng * sg.nch, kg = HT / cols;
  const int col = tid % cols, kgi = tid / cols, kvh = col / sg.nch;
  const int dslot = kg / ps, drow = kg - dslot * ps;
  float acc[G][EPC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int x = 0; x < EPC; ++x) acc[g][x] = 0.f;
  const float* prow[G];             // head kvh * G + g's p at key ka + e
  const float* srow[G];             //   or its score (not cached)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int h = min(kvh * G + g, hg - 1);
    prow[g] = cache + (size_t)h * L.kmax * 4 + offs[h];
    srow[g] = sc_g.at(h);
  }
  for (int r0 = 0; r0 < npg; r0 += sg.round) {
    const int r1 = min(npg, r0 + sg.round);
    if (r0 > 0) issue(r0, r1);
    cp_async_wait(0);
    __syncthreads();
    const int t_first = max(ka, (pa + r0) * ps), t_end = min(ke, (pa + r1) * ps);
    if (kgi < kg && t_first + kgi < t_end) {
      int t = t_first + kgi;
      int slot = t / ps - (pa + r0), rw = t - (t / ps) * ps;
      for (; t < t_end; t += kg) {
        float vf[EPC];
        Elems<KT>::get(*reinterpret_cast<const uint4*>(
                           ring + (size_t)slot * sg.bytes +
                           ((size_t)rw * sg.pitch + col) * 16),
                       vf);
        const int e = t - ka;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr =
              L.cached ? prow[g][e]
                       : rounded<QT>(expf(__fmul_rn(srow[g][e], scale) -
                                          mfin[kvh * G + g]) /
                                     lfin[kvh * G + g]);
#pragma unroll
          for (int x = 0; x < EPC; ++x) acc[g][x] = fmaf(pr, vf[x], acc[g][x]);
        }
        slot += dslot;
        rw += drow;
        if (rw >= ps) {
          rw -= ps;
          ++slot;
        }
      }
    }
    __syncthreads();
  }
  stamp(9);
  // the key groups' partials, added in order, pushed to their owners: a
  // thread a (column, head of the group, element) value
  float* red = reinterpret_cast<float*>(ring);
  if (kgi < kg) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int x = 0; x < EPC; ++x)
        red[((size_t)kgi * cols + col) * (G * EPC) + g * EPC + x] = acc[g][x];
  }
  __syncthreads();
  for (int i = tid; i < cols * G * EPC; i += HT) {
    const int c2 = i / (G * EPC), r = i - c2 * (G * EPC);
    const int g = r / EPC, x = r - g * EPC;
    const int kv = c2 / sg.nch, d = (c2 - kv * sg.nch) * EPC + x;
    if (d >= D) continue;
    float sum = 0.f;
    for (int j = 0; j < kg; ++j) sum += red[(size_t)j * cols * G * EPC + i];
    const int o = (kv * G + g) * D + d, ow = o / per;
    clus::store_async(clus::map_rank(slot_o + rank * per + (o - ow * per), ow),
                      sum, clus::map_rank(bars + 2, ow));
  }
  stamp(10);
  // this rank's outputs: the live ranks' partials in rank order, then the
  // new token's term
  clus::mbar_wait(bars + 2);
  stamp(11);
  for (int o = o_lo + tid; o < o_hi; o += HT) {
    float v[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      v[r] = r < owners ? slot_o[r * per + (o - o_lo)] : 0.f;
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) tot += v[r];
    const int h = o / D, d = o - h * D;
    if (o != o_lo + tid) vd = to_f(vn[(size_t)(h / G) * D + d]);
    store(out + ((size_t)b * H + (size_t)kvh0 * G + h) * D + d,
          fmaf(psel[h], vd, tot));
  }
  stamp(13);
}

// Launch kern(args...) over grid in blocks of HT with smem bytes of
// dynamic shared memory, no cluster (the first launch of a kernel on a
// device opts it in to MAX_DYN_SMEM there). With info non-null: write the
// cluster size (1), the blocks of the grid, the blocks the card holds at
// once, the shared memory and the registers a thread to info[0..4] and
// launch nothing.
template <typename... Params, typename... Args>
cudaError_t launch_blocks(void (*kern)(Params...), dim3 grid, size_t smem,
                          cudaStream_t st, int* info, Args... args) {
  static std::mutex mu;
  static std::set<int> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!opted.count(dev)) {
      err = cudaFuncSetAttribute((const void*)kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)MAX_DYN_SMEM);
      if (err != cudaSuccess) return err;
      opted.insert(dev);
    }
  }
  if (info != nullptr) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, (const void*)kern, HT, smem);
    cudaFuncAttributes attrs;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, (const void*)kern);
    if (err != cudaSuccess) return err;
    info[0] = 1;
    info[1] = (int)(grid.x * grid.y * grid.z);
    info[2] = per_sm * sms;
    info[3] = (int)smem;
    info[4] = attrs.numRegs;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(HT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int B, int KVH, int G, int D, int ps, int NP, int kvhg,
               int kv_dtype, int q_dtype) {
  return B <= 0 || B > 65535 || KVH <= 0 || G < 1 || G > MAX_G || D < 1 ||
         D > MAX_D || ps < 1 || NP < 1 || kv_dtype < 0 || kv_dtype > 1 ||
         q_dtype < 0 || q_dtype > 1 || kvhg < 1 || kvhg > KVH ||
         (KVH + kvhg - 1) / kvhg > 65535;
}

// Runs f(KT{}, QT{}) for the pool's and q's types.
template <typename F>
int with_types(int kv_dtype, int q_dtype, F f) {
  if (kv_dtype == 0)
    return q_dtype == 0 ? f(float{}, float{}) : f(float{}, __nv_bfloat16{});
  return q_dtype == 0 ? f(__nv_bfloat16{}, float{})
                      : f(__nv_bfloat16{}, __nv_bfloat16{});
}

}  // namespace

// B2s. q (B, 1, KVH * G, D) in q_dtype; pages, k_new in kv_dtype (0 f32,
// 1 bf16); sc (B, KVH * G, NP * ps + 1) f32. kvhg kv heads a block (grid
// z: ceil(KVH / kvhg) groups), ppb pages a block (grid x). With info
// non-null: the launch's geometry (launch_blocks) and no launch. Returns a
// cudaError_t.
extern "C" int flash_decode_hd_scores_launch(
    const void* q, const void* k_pages, const void* k_new, const void* phys,
    const void* pos, const void* kv_start, int window, void* sc, int B,
    int KVH, int G, int D, int ps, int NP, int kvhg, int ppb, int kv_dtype,
    int q_dtype, void* stream, int* info) {
  if (bad_shape(B, KVH, G, D, ps, NP, kvhg, kv_dtype, q_dtype) || ppb < 1)
    return (int)cudaErrorInvalidValue;
  const SliceGeom sg(kvhg, D, kv_dtype == 0 ? 4 : 2, ps, ppb);
  const size_t smem = ScoreSmem(sg, kvhg, G, D, ppb).total;
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid((NP + ppb - 1) / ppb, B, (KVH + kvhg - 1) / kvhg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(kv_dtype, q_dtype, [&](auto kt, auto qt) {
    using KT = decltype(kt);
    using QT = decltype(qt);
    return (int)launch_blocks(
        hd_scores_kernel<KT, QT>, grid, smem, st, info,
        static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
        static_cast<const KT*>(k_new), static_cast<const int*>(phys),
        static_cast<const int*>(pos), static_cast<const int*>(kv_start),
        window, static_cast<float*>(sc), KVH, G, D, ps, NP, kvhg, ppb);
  });
}

// B2a. sc (B, KVH * G, NP * ps + 1) f32 (the all-reduced scores); pages,
// v_new in kv_dtype; out (B, 1, KVH * G, D) in out_dtype (0 f32, 1 bf16).
// kvhg kv heads a cluster (grid z), cs CTAs a cluster (grid x, at most
// clus::MAX_CLUSTER). A cluster the card cannot hold launches nothing
// (cudaErrorInvalidConfiguration). With info non-null: the launch's
// geometry and no launch. Returns a cudaError_t.
extern "C" int flash_decode_hd_attend_launch(
    const void* sc, const void* v_pages, const void* v_new, const void* phys,
    const void* pos, const void* kv_start, int window, float scale,
    void* out, int B, int KVH, int G, int D, int ps, int NP, int kvhg, int cs,
    int kv_dtype, int out_dtype, void* stream, int* info) {
  if (bad_shape(B, KVH, G, D, ps, NP, kvhg, kv_dtype, out_dtype) || cs < 1 ||
      cs > clus::MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const SliceGeom sg(kvhg, D, kv_dtype == 0 ? 4 : 2, ps,
                     (NP * ps + cs - 1) / cs / ps + 2);
  if (kvhg * sg.nch > HT) return (int)cudaErrorInvalidValue;
  const size_t smem = AttendSmem(sg, kvhg, G, D, ps, NP, cs).total;
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid(cs, B, (KVH + kvhg - 1) / kvhg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(kv_dtype, out_dtype, [&](auto kt, auto qt) {
    using KT = decltype(kt);
    using QT = decltype(qt);
    return with_g(G, [&](auto gg) {
      return (int)clus::launch_x(
          hd_attend_kernel<KT, QT, decltype(gg)::value>, grid, HT, cs, smem,
          (int)MAX_DYN_SMEM, st, info, static_cast<const float*>(sc),
          static_cast<const KT*>(v_pages), static_cast<const KT*>(v_new),
          static_cast<const int*>(phys), static_cast<const int*>(pos),
          static_cast<const int*>(kv_start), window, scale,
          static_cast<QT*>(out), KVH, D, ps, NP, kvhg);
    });
  });
}

#ifdef HD_PROFILE
// Where the phase timestamps go (16 int64 a block), or null for none.
extern "C" int flash_decode_hd_set_prof(long long* p) {
  return (int)cudaMemcpyToSymbol(hd_prof, &p, sizeof(p));
}
#endif
