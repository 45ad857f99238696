// Device code shared by the paged flash-decode kernels: B2
// (flash_decode.cu, pages of fp K/V rows) and B5 (flash_decode_kvq.cu,
// pages of uint8 centroid codes).
//
// Both compute, per (split s, kv head h, slot b) = one block of THREADS
// threads, the softmax triple over the live keys of the split, for each
// of the G query heads of the group:
//   m = max_j s_j,  l = sum_j exp(s_j - m),  acc = sum_j exp(s_j - m) v_j
// over live keys j: kv_start <= j < pos (and j > pos - window when
// window > 0), inside the split's token range. An all-masked split gives
// exactly (-1e30, 0, 0), the identity of the split reduction that follows.
//
// Each kernel has two forms, one template flag (FOLD) apart:
//  * the triples form writes the triple to device memory, (NS, B, KVH,
//    G[, D]) f32: the contract of the TPU kernels, held against their
//    plain versions;
//  * the fused form, the one flash_decode_paged launches, keeps it in the
//    block's shared memory. The NS split blocks of one (slot, kv head)
//    form a thread block cluster along grid x, and fold_end reduces
//    their triples over distributed shared memory and folds in the new
//    token's self term: one kernel a call, no triple in device memory.
//    Its q is the raw query (f32 or bf16), scaled by D^-0.5 as it is read.
//    A split without a live key leaves at once (fold_begin).
//
// What is here:
//  * split_range: the block's live keys, one contiguous token range. Only
//    its tokens are ever read: dead pages, trash pages and pos = -1 lanes
//    cost no load, and a split without a live key writes the identity.
//    The split's page ids are read alongside (fetch_pages), not after.
//  * cp.async helpers for the shared-memory rings both kernels stream
//    their tiles through.
//  * RowGroup: the score / online-softmax / value loop over fp rows kept
//    in shared memory in their storage type (bf16 or f32). A row of D
//    elements is read as 16-byte chunks by a group of LPK lanes (LPK the
//    power of two >= the chunk count, at most 32), so each lane holds at
//    most 8 elements of q and of acc in registers; a warp scores 32 / LPK
//    keys at once, and a dot product costs log2(LPK) shuffles. Each group
//    keeps its own (m, l, acc) across the tiles; groups merge once per
//    block, at the end, through shared memory.
//  * fold_begin / fold_end: the fused form's start and end (see there).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"

namespace flashc {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;
constexpr int MAX_D = 256;
constexpr int STAGES = 3;              // depth of the cp.async rings
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_DYN_SMEM = 227 * 1024;
constexpr int MAX_SPLITS = clus::MAX_CLUSTER;  // the fused form's cluster
constexpr int FOLD_CH = 8;             // splits the fold merges at a time

__device__ __forceinline__ float to_f(float a) { return a; }
__device__ __forceinline__ float to_f(__nv_bfloat16 a) {
  return __bfloat162float(a);
}
__device__ __forceinline__ void store(float* p, float a) { *p = a; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}
// A query element times its scale: one rounded f32 multiply, never fused
// into the dot product that follows, so it is the value the plain
// version forms (f32 q times the f32 scale). The triples form takes q
// already scaled, with scale 1.
template <typename QT>
__device__ __forceinline__ float scaled(QT q, float scale) {
  return __fmul_rn(to_f(q), scale);
}

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
// the same through L1 as well: for data every block of an SM reads (B5's
// tables), so co-resident blocks hit in L1 instead of queueing on the
// same L2 lines
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n (0 .. STAGES) of the committed groups are still in
// flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else
    asm volatile("cp.async.wait_group 3;\n" ::);
}

// Copy `bytes` from global to shared memory (dst 16-byte aligned): by
// cp.async through L1 when src is 16-byte aligned too, else byte by byte.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    done = bytes / 16 * 16;
    for (int i = threadIdx.x * 16; i < done; i += THREADS * 16)
      cp_async16_ca(d + i, s + i);
  }
  for (int i = done + threadIdx.x; i < bytes; i += THREADS) d[i] = s[i];
}

__host__ __device__ inline int round_up(int a, int m) { return (a + m - 1) / m * m; }

// The block's live keys [lo, hi): the mask's range cut to split s.
struct Range {
  int lo, hi;
};
__device__ __forceinline__ Range split_range(const int* pos, const int* kvs,
                                             int window, int b, int s,
                                             int sp, int ps, int NP) {
  const int p = pos[b];
  int lo = kvs[b];
  if (window > 0 && p - window + 1 > lo) lo = p - window + 1;
  const int t_first = s * sp * ps;
  const int t_end = min(NP, (s + 1) * sp) * ps;
  return {max(lo, t_first), min(p, t_end)};
}

// Where a block's triple goes: device memory (the triples form) or the
// block's own shared memory (the fused form). m and l hold G floats, acc
// G x D.
struct TripleDst {
  float* m;
  float* l;
  float* acc;
};

// What a launch writes: the triples form, m and l (NS, B, KVH, G) and acc
// (NS, B, KVH, G, D) f32; the fused form, out (B, 1, KVH * G * D) in q's
// type, from the new token's k_new and v_new (B, 1, KVH, D) in q's type.
template <typename QT>
struct Dest {
  float* m;
  float* l;
  float* acc;
  const QT* k_new;
  const QT* v_new;
  QT* out;
};

// Floats of the fused form's regions of shared memory (the triples form
// has neither):
//  * the block's triple (m, l: G each; acc: G x D), written once its keys
//    are scored, over the space its key ring took;
__host__ __device__ inline size_t triple_floats(int G, int D) {
  return (size_t)G * (D + 2);
}
//  * a region the key loop never touches: an mbarrier (4 floats' room),
//    the partial self scores (G x MAX_D / 32), then the slots the
//    cluster's live ranks push their triples' slices into: acc (at most
//    G x D + MAX_SPLITS floats), then m and l (G x MAX_SPLITS each).
__host__ __device__ inline size_t fold_floats(int G, int D) {
  return 4 + (size_t)G * (MAX_D / 32) + (size_t)G * D + MAX_SPLITS +
         2 * (size_t)G * MAX_SPLITS;
}

// Block (s, h, b)'s triple: triple o = ((s * B + b) * KVH + h) * G of
// io's arrays, or the region at trip_off of shared memory.
template <bool FOLD, typename QT>
__device__ __forceinline__ TripleDst triple_dst(const Dest<QT>& io,
                                                unsigned char* smem,
                                                size_t trip_off, size_t o,
                                                int G, int D) {
  if constexpr (FOLD) {
    float* t = reinterpret_cast<float*>(smem + trip_off);
    return {t, t + G, t + 2 * G};
  } else {
    return {io.m + o, io.l + o, io.acc + o * D};
  }
}

// (-1e30, 0, 0) for the G heads (all threads of the block).
__device__ __forceinline__ void write_identity(const TripleDst& t, int G,
                                               int D) {
  for (int i = threadIdx.x; i < G; i += THREADS) {
    t.m[i] = NEG_INF;
    t.l[i] = 0.f;
  }
  for (int i = threadIdx.x; i < G * D; i += THREADS) t.acc[i] = 0.f;
}

// The page ids of split s, phys[b, s*sp ..], read before the split's
// range is known, so their load overlaps the loads of pos and kv_start:
// fetch_pages issues the load of one id per thread into a register,
// store_pages (after the range check) writes them to shared memory. Page
// of token t is pages_s[t / ps - first].
struct SplitPages {
  int first, n, mine;
};
__device__ __forceinline__ SplitPages fetch_pages(const int* phys, int b,
                                                  int NP, int s, int sp) {
  SplitPages p;
  p.first = s * sp;
  p.n = min(sp, NP - p.first);
  p.mine = (int)threadIdx.x < p.n ? phys[(size_t)b * NP + p.first + threadIdx.x] : 0;
  return p;
}
__device__ __forceinline__ void store_pages(const SplitPages& p,
                                            const int* phys, int b, int NP,
                                            int* pages_s) {
  if ((int)threadIdx.x < p.n) pages_s[threadIdx.x] = p.mine;
  for (int i = threadIdx.x + THREADS; i < p.n; i += THREADS)
    pages_s[i] = phys[(size_t)b * NP + p.first + i];
}

// Issue the copies of one tile: rows 0 .. n-1 are tokens t0 .. t0+n-1 of
// the range, `len` bytes each, of K (at kb) and of V (at vb); token t
// lies at ((page(t) * ps + t % ps) * tok_bytes) from either base. Row r
// lands at dk + r * rs and dv + r * rs, zero-padded to whole 16-byte
// chunks. Rows of whole chunks from 16-byte aligned bases go by cp.async
// (one per 16 bytes), the thread's chunk column fixed when the chunk
// count divides THREADS, so each thread steps through its rows' pages
// without a division; other rows (and pools that are views at an odd
// offset) are copied byte by byte.
__device__ __forceinline__ void load_rows(
    const unsigned char* __restrict__ kb, const unsigned char* __restrict__ vb,
    size_t tok_bytes, int ps, const int* pages_s, int first, int t0, int n,
    int len, unsigned char* dk, unsigned char* dv, int rs) {
  const int nch = (len + 15) / 16;
  const bool vec = len % 16 == 0 && tok_bytes % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(kb) |
                     reinterpret_cast<uintptr_t>(vb)) & 15) == 0;
  if (vec && THREADS % nch == 0) {
    const int ch = threadIdx.x % nch, step = THREADS / nch;
    int r = threadIdx.x / nch;
    int pi = (t0 + r) / ps - first, in = (t0 + r) % ps;   // page, row in it
    for (; r < n; r += step) {
      const size_t off =
          ((size_t)pages_s[pi] * ps + in) * tok_bytes + ch * 16;
      cp_async16(dk + r * rs + ch * 16, kb + off);
      cp_async16(dv + r * rs + ch * 16, vb + off);
      for (in += step; in >= ps; in -= ps) ++pi;
    }
  } else if (vec) {
    for (int i = threadIdx.x; i < n * nch; i += THREADS) {
      const int r = i / nch, ch = i % nch, t = t0 + r;
      const size_t off =
          ((size_t)pages_s[t / ps - first] * ps + t % ps) * tok_bytes + ch * 16;
      cp_async16(dk + r * rs + ch * 16, kb + off);
      cp_async16(dv + r * rs + ch * 16, vb + off);
    }
  } else {
    const int w = nch * 16;
    for (int i = threadIdx.x; i < n * w; i += THREADS) {
      const int r = i / w, col = i % w, t = t0 + r;
      const size_t off =
          ((size_t)pages_s[t / ps - first] * ps + t % ps) * tok_bytes + col;
      dk[r * rs + col] = col < len ? kb[off] : 0;
      dv[r * rs + col] = col < len ? vb[off] : 0;
    }
  }
}

// Geometry of one fp row of D elements of KT in shared memory: nch
// 16-byte chunks (the last one zero-padded when D * sizeof(KT) is not a
// multiple of 16), lpk lanes per row, cpl chunks per lane, ng row groups
// in the block.
struct RowGeom {
  int nch, lpk, cpl, ng;
  __host__ __device__ RowGeom(int D, int elsize) {
    nch = (D * elsize + 15) / 16;
    lpk = 1;
    while (lpk < nch && lpk < 32) lpk *= 2;
    cpl = (nch + lpk - 1) / lpk;
    ng = THREADS / lpk;
  }
  __host__ __device__ int row_bytes() const { return nch * 16; }
  // floats RowGroup::finish needs: m, l, weights (ng x G each), acc
  // (ng x G x D) and the max over groups (G)
  __host__ __device__ size_t merge_floats(int G, int D) const {
    return (size_t)ng * G * (D + 3) + G;
  }
};

template <typename KT>
struct Elems;
template <>
struct Elems<float> {
  static constexpr int N = 4;                      // elements per chunk
  __device__ __forceinline__ static void get(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Elems<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void get(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of its f32: exact widening
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Keys a group scores before one online-softmax update (registers: KB x G
// scores next to G x 8 of q and of acc).
template <int G>
struct KeyBatch {
  static constexpr int KB = G <= 2 ? 4 : (G <= 4 ? 2 : 1);
};

// One group of geom.lpk lanes: q and acc for its elements of every head,
// and the group's running m and l. Rows are read from shared memory.
template <typename KT, int G>
struct RowGroup {
  static constexpr int EPC = Elems<KT>::N;
  static constexpr int MAX_CPL = 8 / EPC;
  static constexpr int KB = KeyBatch<G>::KB;
  float q[G][8], acc[G][8], m[G], l[G];
  int j, gid;                                      // lane in group, group

  // q (G x D) of this (b, h), times scale
  template <typename QT>
  __device__ __forceinline__ void init(const QT* __restrict__ qbh,
                                       float scale, int D,
                                       const RowGeom& geom) {
    j = threadIdx.x % geom.lpk;
    gid = threadIdx.x / geom.lpk;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_CPL; ++c)
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          const int d = (j + geom.lpk * c) * EPC + e;
          q[g][c * EPC + e] =
              (c < geom.cpl && d < D) ? scaled(qbh[g * D + d], scale) : 0.f;
          acc[g][c * EPC + e] = 0.f;
        }
    }
  }

  // rows 0 .. n-1 of a tile (K rows at k_s, V rows at v_s, geom.row_bytes
  // apart). Every lane of the block calls it (shuffles need whole warps).
  __device__ __forceinline__ void tile(const unsigned char* k_s,
                                       const unsigned char* v_s, int n,
                                       const RowGeom& geom) {
    const int rb = geom.row_bytes();
    for (int base = 0; base < n; base += geom.ng * KB) {
      float sc[KB][G];
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int t = min(base + gid + kb * geom.ng, n - 1);  // in bounds
#pragma unroll
        for (int g = 0; g < G; ++g) sc[kb][g] = 0.f;
#pragma unroll
        for (int c = 0; c < MAX_CPL; ++c) {
          const int ch = j + geom.lpk * c;
          if (c < geom.cpl && ch < geom.nch) {
            float kf[EPC];
            Elems<KT>::get(*reinterpret_cast<const uint4*>(k_s + t * rb + ch * 16), kf);
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int e = 0; e < EPC; ++e) sc[kb][g] += q[g][c * EPC + e] * kf[e];
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          if (o < geom.lpk)
#pragma unroll
            for (int g = 0; g < G; ++g)
              sc[kb][g] += __shfl_xor_sync(0xffffffffu, sc[kb][g], o);
      }
      float p[KB][G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = NEG_INF;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
          if (base + gid + kb * geom.ng < n) mx = fmaxf(mx, sc[kb][g]);
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          // masked keys get 0 by the mask, never through exp(-inf)
          p[kb][g] = base + gid + kb * geom.ng < n ? expf(sc[kb][g] - m_new) : 0.f;
          sum += p[kb][g];
        }
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
      }
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int t = base + gid + kb * geom.ng;
        if (t < n) {
#pragma unroll
          for (int c = 0; c < MAX_CPL; ++c) {
            const int ch = j + geom.lpk * c;
            if (c < geom.cpl && ch < geom.nch) {
              float vf[EPC];
              Elems<KT>::get(*reinterpret_cast<const uint4*>(v_s + t * rb + ch * 16), vf);
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int e = 0; e < EPC; ++e) acc[g][c * EPC + e] += p[kb][g] * vf[e];
            }
          }
        }
      }
    }
  }

  // Merge the groups' states through shared memory (geom.merge_floats
  // floats at red, free for this use: the caller syncs before) and write
  // the triple to dst. Each group's weight exp(m_k - max_k m_k) is
  // computed once.
  __device__ __forceinline__ void finish(float* red, const RowGeom& geom,
                                         const TripleDst& dst, int D) {
    float* rm = red;                                // [ng][G]
    float* rl = rm + geom.ng * G;                   // [ng][G]
    float* ra = rl + geom.ng * G;                   // [ng][G][D]
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (j == 0) {
        rm[gid * G + g] = m[g];
        rl[gid * G + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < MAX_CPL; ++c)
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          const int d = (j + geom.lpk * c) * EPC + e;
          if (c < geom.cpl && d < D) ra[((size_t)gid * G + g) * D + d] = acc[g][c * EPC + e];
        }
    }
    __syncthreads();
    float* rw = ra + (size_t)geom.ng * G * D;       // [ng][G] weights
    float* rmt = rw + geom.ng * G;                  // [G] max over groups
    for (int g = threadIdx.x; g < G; g += THREADS) {
      float mt = NEG_INF;
      for (int k = 0; k < geom.ng; ++k) mt = fmaxf(mt, rm[k * G + g]);
      rmt[g] = mt;
      dst.m[g] = mt;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < geom.ng * G; i += THREADS)
      rw[i] = expf(rm[i] - rmt[i % G]);
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float a = 0.f, lt = 0.f;
      for (int k = 0; k < geom.ng; ++k) {
        a += rw[k * G + g] * ra[((size_t)k * G + g) * D + d];
        lt += rw[k * G + g] * rl[k * G + g];
      }
      dst.acc[i] = a;
      if (d == 0) dst.l[g] = lt;
    }
  }
};

// The fused form's plan for one block, made at its start (fold_begin)
// and carried out at its end (fold_end). The cluster is the NS split
// blocks of one (slot b, kv head h), bh = b * KVH + h; rank = split =
// blockIdx.x. Which splits hold live keys follows from pos, kv_start and
// the window alone, so every block knows it without a message:
//  * a split without a live key leaves at once, before any barrier (a
//    cluster barrier waits for the threads that have not exited), and no
//    rank reads or writes its shared memory: its triple is the identity,
//    which the fold merges as it merges the padding. So a cluster's empty
//    splits hold no SM while its live ones run, as in the triples form.
//    When no split is live (pos = -1, or all keys masked), rank 0 stays
//    and folds alone;
//  * the live ranks (or rank 0 alone) own the G x D outputs, in rank
//    order, as contiguous slices of `per`; slot k of the push slots is
//    the k-th live rank;
//  * each staying block initializes its mbarrier and, with more than one
//    live rank, arrives (relaxed, after a release fence) at the cluster
//    barrier, so that the wait in fold_end finds every live rank started
//    and its mbarrier ready: only then may one write into another's
//    memory;
//  * k_new at the thread's self-score columns and v_new at its first
//    output are loaded here, so their latency hides behind the keys'.
struct FoldPlan {
  unsigned live;                  // bit j: split j has a live key
  int per, me;                    // outputs a slot; this rank's slot
  float kd[MAX_D / 32 / WARPS];   // k_new at columns (warp + WARPS i) * 32
  float vd;                       //   + lane; v_new at output me*per + tid
  bool leave, sync;
};

__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  for (; k > 0; --k) m &= m - 1u;
  return __ffs(m) - 1;
}

template <typename QT>
__device__ __forceinline__ FoldPlan fold_begin(
    const int* __restrict__ pos, const int* __restrict__ kvs, int window,
    int b, int ns, int sp, int ps, int NP, int G, int D,
    const QT* __restrict__ k_new, const QT* __restrict__ v_new, size_t bh,
    float* fold_s) {
  FoldPlan f;
  const int p = pos[b];
  int lo = kvs[b];
  if (window > 0 && p - window + 1 > lo) lo = p - window + 1;
  f.live = 0;
  for (int j = 0; j < ns; ++j) {  // split_range's test, for every split
    const int t_first = j * sp * ps, t_end = min(NP, (j + 1) * sp) * ps;
    if (max(lo, t_first) < min(p, t_end)) f.live |= 1u << j;
  }
  const int rank = blockIdx.x;
  f.leave = f.live != 0 ? !((f.live >> rank) & 1u) : rank != 0;
  f.sync = __popc(f.live) > 1;
  if (f.leave) return f;
  if (threadIdx.x == 0) {
    clus::mbar_init(reinterpret_cast<uint64_t*>(fold_s));
    clus::fence_init();
  }
  if (f.sync) clus::arrive_relaxed();
  const int owners = f.live != 0 ? __popc(f.live) : 1;
  f.per = (G * D + owners - 1) / owners;
  f.me = __popc(f.live & ((1u << rank) - 1u));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < MAX_D / 32 / WARPS; ++i) {
    const int d = (warp + WARPS * i) * 32 + lane;
    f.kd[i] = d < D ? to_f(k_new[bh * D + d]) : 0.f;
  }
  const int o = f.me * f.per + threadIdx.x;
  f.vd = o < min(G * D, (f.me + 1) * f.per) ? to_f(v_new[bh * D + o % D])
                                              : 0.f;
  return f;
}

// The partial self scores of the fused form into part (G x MAX_D / 32):
// q_g * D^-0.5 . k_new over each 32 columns, a warp shuffle tree (k_new
// was loaded by fold_begin; q sits in L1 since the block read it).
template <typename QT, int G>
__device__ __forceinline__ void self_scores(const FoldPlan& f,
                                            const QT* __restrict__ q,
                                            float q_scale, float* part,
                                            size_t bh, int D) {
  constexpr int PW = MAX_D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (D + 31) / 32;
#pragma unroll
  for (int i = 0; i < MAX_D / 32 / WARPS; ++i) {
    const int cg = warp + WARPS * i;
    if (cg < groups) {
      const int d = cg * 32 + lane;
      const bool live = d < D;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float p =
            live ? scaled(q[(bh * G + g) * D + d], q_scale) * f.kd[i] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) part[g * PW + cg] = p;
      }
    }
  }
}

// The fused form's end, after the block has put its triple at trip.
// fold_s holds fold_floats(G, D) floats: the mbarrier, the partial self
// scores, the push slots. Per head g of the group:
//   M = max_s m[s],  L = sum_s l[s] w_s,  A = sum_s acc[s] w_s,
//     w_s = exp(m[s] - M), in split order, FOLD_CH splits at a time from
//     the identity (an empty split, and the padding, is the identity)
//   s_new = (q_g * D^-0.5) . k_new (the column groups' partials in
//     order),  m_f = max(M, s_new),  alpha = exp(M - m_f),
//   p_new = exp(s_new - m_f),  out = (A alpha + p_new v_new)
//                                    / (L alpha + p_new)
// The new token is always live, so the denominator is at least exp(0): a
// lane whose splits are all the identity (pos = -1) gets alpha = 0 and
// p_new = 1, exactly its v_new row.
//  1. The block's mbarrier expects the bytes its slots will receive: its
//     slice of acc and all of m and l, from each live rank.
//  2. Wait for every live rank to have started (the relaxed arrivals of
//     fold_begin). Push: each slice of this block's acc, and its m and l,
//     go into the owning rank's slots at slot `me` by st.async, each
//     store completing its bytes on the owner's mbarrier.
//  3. The self scores, while the pushes fly; then wait on the mbarrier
//     for every byte of the slots and fold this rank's slice from them,
//     in rank order. Once its bytes have landed nothing more writes into
//     a block, and it reads no other block's memory: blocks leave
//     without a second barrier.
// Every sum runs in a fixed order, so the result does not depend on
// scheduling; expf is the accurate one (no fast-math), so exp(0) is 1.
template <typename QT, int G>
__device__ __forceinline__ void fold_end(
    const FoldPlan& f, const TripleDst& trip, float* fold_s,
    const QT* __restrict__ q, float q_scale, const QT* __restrict__ v_new,
    QT* __restrict__ out, size_t bh, int D, int ns) {
  constexpr int PW = MAX_D / 32;
  uint64_t* bar = reinterpret_cast<uint64_t*>(fold_s);
  float* part = fold_s + 4;                         // [G][PW]
  float* slot_acc = part + G * PW;                  // [owners][per]
  float* slot_m = slot_acc + G * D + MAX_SPLITS;    // [owners][G]
  float* slot_l = slot_m + G * MAX_SPLITS;          // [owners][G]
  const int tid = threadIdx.x;
  const int n_out = G * D, per = f.per;
  const unsigned owners_mask = f.live != 0 ? f.live : 1u;
  const int owners = __popc(owners_mask);
  const int lo = f.me * per, hi = min(n_out, lo + per);
  if (tid == 0)
    clus::mbar_expect(bar, 4u * owners * (max(0, hi - lo) + 2 * G));
  __syncthreads();                                  // the triple
  if (f.sync) clus::wait();
  for (int i = tid; i < n_out; i += THREADS) {
    const int k = i / per, rk = nth_bit(owners_mask, k);
    clus::store_async(
        clus::map_rank(slot_acc + f.me * per + (i - k * per), rk),
        trip.acc[i], clus::map_rank(bar, rk));
  }
  for (int t = tid; t < owners * G; t += THREADS) {
    const int k = t / G, g = t % G, rk = nth_bit(owners_mask, k);
    const uint32_t rbar = clus::map_rank(bar, rk);
    clus::store_async(clus::map_rank(slot_m + f.me * G + g, rk), trip.m[g],
                      rbar);
    clus::store_async(clus::map_rank(slot_l + f.me * G + g, rk), trip.l[g],
                      rbar);
  }
  self_scores<QT, G>(f, q, q_scale, part, bh, D);
  __syncthreads();                                  // part
  clus::mbar_wait(bar);

  const int groups = (D + 31) / 32;
  float vd = f.vd;
  for (int i = lo + tid; i < hi; i += THREADS) {
    const int g = i / D;
    float mx = NEG_INF, ls = 0.f, as = 0.f;
    for (int s0 = 0; s0 < ns; s0 += FOLD_CH) {
      float mv[FOLD_CH], lv[FOLD_CH], av[FOLD_CH];
#pragma unroll
      for (int j = 0; j < FOLD_CH; ++j) {         // the identity unless live
        const int s = s0 + j;
        const bool live = s < ns && ((f.live >> s) & 1u);
        const int k = __popc(f.live & ((1u << s) - 1u));
        mv[j] = live ? slot_m[k * G + g] : NEG_INF;
        lv[j] = live ? slot_l[k * G + g] : 0.f;
        av[j] = live ? slot_acc[k * per + (i - lo)] : 0.f;
      }
      float mc = mx;
#pragma unroll
      for (int j = 0; j < FOLD_CH; ++j) mc = fmaxf(mc, mv[j]);
      const float w0 = expf(mx - mc);
      float lsum = ls * w0, asum = as * w0;
#pragma unroll
      for (int j = 0; j < FOLD_CH; ++j) {
        const float w = expf(mv[j] - mc);
        lsum += lv[j] * w;
        asum += av[j] * w;
      }
      mx = mc;
      ls = lsum;
      as = asum;
    }
    float sn = 0.f;
    for (int cg = 0; cg < groups; ++cg) sn += part[g * PW + cg];
    const float mf = fmaxf(mx, sn);
    const float alpha = expf(mx - mf);
    const float pn = expf(sn - mf);
    const float denom = ls * alpha + pn;
    // the contraction written out (p_new v_new fused): no compiler
    // choice of the other order moves a bit
    store(out + bh * n_out + i, __fmaf_rn(pn, vd, as * alpha) / denom);
    if (i + THREADS < hi) vd = to_f(v_new[bh * D + (i + THREADS) % D]);
  }
}

// f(std::integral_constant<int, G>) for the runtime G in 1..MAX_G.
template <typename F>
int with_g(int G, F&& f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

}  // namespace flashc
