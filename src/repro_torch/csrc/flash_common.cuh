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
// exactly (-1e30, 0, 0), the identity of the split reduction that follows
// (the fold kernel, flash_fold.cu).
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flashc {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;
constexpr int MAX_D = 256;
constexpr int STAGES = 3;              // depth of the cp.async rings
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_DYN_SMEM = 227 * 1024;

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

// (-1e30, 0, 0) for the G heads of triple o (all threads of the block).
__device__ __forceinline__ void write_identity(float* m_out, float* l_out,
                                               float* acc_out, size_t o,
                                               int G, int D) {
  for (int i = threadIdx.x; i < G; i += THREADS) {
    m_out[o + i] = NEG_INF;
    l_out[o + i] = 0.f;
  }
  for (int i = threadIdx.x; i < G * D; i += THREADS) acc_out[o * D + i] = 0.f;
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

  // q (G x D) f32 of this (b, h), already scaled
  __device__ __forceinline__ void init(const float* __restrict__ qbh, int D,
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
          q[g][c * EPC + e] = (c < geom.cpl && d < D) ? qbh[g * D + d] : 0.f;
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
  // triple o. Each group's weight exp(m_k - max_k m_k) is computed once.
  __device__ __forceinline__ void finish(float* red, const RowGeom& geom,
                                         float* m_out, float* l_out,
                                         float* acc_out, size_t o, int D) {
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
      m_out[o + g] = mt;
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
      acc_out[o * D + i] = a;
      if (d == 0) l_out[o + g] = lt;
    }
  }
};

// Instantiate body<G> for the runtime G in 1..MAX_G.
#define FLASHC_DISPATCH_G(G_RT, BODY) \
  switch (G_RT) {                     \
    case 1: BODY(1); break;           \
    case 2: BODY(2); break;           \
    case 3: BODY(3); break;           \
    case 4: BODY(4); break;           \
    case 5: BODY(5); break;           \
    case 6: BODY(6); break;           \
    case 7: BODY(7); break;           \
    default: BODY(8); break;          \
  }

}  // namespace flashc
