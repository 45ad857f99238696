// Device and host code of the one-launch VQ-AMM kernels for Hopper:
// B1 (fused_amm.cu) assigns its indices with assign_block and then runs
// sum_block; B4 (lut_gemm.cu) reads its indices in with load_indices and
// runs the same sum_block; B3 (assign.cu) runs assign_block alone and
// writes the indices out.
//
// A block of B1 or B4 owns one tile of 256 bytes of output columns (256
// int8, 128 bfloat16 or 64 float32 LUT columns), a range of the nc
// subspaces, and up to ROW_CAP rows of x. The blocks of one column tile
// split the subspaces between them and form one thread block cluster
// along the k axis (grid y = cluster size cs):
//  1. The block's indices idx[kk, m] sit in shared memory (uint8).
//  2. Thread t owns 16-byte column chunk t % CH of its rows (lane_of) and
//     gathers lut[k, idx[kk, m], its chunk] straight into registers with
//     16-byte loads, 16 in flight (two batches of LOADS, one added while
//     the next lands). Rows of x that select the same LUT row in one
//     subspace load the same line at about the same time, which the
//     caches serve after its first load: device memory sees each
//     selected row once per (column tile, k range). A shared-memory ring
//     fed by 16-byte cp.async, or by one TMA bulk copy a row, was slower
//     on the H100: its copies stalled at issue (PERF.md, PR 18).
//  3. Sums stay in registers in subspace order: int8 with dp4a into int32
//     (exact), float32 and bfloat16 in fp32.
//  4. Each block pushes its partial tile into the shared memory of the
//     ranks that own its parts (push_partial, distributed shared memory);
//     after one cluster barrier, rank r sums its share over the ranks in
//     rank order, applies the scale and writes out (finish_share). No
//     atomic touches a sum, so a float result is the same on every
//     launch, and an int8 result is (float)(exact int32 sum) * scale[n].
//     B1 and B4 run this one code, so at one geometry (cluster size and
//     partitions) they sum in one order: B4(B3(x)) == B1(x) bit for bit
//     on int8 LUTs always, and on float LUTs where their planned
//     geometries coincide.
// The host side (plan, launch_cluster) picks the cluster size per shape
// from the card's occupancy report and caches it.

#pragma once

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "cluster.cuh"
#include "vq_common.cuh"

#ifndef VQG_STAMP
#define VQG_STAMP(i)
#endif

namespace vqg {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int CHUNK = 16;                 // bytes a lane sums at once
constexpr int CH = 16;                    // chunks across a tile row
constexpr int TILE_BYTES = CH * CHUNK;    // 256 bytes of columns a tile
constexpr int SLOTS = THREADS / CH;       // row slots of the threads
constexpr int ROW_CAP = 4 * SLOTS;        // rows of x a block sums
constexpr int LOADS = 8;                  // 16-byte loads a batch
// Shared memory the assignment's staging takes when one subspace fits in
// it: the rest of the SM stays L1, which serves B1's repeated LUT lines.
constexpr int STAGING_BYTES = 48 * 1024;
constexpr int MAX_CLUSTER = clus::MAX_CLUSTER;
static_assert(CH * CHUNK <= THREADS, "a tile's scale columns: one a thread");

template <typename LT> struct Acc { using T = float; };
template <> struct Acc<int8_t> { using T = int; };

// LUT elements in one 16-byte chunk, and tile width in elements.
template <typename LT>
__host__ __device__ constexpr int epc() { return CHUNK / (int)sizeof(LT); }
template <typename LT>
__host__ __device__ constexpr int tile_cols() { return CH * epc<LT>(); }

// The floats of one 16-byte load of float32 or bfloat16 values (bf16 ->
// f32 by a shift, which is what __bfloat162float does).
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[4]) {
  f[0] = __uint_as_float(q.x); f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z); f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Add one 16-byte chunk of LUT row into a thread's accumulators: int8
// with dp4a and a one-hot vector (one signed byte added an instruction,
// exact), float32 and bfloat16 in fp32.
__device__ __forceinline__ void add_chunk(const uint4& q, int* a) {
  const int w[4] = {(int)q.x, (int)q.y, (int)q.z, (int)q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[4 * i + 0] = __dp4a(w[i], 0x00000001, a[4 * i + 0]);
    a[4 * i + 1] = __dp4a(w[i], 0x00000100, a[4 * i + 1]);
    a[4 * i + 2] = __dp4a(w[i], 0x00010000, a[4 * i + 2]);
    a[4 * i + 3] = __dp4a(w[i], 0x01000000, a[4 * i + 3]);
  }
}
template <typename LT>
__device__ __forceinline__ void add_any(const uint4& q,
                                        typename Acc<LT>::T* a) {
  if constexpr (std::is_same<LT, int8_t>::value) {
    add_chunk(q, a);
  } else {
    float f[epc<LT>()];
    unpack(q, f);
#pragma unroll
    for (int e = 0; e < epc<LT>(); ++e) a[e] += f[e];
  }
}

__device__ __forceinline__ unsigned bits(int a) { return (unsigned)a; }
__device__ __forceinline__ unsigned bits(float a) { return __float_as_uint(a); }
__device__ __forceinline__ void from_bits(unsigned b, int& a) { a = (int)b; }
__device__ __forceinline__ void from_bits(unsigned b, float& a) {
  a = __uint_as_float(b);
}

// 4-byte asynchronous copy to shared memory, and its wait (PTX).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// What the host decides for one launch; every block of the grid gets the
// same copy, so every block has the same shared-memory layout (the
// ranks of a cluster write into each other's memory at their own
// offsets).
struct Geometry {
  int cs;          // cluster size = k splits = grid y
  int kmax;        // most subspaces a block takes, ceil(nc / cs)
  int rows;        // rows of x a block takes, min(M, ROW_CAP)
  int parts;       // k partitions of a block: 2 up to 8 rows, else 1
  int ka;          // subspaces staged at once for the assignment (B4: 0)
  int vec_x;       // x and z take 16-byte loads
  int vec_lut;     // LUT rows take 16-byte loads
  // byte offsets in shared memory: the partials the other ranks push
  // here, the tile's scale, the indices, then the assignment's staging
  // (which then holds partition 1's tile for the merge)
  int off_recv, off_scale, off_idx, off_stage;
  int smem;        // dynamic shared memory bytes
};

// Row stride of the index array: SLOTS per row a thread sums.
__host__ __device__ inline int idx_rows(int r) { return SLOTS * r; }

// Host: bytes of the assignment's staging area for ka subspaces and rows
// rows of x (fp32: ka centroid slices, then the rows' x slices), and how
// many of kmax subspaces fit in budget bytes at once (at least one).
inline size_t staging_bytes(int ka, int rows, int c, int v) {
  return 4 * ((size_t)ka * vqc::z_stride(c, v) +
              (size_t)rows * vqc::x_stride(ka, v));
}
inline int staged_subspaces(int kmax, int rows, int c, int v,
                            size_t budget) {
  const size_t per_sub = 4 * ((size_t)vqc::z_stride(c, v) +
                              (size_t)rows * v);
  long ka = ((long)budget - 4L * rows) / (long)per_sub;
  if (ka < 1) ka = 1;
  if (ka > kmax) ka = kmax;
  return (int)ka;
}

inline size_t up16(size_t b) { return (b + 15) / 16 * 16; }

// Host: the geometry of B1 (v > 0) or B4 (v = 0: no assignment, so no
// staging area but partition 1's merge tile) at a cluster size, for
// rows-per-thread r and LUT element size le. Returns false when one
// block's shared memory would exceed max_smem.
inline bool make_geometry(Geometry& g, int M, int nc, int c, int v,
                          int cs, int r, int le, bool vec_x, bool vec_lut,
                          int max_smem) {
  g.cs = cs;
  g.kmax = (nc + cs - 1) / cs;
  g.rows = M < ROW_CAP ? M : ROW_CAP;
  g.parts = g.rows <= SLOTS / 2 ? 2 : 1;
  g.vec_x = vec_x;
  g.vec_lut = vec_lut;
  size_t off = 0;
  g.off_recv = 0;
  const size_t slen = ((size_t)g.rows * (TILE_BYTES / le) / 4 + cs - 1) / cs;
  off += (size_t)cs * slen * 16;
  g.off_scale = (int)off;
  off += up16(4 * (size_t)(TILE_BYTES / le));
  g.off_idx = (int)off;
  off += up16((size_t)g.kmax * idx_rows(r));
  g.off_stage = (int)off;
  g.ka = v > 0 ? staged_subspaces(g.kmax, g.rows, c, v, STAGING_BYTES) : 0;
  const size_t staging = v > 0 ? staging_bytes(g.ka, g.rows, c, v) : 0;
  const size_t merge = g.parts == 2 ? (size_t)g.rows * TILE_BYTES / le * 4
                                    : 0;
  off += staging > merge ? staging : merge;
  g.smem = (int)off;
  return off <= (size_t)max_smem;
}

__device__ __forceinline__ int nearest_any(const float* xr, const float* zk,
                                           int c, int v, int metric) {
  return metric == 0 ? vqc::nearest<0>(xr, zk, c, v, v)
       : metric == 1 ? vqc::nearest<1>(xr, zk, c, v, v)
                     : vqc::nearest<2>(xr, zk, c, v, v);
}

// The assignment of a block (B1 and B3): rows m0 .. m0+mt, subspaces
// k0 .. k0+kn, staged ka subspaces at a time (fp32, in the staging area),
// one thread per (row, subspace) pair running vq_common's nearest, so
// B1's and B3's indices are the same bits. x and z come in with 16-byte
// loads, eight in flight a thread, where their rows are 16-byte aligned;
// with v = 8 the x row sits in registers. Writes idx[kk * rs + m]. Ends
// with a __syncthreads.
template <typename XT>
__device__ __forceinline__ void assign_block(
    const XT* __restrict__ x, const XT* __restrict__ z,
    unsigned char* stage, unsigned char* idx, const Geometry& g,
    int metric, int nc, int c, int v, int m0, int mt,
    int k0, int kn, int rs) {
  const int tid = threadIdx.x;
  const int cv = c * v, zst = vqc::z_stride(c, v);
  const int xst = vqc::x_stride(g.ka, v);
  float* zs = reinterpret_cast<float*>(stage);
  float* xs = zs + (size_t)g.ka * zst;
  constexpr int EX = 16 / (int)sizeof(XT);   // elements a 16-byte load
  for (int a0 = 0; a0 < kn; a0 += g.ka) {
    const int an = min(g.ka, kn - a0);
    const XT* zsrc = z + (size_t)(k0 + a0) * cv;
    if (g.vec_x) {
      // z's and x's 16-byte loads of this chunk all go out before any
      // is stored: one round trip to memory, eight loads a thread
      const int nz = an * cv / EX;
      const int rowq = an * v / EX;          // 16-byte loads a row of x
      const int nall = nz + mt * rowq;
      const uint4* zq = reinterpret_cast<const uint4*>(zsrc);
      for (int b = tid; b < nall; b += 8 * THREADS) {
        uint4 buf[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = b + u * THREADS;
          if (i < nz) {
            buf[u] = __ldg(zq + i);
          } else if (i < nall) {
            const int mi = (i - nz) / rowq, q = (i - nz) % rowq;
            buf[u] = __ldg(reinterpret_cast<const uint4*>(
                x + ((size_t)(m0 + mi) * nc + k0 + a0) * v) + q);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = b + u * THREADS;
          float f[EX];
          unpack(buf[u], f);
          if (i < nz) {
            const int e0 = i * EX, kk = e0 / cv, r = e0 % cv;
#pragma unroll
            for (int q = 0; q < EX; ++q) zs[kk * zst + r + q] = f[q];
          } else if (i < nall) {
            const int mi = (i - nz) / rowq, q = (i - nz) % rowq;
#pragma unroll
            for (int t = 0; t < EX; ++t) xs[mi * xst + q * EX + t] = f[t];
          }
        }
      }
    } else {
      for (int i = tid; i < an * cv; i += THREADS)
        zs[(i / cv) * zst + i % cv] = vqc::to_f(zsrc[i]);
      const int xw = an * v;
      for (int i = tid; i < mt * xw; i += THREADS) {
        const int mi = i / xw, j = i % xw;
        xs[mi * xst + j] =
            vqc::to_f(x[((size_t)(m0 + mi) * nc + k0 + a0) * v + j]);
      }
    }
    __syncthreads();
    if (a0 == 0) VQG_STAMP(1);
    // neighbouring threads share a subspace: their z reads broadcast
    const int pairs = an * mt;
    if (v == 8) {        // the main path: v a literal, x in registers
      for (int t = tid; t < pairs; t += THREADS) {
        const int kk = t / mt, mi = t % mt;
        float xv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = xs[mi * xst + kk * 8 + i];
        const int j = nearest_any(xv, zs + kk * zst, c, 8, metric);
        idx[(a0 + kk) * rs + mi] = (unsigned char)j;
      }
    } else {
      for (int t = tid; t < pairs; t += THREADS) {
        const int kk = t / mt, mi = t % mt;
        const int j = nearest_any(xs + mi * xst + kk * v, zs + kk * zst, c,
                                  v, metric);
        idx[(a0 + kk) * rs + mi] = (unsigned char)j;
      }
    }
    __syncthreads();
  }
}

// The rows a thread sums: up to 8 rows of x, the block's threads split
// into two k partitions (slot / 8), each taking one row (slot % 8) and
// half of the subspaces, so all 8 warps gather; above 8 rows, one
// partition and rows slot + SLOTS * i.
struct Lane {
  int rbase, mrow, part;
};
__device__ __forceinline__ Lane lane_of(const Geometry& g) {
  const int slot = threadIdx.x / CH;
  if (g.parts == 2) return {slot % (SLOTS / 2), SLOTS / 2, slot / (SLOTS / 2)};
  return {slot, SLOTS, 0};
}

// One batch: the BK subspaces from kb on (below kend), R rows each, into
// buf.
template <typename LT, int R, int BK>
__device__ __forceinline__ void load_batch(
    uint4 (&buf)[BK][R], const LT* __restrict__ base,
    const unsigned char* idx, int kb, int kend, int c, int N, Lane ln,
    int mt, int rs) {
#pragma unroll
  for (int u = 0; u < BK; ++u) {
    const int kk = kb + u;
    if (kk < kend) {
      const LT* rowk = base + (size_t)kk * c * N;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int m = ln.rbase + ln.mrow * i;
        if (m < mt)
          buf[u][i] = __ldg(reinterpret_cast<const uint4*>(
              rowk + (size_t)idx[kk * rs + m] * N));
      }
    }
  }
}

template <typename LT, int R, int BK>
__device__ __forceinline__ void add_batch(
    const uint4 (&buf)[BK][R], int kb, int kend, Lane ln, int mt,
    typename Acc<LT>::T (&a)[R][epc<LT>()]) {
#pragma unroll
  for (int u = 0; u < BK; ++u)
    if (kb + u < kend)
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (ln.rbase + ln.mrow * i < mt) add_any<LT>(buf[u][i], a[i]);
}

// Gather-accumulate of subspaces k0 + [kbeg, kend) for the thread's rows
// and column chunk, in subspace order. 16-byte aligned LUT rows: two
// batches of LOADS 16-byte loads in flight, the next loading while the
// current is added. Otherwise element loads (columns past N skipped).
template <typename LT, int R>
__device__ __forceinline__ void gather_block(
    const LT* __restrict__ lut, const unsigned char* idx, const Geometry& g,
    int c, int N, int k0, int kbeg, int kend, int n0, int mt, int rs,
    Lane ln, typename Acc<LT>::T (&a)[R][epc<LT>()]) {
  constexpr int E = epc<LT>();
  constexpr int BK = LOADS / R > 0 ? LOADS / R : 1;
  const int col = n0 + (int)(threadIdx.x % CH) * E;
  if (col >= N || ln.rbase >= mt) return;
  const LT* base = lut + (size_t)k0 * c * N + col;
  if (g.vec_lut) {
    uint4 b0[BK][R], b1[BK][R];
    load_batch<LT, R, BK>(b0, base, idx, kbeg, kend, c, N, ln, mt, rs);
    for (int kb = kbeg; kb < kend; kb += 2 * BK) {
      load_batch<LT, R, BK>(b1, base, idx, kb + BK, kend, c, N, ln, mt, rs);
      add_batch<LT, R, BK>(b0, kb, kend, ln, mt, a);
      load_batch<LT, R, BK>(b0, base, idx, kb + 2 * BK, kend, c, N, ln, mt,
                            rs);
      add_batch<LT, R, BK>(b1, kb + BK, kend, ln, mt, a);
    }
  } else {
    for (int kk = kbeg; kk < kend; ++kk) {
      const LT* rowk = base + (size_t)kk * c * N;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int m = ln.rbase + ln.mrow * i;
        if (m < mt) {
          const LT* p = rowk + (size_t)idx[kk * rs + m] * N;
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (col + e < N) a[i][e] += vqc::to_acc(p[e]);
        }
      }
    }
  }
}

// Quads (4 accumulators, 16 bytes) of the (mt, BNE) tile that one rank
// finishes: rank r owns quads r * slen .. (r + 1) * slen.
template <typename LT>
__device__ __forceinline__ int share_len(int mt, int cs) {
  const int quads = mt * tile_cols<LT>() / 4;
  return (quads + cs - 1) / cs;
}

// With two k partitions: partition 1 leaves its tile in shared memory
// (scratch, the staging area) and partition 0 adds it to its own, in
// that order (lower subspaces first). Ends with a __syncthreads.
template <typename LT>
__device__ __forceinline__ void merge_partitions(
    typename Acc<LT>::T* scratch, int mt, Lane ln,
    typename Acc<LT>::T (&a)[1][epc<LT>()]) {
  using AccT = typename Acc<LT>::T;
  constexpr int E = epc<LT>(), BNE = tile_cols<LT>();
  AccT* t = scratch + (size_t)ln.rbase * BNE + (threadIdx.x % CH) * E;
  const bool row = ln.rbase < mt;       // scratch holds mt rows
  if (row && ln.part == 1)
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<uint4*>(t + e) =
          make_uint4(bits(a[0][e]), bits(a[0][e + 1]), bits(a[0][e + 2]),
                     bits(a[0][e + 3]));
  __syncthreads();
  if (row && ln.part == 0)
#pragma unroll
    for (int e = 0; e < E; ++e) a[0][e] += t[e];
}

// Partition 0's threads store the block's partial sums straight into the
// shared memory of the rank that owns them (distributed shared memory),
// in this rank's slot: recv[rank * slen + l] on the owner. Then the
// cluster barrier: after it, each rank holds every partial of its share
// and no rank touches another's memory again.
template <typename LT, int R>
__device__ __forceinline__ void push_partial(
    typename Acc<LT>::T* recv, const Geometry& g, int N, int n0, int mt,
    Lane ln, typename Acc<LT>::T (&a)[R][epc<LT>()]) {
  using AccT = typename Acc<LT>::T;
  constexpr int E = epc<LT>(), BNE = tile_cols<LT>();
  cg::cluster_group cluster = cg::this_cluster();
  const int ch = threadIdx.x % CH;
  const int slen = share_len<LT>(mt, g.cs);
  if (ln.part == 0 && n0 + ch * E < N) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = ln.rbase + ln.mrow * i;
      if (m >= mt) continue;
#pragma unroll
      for (int w = 0; w < E / 4; ++w) {
        const int u = (m * BNE + ch * E) / 4 + w;
        const int owner = u / slen;
        AccT* dst = cluster.map_shared_rank(recv, owner) +
                    4 * ((size_t)blockIdx.y * slen + (u - owner * slen));
        *reinterpret_cast<uint4*>(dst) = make_uint4(
            bits(a[i][4 * w]), bits(a[i][4 * w + 1]), bits(a[i][4 * w + 2]),
            bits(a[i][4 * w + 3]));
      }
    }
  }
  VQG_STAMP(4);
  cp_async_wait_all();               // this thread's scale column
  clus::arrive();
  clus::wait();
}

// Rank r's share of the tile: the partials of every rank in rank order
// -- subspace order -- summed from its own shared memory,
// scaled (tile_scale: the tile's scale columns, copied into shared
// memory at the start) and written to out.
template <typename LT>
__device__ __forceinline__ void finish_share(
    const typename Acc<LT>::T* recv, const Geometry& g,
    const float* __restrict__ scale, const float* tile_scale,
    float* __restrict__ out, int N, int m0, int mt, int n0) {
  using AccT = typename Acc<LT>::T;
  constexpr int BNE = tile_cols<LT>();
  const int slen = share_len<LT>(mt, g.cs);
  const int quads = mt * BNE / 4;
  const int srcs = g.cs;
  for (int l = threadIdx.x; l < slen; l += THREADS) {
    const int u = (int)blockIdx.y * slen + l;
    if (u >= quads) break;
    const int e = 4 * u, m = e / BNE, col = e % BNE, n = n0 + col;
    if (n >= N) continue;
    AccT s[4], t4[4];
    uint4 q = *reinterpret_cast<const uint4*>(recv + 4 * (size_t)l);
    from_bits(q.x, s[0]); from_bits(q.y, s[1]);
    from_bits(q.z, s[2]); from_bits(q.w, s[3]);
#pragma unroll 4
    for (int k = 1; k < srcs; ++k) {
      q = *reinterpret_cast<const uint4*>(recv + 4 * ((size_t)k * slen + l));
      from_bits(q.x, t4[0]); from_bits(q.y, t4[1]);
      from_bits(q.z, t4[2]); from_bits(q.w, t4[3]);
#pragma unroll
      for (int t = 0; t < 4; ++t) s[t] += t4[t];
    }
    float* o = out + (size_t)(m0 + m) * N + n;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (n + t < N) {
        float val = (float)s[t];
        if (scale != nullptr) val *= tile_scale[col + t];
        o[t] = val;
      }
    }
  }
}

// Where a block of B1 or B4 sits: columns n0 .., subspaces k0 .. k0+kn
// (the cluster spans grid y, so blockIdx.y is the block's rank), rows
// m0 .. m0+mt.
struct Tile {
  int n0, k0, kn, m0, mt;
};
template <typename LT>
__device__ __forceinline__ Tile tile_of(const Geometry& g, int M, int nc) {
  Tile t;
  t.n0 = blockIdx.x * tile_cols<LT>();
  t.k0 = (int)((long)blockIdx.y * nc / g.cs);
  t.kn = (int)((long)(blockIdx.y + 1) * nc / g.cs) - t.k0;
  t.m0 = blockIdx.z * ROW_CAP;
  t.mt = min(ROW_CAP, M - t.m0);
  return t;
}

// The tile's scale columns go to shared memory by cp.async now;
// push_partial waits for them and finish_share reads them.
template <typename LT>
__device__ __forceinline__ void copy_scale(unsigned char* smem,
                                           const Geometry& g,
                                           const float* __restrict__ scale,
                                           int n0, int N) {
  float* tile_scale = reinterpret_cast<float*>(smem + g.off_scale);
  if (scale != nullptr && threadIdx.x < tile_cols<LT>() &&
      n0 + (int)threadIdx.x < N)
    cp_async4(tile_scale + threadIdx.x, scale + n0 + threadIdx.x);
}

// B4: the block's indices src[m0 + m, k0 + kk] (int32, row stride nc)
// into idx[kk * rs + m] (uint8, c <= 256). Neighbouring threads read
// neighbouring subspaces of one row (coalesced), eight loads in flight a
// thread before any is stored. Ends with a __syncthreads.
__device__ __forceinline__ void load_indices(const int* __restrict__ src,
                                             unsigned char* idx, int nc,
                                             const Tile& t, int rs) {
  const int total = t.mt * t.kn;
  for (int b = threadIdx.x; b < total; b += 8 * THREADS) {
    int q[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = b + u * THREADS;
      if (i < total)
        q[u] = __ldg(src + (size_t)(t.m0 + i / t.kn) * nc + t.k0 + i % t.kn);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = b + u * THREADS;
      if (i < total) idx[(i % t.kn) * rs + i / t.kn] = (unsigned char)q[u];
    }
  }
  __syncthreads();
}

// Everything of a B1 or B4 block after its indices are in shared memory:
// the gather-accumulate (two k partitions up to 8 rows, merged in
// order), the push to the owning ranks, the cluster barrier and the
// finish of this rank's share.
template <typename LT, int R>
__device__ __forceinline__ void sum_block(
    const LT* __restrict__ lut, const float* __restrict__ scale,
    float* __restrict__ out, unsigned char* smem, const Geometry& g, int c,
    int N, const Tile& t) {
  using AccT = typename Acc<LT>::T;
  const int rs = idx_rows(R);
  AccT a[R][epc<LT>()];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < epc<LT>(); ++e) a[i][e] = AccT(0);
  const Lane ln = lane_of(g);
  const int half = (t.kn + 1) / 2;      // partition 0 takes the lower half
  const int kbeg = g.parts == 1 || ln.part == 0 ? 0 : half;
  const int kend = g.parts == 1 || ln.part == 1 ? t.kn : half;
  gather_block<LT, R>(lut, smem + g.off_idx, g, c, N, t.k0, kbeg, kend,
                      t.n0, t.mt, rs, ln, a);
  VQG_STAMP(3);                         // gathered
  if constexpr (R == 1) {
    if (g.parts == 2)
      merge_partitions<LT>(reinterpret_cast<AccT*>(smem + g.off_stage), t.mt,
                           ln, a);
  }
  AccT* recv = reinterpret_cast<AccT*>(smem + g.off_recv);
  push_partial<LT, R>(recv, g, N, t.n0, t.mt, ln, a);
  VQG_STAMP(5);                         // past the cluster barrier
  finish_share<LT>(recv, g, scale,
                   reinterpret_cast<const float*>(smem + g.off_scale), out,
                   N, t.m0, t.mt, t.n0);
}

// Host: the launch configuration of a grid of clusters along y.
inline void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                           dim3 grid, int cs, int smem, cudaStream_t st) {
  clus::config(cfg, attr, grid, THREADS, dim3(1, cs, 1), smem, st);
}

// What a launch of B1 or B4 computes: v = 0 for B4 (no assignment); r
// rows a thread sums.
struct Shape {
  int M, nc, c, v, N, r;
  bool vec_x, vec_lut;
};

using PlanKey = std::tuple<const void*, int, int, int, int, int, int, int,
                           int>;
inline std::mutex plan_mutex;
inline std::map<PlanKey, Geometry> plans;

// Host: the geometry of a launch of kern: the cluster size with the least
// estimated time among those the card can co-schedule at its shared
// memory. The estimate is waves of resident clusters x (subspaces a
// block + fixed), where fixed is the kernel's cost a block beyond its
// gather (staging, assignment or index load, partition and cluster
// sums) in units of one subspace's LUT rows. Cached per kernel, device
// and shape.
template <typename LT>
cudaError_t plan(Geometry& out, const void* kern, int fixed, const Shape& s) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const PlanKey key{kern, dev, s.M, s.nc, s.c, s.v, s.N, (int)s.vec_x,
                    (int)s.vec_lut};
  std::lock_guard<std::mutex> lock(plan_mutex);
  auto it = plans.find(key);
  if (it != plans.end()) {
    out = it->second;
    return cudaSuccess;
  }
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = clus::opt_in(kern, max_smem);
  if (err != cudaSuccess) return err;
  const int tiles = (s.N + tile_cols<LT>() - 1) / tile_cols<LT>();
  const int groups = (s.M + ROW_CAP - 1) / ROW_CAP;
  const long clusters = (long)tiles * groups;
  long best = -1;
  for (int cs = 1; cs <= MAX_CLUSTER && cs <= s.nc; ++cs) {
    Geometry g;
    if (!make_geometry(g, s.M, s.nc, s.c, s.v, cs, s.r, (int)sizeof(LT),
                       s.vec_x, s.vec_lut, max_smem))
      continue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cluster_config(cfg, attr, dim3(tiles, cs, groups), cs, g.smem, 0);
    const int active = clus::max_active(kern, cfg);
    if (active < 1) continue;           // a size this card refuses
    const long waves = (clusters + active - 1) / active;
    const long cost = waves * ((s.nc + cs - 1) / cs + fixed);
    if (best < 0 || cost < best) {
      best = cost;
      out = g;
    }
  }
  if (best < 0) return cudaErrorInvalidValue;
  plans[key] = out;
  return cudaSuccess;
}

// Host: plan kern at this shape and launch it as one grid of clusters
// with args followed by the geometry. With info non-null: write the
// launch's cluster size, column tiles, row groups, subspaces a block and
// shared memory bytes to info[0..4] and launch nothing.
template <typename LT, typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kern)(Params...), int fixed,
                           const Shape& s, cudaStream_t st, int* info,
                           Args... args) {
  Geometry g;
  cudaError_t err = plan<LT>(g, (const void*)kern, fixed, s);
  if (err != cudaSuccess) return err;
  const int tiles = (s.N + tile_cols<LT>() - 1) / tile_cols<LT>();
  const int groups = (s.M + ROW_CAP - 1) / ROW_CAP;
  if (groups > 65535) return cudaErrorInvalidValue;
  if (info != nullptr) {
    info[0] = g.cs; info[1] = tiles; info[2] = groups; info[3] = g.kmax;
    info[4] = g.smem;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, dim3(tiles, g.cs, groups), g.cs, g.smem, st);
  err = cudaLaunchKernelEx(&cfg, kern, args..., g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace vqg
