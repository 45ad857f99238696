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
//
// Grouped launches (a leading expert axis, as the JAX package vmaps the
// Pallas kernels over the experts of an MoE layer): E independent
// problems of one shape in one launch. Grid z holds E x the row groups;
// a block takes its expert e = blockIdx.z / groups and moves every
// operand pointer by e times that operand's expert stride, in 64-bit
// arithmetic (a dbrx-132b expert table is 2.11e9 bytes); all indexing
// inside one expert stays as for E = 1, so a launch at E = 1 is the
// ungrouped kernel bit for bit. plan counts the clusters of all E
// experts when it sizes the cluster.
//
// Live rows (a grouped launch of an MoE layer's routed experts): the
// launch may take counts, a device vector of E int64 counts, the rows of
// each expert's capacity buffer that the router filled (the buffer's
// first rows; the kernel clamps to M). A block reads its expert's count
// before anything else (tile_of) and works on live rows only: the rows
// past the count are written as 0.0 (B1, B4) or index 0 (B3) and never
// assigned or gathered, and a row group with no live row writes its zeros
// and returns before any cluster barrier (every rank of a cluster holds
// one expert and row group, so all ranks return alike). A live block
// spreads its 16 row slots over its lt live rows: 16 / lt k partitions
// of lt slots each (parts_of), every warp gathering with 16 loads in
// flight a thread, instead of two partitions of 8 slots whatever the
// count; the partitions' sums meet in a fixed order, in a pass over all
// the block's threads (push_merged), so a float result is still the
// same on every launch, and an int8 result is exact.
//
// Tile clusters (B1 with live-row counts, up to 16 rows an expert, the
// decode buffers): the k-split layout above runs every column tile's
// cluster over the same few rows, so each of the N / 256 B tiles stages
// and assigns the expert's rows again, and the grid (tiles x k splits x
// E) runs in waves of short blocks (PERF.md: 1536 blocks, ~5
// waves of ~8 us at deepseek-moe-16b's routed decode buffer). There the
// cluster spans tcs column tiles instead (grid x), and k is not split:
// rank r assigns subspaces [r nc / tcs, (r+1) nc / tcs) of the expert's
// live rows, stores those indices into every rank's shared memory
// (share_indices, 16-byte DSMEM stores), and after one cluster barrier
// each block gathers all nc subspaces of its own tile over its k
// partitions and writes its rows out itself (finish_local): no partial
// leaves a block. Its sums are B4's at one k split (cluster size 1), in
// the same order, so B4(B3(x)) == B1(x) on float LUTs there too.
//
// plan sizes either layout over the clusters that can be live: min(E x
// row groups, the call's most live rows) row groups' worth. Without
// counts every path below is the one before counts existed.

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
constexpr int LIVE_STAGING_BYTES = 96 * 1024;   // with live-row counts
constexpr int MAX_CLUSTER = clus::MAX_CLUSTER;
constexpr int TILE_CLUSTER = 8;           // most tiles a tile cluster spans
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
  int live;        // the launch takes live-row counts (parts_of)
  int tcs;         // tile cluster: tiles a cluster spans, k not split
                   // (then cs = 1); 0: clusters along k
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
// staging area but the partitions' merge tiles) at a cluster size, for
// rows-per-thread r and LUT element size le; with live-row counts the
// merge area holds the tiles of all SLOTS row slots (push_merged).
// Returns false when one block's shared memory would exceed max_smem.
inline bool make_geometry(Geometry& g, int M, int nc, int c, int v,
                          int cs, int r, int le, bool vec_x, bool vec_lut,
                          bool live, int max_smem) {
  g.cs = cs;
  g.tcs = 0;
  g.kmax = (nc + cs - 1) / cs;
  g.rows = M < ROW_CAP ? M : ROW_CAP;
  g.parts = g.rows <= SLOTS / 2 ? 2 : 1;
  g.live = live;
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
  // with live rows a block's subspaces go in one staging round where
  // LIVE_STAGING_BYTES holds them (a second round is a second chain of
  // loads for the few rows a live block has)
  const size_t one_round = v > 0 ? staging_bytes(g.kmax, g.rows, c, v) : 0;
  g.ka = v > 0 ? staged_subspaces(
                     g.kmax, g.rows, c, v,
                     live && one_round <= LIVE_STAGING_BYTES ? one_round
                                                             : STAGING_BYTES)
               : 0;
  const size_t staging = v > 0 ? staging_bytes(g.ka, g.rows, c, v) : 0;
  const size_t tile = (size_t)TILE_BYTES / le * 4;   // a row's sums
  const size_t merge = live ? SLOTS * tile
                     : g.parts == 2 ? (size_t)g.rows * tile : 0;
  off += staging > merge ? staging : merge;
  g.smem = (int)off;
  return off <= (size_t)max_smem;
}

// Host: the geometry of B1 in tile clusters of tcs column tiles (live
// rows, M <= SLOTS): each block assigns ceil(nc / tcs) subspaces, in one
// staging round where LIVE_STAGING_BYTES holds them, keeps all nc
// subspaces' indices and its partitions' tiles (merged where the staging
// was). Returns false when one block's shared memory would exceed
// max_smem.
inline bool make_tile_geometry(Geometry& g, int M, int nc, int c, int v,
                               int tcs, int le, bool vec_x, bool vec_lut,
                               int max_smem) {
  g = Geometry{};
  g.cs = 1;
  g.tcs = tcs;
  g.kmax = nc;
  g.rows = M < ROW_CAP ? M : ROW_CAP;
  g.parts = g.rows <= SLOTS / 2 ? 2 : 1;
  g.live = 1;
  g.vec_x = vec_x;
  g.vec_lut = vec_lut;
  const int kas = (nc + tcs - 1) / tcs;
  size_t off = 0;
  g.off_recv = 0;
  g.off_scale = 0;
  off += up16(4 * (size_t)(TILE_BYTES / le));
  g.off_idx = (int)off;
  off += up16((size_t)nc * idx_rows(1));
  g.off_stage = (int)off;
  const size_t one_round = staging_bytes(kas, g.rows, c, v);
  g.ka = staged_subspaces(kas, g.rows, c, v,
                          one_round <= LIVE_STAGING_BYTES ? one_round
                                                          : STAGING_BYTES);
  const size_t staging = staging_bytes(g.ka, g.rows, c, v);
  const size_t merge = (size_t)SLOTS * TILE_BYTES / le * 4;
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

// Distance of the sub-vector xr to the centroid zj, vq_common.cuh's
// distance for the metric (v = 8 a literal).
__device__ __forceinline__ float distance_any(const float* xr,
                                              const float* zj, int v,
                                              int metric) {
  if (v == 8)
    return metric == 0 ? vqc::distance<0>(xr, zj, 8)
         : metric == 1 ? vqc::distance<1>(xr, zj, 8)
                       : vqc::distance<2>(xr, zj, 8);
  return metric == 0 ? vqc::distance<0>(xr, zj, v)
       : metric == 1 ? vqc::distance<1>(xr, zj, v)
                     : vqc::distance<2>(xr, zj, v);
}

// The staged pairs (subspace kk of row mi, pair kk * mt + mi) of a block
// with few of them (2 pairs <= THREADS): tpp threads a pair (the most, a
// power of two up to 16, that the block's threads hold), thread `part`
// scanning centroids part, part + tpp, ..., then the tpp minima combined
// by shuffles, the lower index winning a tie. That is nearest's result:
// its scan keeps the first strict minimum, the lowest index of the least
// distance (0 when no distance is below infinity), and the distances are
// its own (vq_common.cuh's distance, the same fp32 operations).
__device__ __forceinline__ void assign_split(
    const float* xs, const float* zs, unsigned char* idx, int a0, int an,
    int mt, int xst, int zst, int c, int v, int metric, int rs) {
  const int pairs = an * mt;
  int tpp = 1;
  while (tpp < 16 && 2 * tpp * pairs <= THREADS) tpp *= 2;
  const int t = threadIdx.x / tpp, part = threadIdx.x % tpp;
  const int kk = t / mt, mi = t % mt;
  float best = INFINITY;
  int bj = c;                           // none yet
  if (t < pairs) {
    const float* zk = zs + kk * zst;
    if (v == 8) {
      float xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = xs[mi * xst + kk * 8 + i];
      for (int j = part; j < c; j += tpp) {
        const float d = distance_any(xv, zk + j * 8, 8, metric);
        if (d < best) { best = d; bj = j; }
      }
    } else {
      for (int j = part; j < c; j += tpp) {
        const float d = distance_any(xs + mi * xst + kk * v, zk + j * v, v,
                                     metric);
        if (d < best) { best = d; bj = j; }
      }
    }
  }
  for (int o = 1; o < tpp; o *= 2) {    // whole warps: tpp divides 32
    const float od = __shfl_xor_sync(0xffffffffu, best, o);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
    if (od < best || (od == best && oj < bj)) { best = od; bj = oj; }
  }
  if (t < pairs && part == 0)
    idx[(a0 + kk) * rs + mi] = (unsigned char)(bj == c ? 0 : bj);
}

// The assignment of a block (B1 and B3): rows m0 .. m0+mt, subspaces
// k0 .. k0+kn, staged ka subspaces at a time (fp32, in the staging area),
// one thread per (row, subspace) pair running vq_common's nearest, so
// B1's and B3's indices are the same bits. x and z come in with 16-byte
// loads, eight in flight a thread, where their rows are 16-byte aligned;
// with v = 8 the x row sits in registers. Writes idx[kk * rs + m]. Ends
// with a __syncthreads.
template <typename XT, bool SPLIT = true>
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
    bool split = false;       // few pairs (a live block's few rows)
    if constexpr (SPLIT) split = g.live && 2 * pairs <= THREADS;
    if (split) {
      assign_split(xs, zs, idx, a0, an, mt, xst, zst, c, v, metric, rs);
    } else if (v == 8) {  // the main path: v a literal, x in registers
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

// The k partitions of a block's SLOTS row slots: n partitions of w slots
// each, partition p taking subspaces [ceil(p kn / n), ceil((p+1) kn / n)).
// With live-row counts, as many as the block's lt live rows leave room
// for (SLOTS / lt of lt slots: 16 for one row, 8 for two, ..., 2 for 5-8,
// 1 above 8); without, 2 of 8 slots up to 8 rows, else 1.
struct Parts {
  int n, w;
};
__device__ __forceinline__ Parts parts_of(const Geometry& g, int lt) {
  if (g.live) return lt <= SLOTS / 2 ? Parts{SLOTS / lt, lt} : Parts{1, SLOTS};
  return g.parts == 2 ? Parts{2, SLOTS / 2} : Parts{1, SLOTS};
}

// The rows a thread sums without live-row counts: up to 8 rows of x, the
// block's threads split into two k partitions (slot / 8), each taking
// one row (slot % 8) and half of the subspaces, so all 8 warps gather;
// above 8 rows, one partition and rows slot + SLOTS * i.
struct Lane {
  int rbase, mrow, part;
};
__device__ __forceinline__ Lane lane_of(const Geometry& g) {
  const int slot = threadIdx.x / CH;
  if (g.parts == 2) return {slot % (SLOTS / 2), SLOTS / 2, slot / (SLOTS / 2)};
  return {slot, SLOTS, 0};
}

// With live-row counts: with one partition, rows slot + SLOTS * i;
// with n > 1, row slot % w of partition slot / w, so all 8 warps gather.
// Slots past n x w sit idle (part n, a row past every live row).
__device__ __forceinline__ Lane lane_of(Parts p) {
  const int slot = threadIdx.x / CH;
  if (p.n == 1) return {slot, SLOTS, 0};
  const int part = slot / p.w;
  if (part >= p.n) return {SLOTS, SLOTS, p.n};
  return {slot % p.w, SLOTS, part};
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

// With two k partitions (no live-row counts): partition 1 leaves its
// tile in shared memory (scratch, the staging area) and partition 0 adds
// it to its own, in that order (lower subspaces first). Ends with a
// __syncthreads.
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

// With live-row counts and n > 1 k partitions, the merge and the push in
// one pass over all the block's threads: every partition leaves its
// tile in shared memory (partition q's row r at slot q w + r), then each
// thread takes 16-byte quads of the (mt, BNE) tile, sums them over the
// partitions in order (lower subspaces first) and stores the sum into
// the owning rank's memory at push_partial's place; then the cluster
// barrier. (One half warp summing n - 1 tiles, push_partial's way, took
// ~6000 cycles a block at one live row: 15 tiles, bank conflicts.)
template <typename LT, int R>
__device__ __forceinline__ void push_merged(
    typename Acc<LT>::T* scratch, typename Acc<LT>::T* recv,
    const Geometry& g, int mt, Lane ln, Parts p,
    typename Acc<LT>::T (&a)[R][epc<LT>()]) {
  using AccT = typename Acc<LT>::T;
  constexpr int E = epc<LT>(), BNE = tile_cols<LT>();
  cg::cluster_group cluster = cg::this_cluster();
  if (ln.rbase < mt && ln.part < p.n) {
    AccT* t = scratch + (size_t)(ln.part * p.w + ln.rbase) * BNE +
              (threadIdx.x % CH) * E;
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<uint4*>(t + e) =
          make_uint4(bits(a[0][e]), bits(a[0][e + 1]), bits(a[0][e + 2]),
                     bits(a[0][e + 3]));
  }
  __syncthreads();
  const int slen = share_len<LT>(mt, g.cs);
  const int quads = mt * BNE / 4;
  for (int u = threadIdx.x; u < quads; u += THREADS) {
    const int m = 4 * u / BNE, col = 4 * u % BNE;
    AccT s4[4], t4[4];
    uint4 q = *reinterpret_cast<const uint4*>(scratch + (size_t)m * BNE +
                                              col);
    from_bits(q.x, s4[0]); from_bits(q.y, s4[1]);
    from_bits(q.z, s4[2]); from_bits(q.w, s4[3]);
    for (int k = 1; k < p.n; ++k) {
      q = *reinterpret_cast<const uint4*>(
          scratch + (size_t)(k * p.w + m) * BNE + col);
      from_bits(q.x, t4[0]); from_bits(q.y, t4[1]);
      from_bits(q.z, t4[2]); from_bits(q.w, t4[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) s4[i] += t4[i];
    }
    const int owner = u / slen;
    AccT* dst = cluster.map_shared_rank(recv, owner) +
                4 * ((size_t)blockIdx.y * slen + (u - owner * slen));
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(bits(s4[0]), bits(s4[1]), bits(s4[2]), bits(s4[3]));
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

// Live rows m0 .. m0+lt of a block's rows m0 .. m0+mt of expert e: all
// of them without counts, else those below the expert's count.
__device__ __forceinline__ int live_rows(const long long* counts, int e,
                                         int m0, int mt) {
  if (counts == nullptr) return mt;
  const long long n = __ldg(counts + e) - m0;
  return n <= 0 ? 0 : n < mt ? (int)n : mt;
}

// Where a block of B1 or B4 sits: expert e, columns n0 .., subspaces
// k0 .. k0+kn (the cluster spans grid y, so blockIdx.y is the block's
// rank), rows m0 .. m0+mt of its expert (grid z = E x row groups), of
// which the first lt are live.
struct Tile {
  int e, n0, k0, kn, m0, mt, lt;
};
template <typename LT>
__device__ __forceinline__ Tile tile_of(const Geometry& g, int M, int nc,
                                        const long long* counts) {
  Tile t;
  const int groups = (M + ROW_CAP - 1) / ROW_CAP;
  t.e = (int)blockIdx.z / groups;
  t.n0 = blockIdx.x * tile_cols<LT>();
  t.k0 = (int)((long)blockIdx.y * nc / g.cs);
  t.kn = (int)((long)(blockIdx.y + 1) * nc / g.cs) - t.k0;
  t.m0 = ((int)blockIdx.z - t.e * groups) * ROW_CAP;
  t.mt = min(ROW_CAP, M - t.m0);
  t.lt = live_rows(counts, t.e, t.m0, t.mt);
  return t;
}

// The tile's output rows past its live ones (rows m0+lt .. m0+mt, the
// tile's columns) written as 0.0, the cluster's ranks taking turns by
// THREADS elements; out is already the expert's.
template <typename LT>
__device__ __forceinline__ void zero_dead_rows(float* __restrict__ out,
                                               const Geometry& g, int N,
                                               const Tile& t) {
  constexpr int BNE = tile_cols<LT>();
  const int total = (t.mt - t.lt) * BNE;
  for (int i = (int)blockIdx.y * THREADS + threadIdx.x; i < total;
       i += g.cs * THREADS) {
    const int m = t.m0 + t.lt + i / BNE, n = t.n0 + i % BNE;
    if (n < N) out[(size_t)m * N + n] = 0.f;
  }
}

// An expert's operand: p moved by expert e's stride of `per` elements,
// in 64-bit arithmetic.
template <typename T>
__device__ __forceinline__ T* expert_ptr(T* p, int e, size_t per) {
  return p == nullptr ? p : p + (size_t)e * per;
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
// of its live rows into idx[kk * rs + m] (uint8, c <= 256). Neighbouring
// threads read neighbouring subspaces of one row (coalesced), eight
// loads in flight a thread before any is stored. Ends with a
// __syncthreads.
__device__ __forceinline__ void load_indices(const int* __restrict__ src,
                                             unsigned char* idx, int nc,
                                             const Tile& t, int rs) {
  const int total = t.lt * t.kn;
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

// Everything of a B1 or B4 block after the indices of its live rows are
// in shared memory: the gather-accumulate over its k partitions
// (parts_of), merged in order, the push to the owning ranks, the cluster
// barrier and the finish of this rank's share of the live rows. LIVE =
// false (B1 without counts, compiled on its own) is the code before
// live-row counts existed: two k partitions up to 8 rows, merged in
// order.
template <typename LT, int R, bool LIVE = true>
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
  if constexpr (!LIVE) {
    const Lane ln = lane_of(g);
    const int half = (t.kn + 1) / 2;    // partition 0 takes the lower half
    const int kbeg = g.parts == 1 || ln.part == 0 ? 0 : half;
    const int kend = g.parts == 1 || ln.part == 1 ? t.kn : half;
    gather_block<LT, R>(lut, smem + g.off_idx, g, c, N, t.k0, kbeg, kend,
                        t.n0, t.mt, rs, ln, a);
    VQG_STAMP(3);                       // gathered
    if constexpr (R == 1) {
      if (g.parts == 2)
        merge_partitions<LT>(reinterpret_cast<AccT*>(smem + g.off_stage),
                             t.mt, ln, a);
    }
    AccT* recv = reinterpret_cast<AccT*>(smem + g.off_recv);
    push_partial<LT, R>(recv, g, N, t.n0, t.mt, ln, a);
    VQG_STAMP(5);                       // past the cluster barrier
    finish_share<LT>(recv, g, scale,
                     reinterpret_cast<const float*>(smem + g.off_scale), out,
                     N, t.m0, t.mt, t.n0);
    return;
  }
  const Parts p = parts_of(g, t.lt);
  const Lane ln = lane_of(p);
  // partition q's subspaces start at ceil(q kn / n): with two, partition
  // 0 takes the larger half
  const int kbeg = (ln.part * t.kn + p.n - 1) / p.n;
  const int kend = ((ln.part + 1) * t.kn + p.n - 1) / p.n;
  gather_block<LT, R>(lut, smem + g.off_idx, g, c, N, t.k0, kbeg, kend,
                      t.n0, t.lt, rs, ln, a);
  VQG_STAMP(3);                         // gathered
  AccT* scratch = reinterpret_cast<AccT*>(smem + g.off_stage);
  AccT* recv = reinterpret_cast<AccT*>(smem + g.off_recv);
  if (g.live && p.n > 1) {
    push_merged<LT, R>(scratch, recv, g, t.lt, ln, p, a);
  } else {
    if constexpr (R == 1) {             // without counts: 2 up to 8 rows
      if (p.n == 2) merge_partitions<LT>(scratch, t.lt, ln, a);
    }
    push_partial<LT, R>(recv, g, N, t.n0, t.lt, ln, a);
  }
  VQG_STAMP(5);                         // past the cluster barrier
  finish_share<LT>(recv, g, scale,
                   reinterpret_cast<const float*>(smem + g.off_scale), out,
                   N, t.m0, t.lt, t.n0);
}

// Tile clusters: rank r's indices, subspaces [k0, k0 + kn) of rows
// stride rs (16-byte aligned), stored into the same place of every other
// rank's shared memory; then this thread's scale column and the cluster
// barrier, after which every rank holds all nc subspaces' indices and no
// rank touches another's memory again.
__device__ __forceinline__ void share_indices(unsigned char* idx, int k0,
                                              int kn, int rs, int tcs) {
  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const int q = kn * rs / 16;           // 16-byte words of the slice
  unsigned char* mine = idx + (size_t)k0 * rs;
  for (int i = threadIdx.x; i < q * (tcs - 1); i += THREADS) {
    const int r = i / q, j = i % q;
    const uint4 w = reinterpret_cast<const uint4*>(mine)[j];
    reinterpret_cast<uint4*>(
        cluster.map_shared_rank(mine, r < me ? r : r + 1))[j] = w;
  }
  cp_async_wait_all();               // this thread's scale column
  clus::arrive();
  clus::wait();
}

// Tile clusters: the block's k partitions' tiles of its live rows summed
// in partition order (as push_merged sums them), scaled and written out
// (as finish_share writes a share of one rank).
template <typename LT>
__device__ __forceinline__ void finish_local(
    typename Acc<LT>::T* scratch, const float* tile_scale,
    const float* __restrict__ scale, float* __restrict__ out, int N,
    const Tile& t, Lane ln, Parts p, typename Acc<LT>::T (&a)[1][epc<LT>()]) {
  using AccT = typename Acc<LT>::T;
  constexpr int E = epc<LT>(), BNE = tile_cols<LT>();
  if (ln.rbase < t.lt && ln.part < p.n) {
    AccT* d = scratch + (size_t)(ln.part * p.w + ln.rbase) * BNE +
              (threadIdx.x % CH) * E;
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<uint4*>(d + e) =
          make_uint4(bits(a[0][e]), bits(a[0][e + 1]), bits(a[0][e + 2]),
                     bits(a[0][e + 3]));
  }
  __syncthreads();
  VQG_STAMP(5);                         // partitions' tiles in place
  const int quads = t.lt * BNE / 4;
  for (int u = threadIdx.x; u < quads; u += THREADS) {
    const int m = 4 * u / BNE, col = 4 * u % BNE, n = t.n0 + col;
    if (n >= N) continue;
    AccT s4[4], t4[4];
    uint4 q = *reinterpret_cast<const uint4*>(scratch + (size_t)m * BNE +
                                              col);
    from_bits(q.x, s4[0]); from_bits(q.y, s4[1]);
    from_bits(q.z, s4[2]); from_bits(q.w, s4[3]);
    for (int k = 1; k < p.n; ++k) {
      q = *reinterpret_cast<const uint4*>(
          scratch + (size_t)(k * p.w + m) * BNE + col);
      from_bits(q.x, t4[0]); from_bits(q.y, t4[1]);
      from_bits(q.z, t4[2]); from_bits(q.w, t4[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) s4[i] += t4[i];
    }
    float* o = out + (size_t)(t.m0 + m) * N + n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (n + i < N) {
        float val = (float)s4[i];
        if (scale != nullptr) val *= tile_scale[col + i];
        o[i] = val;
      }
    }
  }
}

// Tile clusters: a live B1 block of one thread row a slot (R = 1) after
// tile_of (k0 = 0, kn = nc): its rank's share of the assignment, the
// indices shared over the cluster, the gather of all nc subspaces of
// its tile over its k partitions, and its rows written out. Operands
// are the expert's.
template <typename XT, typename LT>
__device__ __forceinline__ void tile_block(
    const XT* __restrict__ x, const XT* __restrict__ z,
    const LT* __restrict__ lut, const float* __restrict__ scale,
    float* __restrict__ out, unsigned char* smem, const Geometry& g,
    int nc, int c, int v, int N, int metric, const Tile& t) {
  using AccT = typename Acc<LT>::T;
  const int rs = idx_rows(1);
  const int rank = (int)blockIdx.x % g.tcs;
  const int k0 = (int)((long)rank * nc / g.tcs);
  const int kn = (int)((long)(rank + 1) * nc / g.tcs) - k0;
  unsigned char* idx = smem + g.off_idx;
  copy_scale<LT>(smem, g, scale, t.n0, N);
  assign_block<XT>(x, z, smem + g.off_stage, idx + (size_t)k0 * rs, g,
                   metric, nc, c, v, t.m0, t.lt, k0, kn, rs);
  VQG_STAMP(2);                         // assigned
  share_indices(idx, k0, kn, rs, g.tcs);
  VQG_STAMP(3);                         // every rank's indices here
  AccT a[1][epc<LT>()];
#pragma unroll
  for (int e = 0; e < epc<LT>(); ++e) a[0][e] = AccT(0);
  const Parts p = parts_of(g, t.lt);
  const Lane ln = lane_of(p);
  const int kbeg = (ln.part * nc + p.n - 1) / p.n;
  const int kend = ((ln.part + 1) * nc + p.n - 1) / p.n;
  gather_block<LT, 1>(lut, idx, g, c, N, 0, kbeg, kend, t.n0, t.lt, rs,
                      ln, a);
  VQG_STAMP(4);                         // gathered
  finish_local<LT>(reinterpret_cast<AccT*>(smem + g.off_stage),
                   reinterpret_cast<const float*>(smem + g.off_scale), scale,
                   out, N, t, ln, p, a);
}

// Host: a launch's grid (column tiles, padded to whole tile clusters; k
// splits; E x row groups) and cluster shape.
inline dim3 grid_of(const Geometry& g, int tiles, int groups, int E) {
  const int x = g.tcs ? (tiles + g.tcs - 1) / g.tcs * g.tcs : tiles;
  return dim3(x, g.cs, groups * E);
}
inline void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                           const Geometry& g, dim3 grid, cudaStream_t st) {
  clus::config(cfg, attr, grid, THREADS,
               g.tcs ? dim3(g.tcs, 1, 1) : dim3(1, g.cs, 1), g.smem, st);
}

// What a launch of B1 or B4 computes: E experts of M rows each; v = 0
// for B4 (no assignment); r rows a thread sums; live: the launch takes
// live-row counts, of which the call has at most most_live rows in all
// (0: E x M).
struct Shape {
  int E, M, nc, c, v, N, r;
  bool vec_x, vec_lut, live;
  int most_live;
  int cluster;     // a sweep's layout: k splits (> 0), tiles a tile
                   // cluster (< 0), or 0: plan's
};

// The live-row counts of a launch (null: none) and the most live rows
// the call can have in all (0: E x M), for the planners.
struct Live {
  const long long* counts;
  int most;
};

// Row groups of a launch that can hold a live row: each holds at least
// one of the call's most_live live rows.
inline long live_groups(const Shape& s) {
  const long groups = (long)((s.M + ROW_CAP - 1) / ROW_CAP) * s.E;
  return s.live && s.most_live > 0 && s.most_live < groups ? s.most_live
                                                            : groups;
}

using PlanKey = std::tuple<const void*, int, int, int, int, int, int, int,
                           int, int, int, int, int>;
inline std::mutex plan_mutex;
inline std::map<PlanKey, Geometry> plans;

// Host: the geometry of a launch of kern: the cluster size with the least
// estimated time among those the card can co-schedule at its shared
// memory. The estimate is waves of resident clusters x (subspaces a
// block + fixed), where fixed is the kernel's cost a block beyond its
// gather (staging, assignment or index load, partition and cluster
// sums) in units of one subspace's LUT rows; the clusters are those of
// the row groups that can be live (live_groups: all E experts' without
// counts). B1 with live rows and up to SLOTS rows takes tile clusters,
// estimated as waves x (subspaces a block assigns + subspaces a thread
// gathers at the partitions of the planned live rows + fixed). Cached
// per kernel, device, shape and live bound.
template <typename LT>
cudaError_t plan(Geometry& out, const void* kern, int fixed, const Shape& s) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const PlanKey key{kern, dev, s.E, s.M, s.nc, s.c, s.v, s.N,
                    (int)s.vec_x, (int)s.vec_lut, (int)s.live,
                    s.live ? s.most_live : 0, s.cluster};
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
  const long live = live_groups(s);
  long best = -1;
  const bool can_tile = s.live && s.r == 1 && s.v > 0;
  if (s.cluster < 0 && !can_tile) return cudaErrorInvalidValue;
  const bool tiled = can_tile && s.cluster <= 0;
  for (int cs = 1; cs <= MAX_CLUSTER && cs <= s.nc; ++cs) {
    if (s.cluster != 0 && cs != (s.cluster > 0 ? s.cluster : -s.cluster))
      continue;
    Geometry g;
    long clusters, per_block;
    if (tiled) {
      if (cs > TILE_CLUSTER ||
          !make_tile_geometry(g, s.M, s.nc, s.c, s.v, cs, (int)sizeof(LT),
                              s.vec_x, s.vec_lut, max_smem))
        continue;
      // the partitions of a live block at the call's mean live rows
      const long rows = (s.most_live > 0 ? s.most_live : (long)s.E * s.M);
      const long per_expert = (rows + live - 1) / live;
      const long parts = per_expert <= SLOTS / 2 ? SLOTS / per_expert : 1;
      clusters = (tiles + cs - 1) / cs * live;
      per_block = (s.nc + cs - 1) / cs + s.nc / parts + fixed;
    } else {
      if (!make_geometry(g, s.M, s.nc, s.c, s.v, cs, s.r, (int)sizeof(LT),
                         s.vec_x, s.vec_lut, s.live, max_smem))
        continue;
      clusters = (long)tiles * live;
      per_block = (s.nc + cs - 1) / cs + fixed;
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cluster_config(cfg, attr, g, grid_of(g, tiles, groups, s.E), 0);
    const int active = clus::max_active(kern, cfg);
    if (active < 1) continue;           // a size this card refuses
    const long waves = (clusters + active - 1) / active;
    const long cost = waves * per_block;
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
// (grid z: E x row groups) with args followed by the geometry. With info
// non-null: write the launch's k splits (cluster size along k), column
// tiles, row groups (of one expert), subspaces a block gathers, shared
// memory bytes and tiles a tile cluster spans (0: clusters along k) to
// info[0..5] and launch nothing.
template <typename LT, typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kern)(Params...), int fixed,
                           const Shape& s, cudaStream_t st, int* info,
                           Args... args) {
  Geometry g;
  cudaError_t err = plan<LT>(g, (const void*)kern, fixed, s);
  if (err != cudaSuccess) return err;
  const int tiles = (s.N + tile_cols<LT>() - 1) / tile_cols<LT>();
  const int groups = (s.M + ROW_CAP - 1) / ROW_CAP;
  if ((long)groups * s.E > 65535) return cudaErrorInvalidValue;
  if (info != nullptr) {
    info[0] = g.cs; info[1] = tiles; info[2] = groups; info[3] = g.kmax;
    info[4] = g.smem; info[5] = g.tcs;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, g, grid_of(g, tiles, groups, s.E), st);
  err = cudaLaunchKernelEx(&cfg, kern, args..., g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace vqg
