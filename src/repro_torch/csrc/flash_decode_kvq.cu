// Kernel B5: paged split-KV flash decode over a vector-quantized pool
// (uint8 centroid codes) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py::_splits_pallas_kvq (body
// _flash_kernel_kvq, _deq_tile), the TPU kernel behind every paged decode
// attention under QuantConfig(kv_quant="vq").
//
// B2's contract (flash_common.cuh) over a pool of codes:
//   kc, vc (P+1, page, KVH, nc) uint8: per token and kv head, the index of
//     the nearest centroid in each of the nc subspaces of head_dim
//   zk, zv (nc, c, v) f32 centroids of one layer; sk, sv (KVH,) f32 scales
//   row[h, s*v + e] = scale[h] * z[s, code[h, s], e]   (D = nc * v)
//
// Its roofline bound on the H100 is bytes: each live token costs 2 * nc
// code bytes per kv head (64 at the main shape, nc = 32) instead of B2's
// 2 * D * 2 = 512 in bf16, an 8x cut of the pool traffic. At decode
// lengths it runs far above that bound, held back, as B2 is, by a
// launch's fixed cost and each block's chain of dependent steps.
//
// Two forms in this one source; the launcher takes the first whose
// shared memory fits the block's 227 KB:
//  1. LUT form (the form of the JAX package's _flash_xla_kvq and of the
//     plain version). The block builds a score table
//       T[g, s, c] = sk * (q_g,s . zk[s, c])        (G x nc x c floats)
//     once, so a key's score is nc table lookups and adds instead of D
//     dequantized multiply-adds. q and both tables (16 KB at the main
//     shape; staged when they take at most 64 KB, else read through
//     L1/L2) arrive by cp.async while the page ids are read. A warp scores 32
//     keys at once, one per lane, each lane reading its key's codes as
//     16-byte vectors. The value side pools probability per (subspace,
//     centroid) in a per-warp table W[g, c, s] (lane s owns column s, so
//     the updates never collide), rescaled by the online softmax like
//     acc; zv is applied once, at the end: acc = sv * sum_c W[., c, s]
//     zv[s, c, .]. Codes stream through a ring of up to STAGES tiles of
//     128 tokens (flashc::load_rows: cp.async, 16 bytes each, when nc is
//     a multiple of 16), so a block spans many pages and builds its table
//     once for all of them.
//  2. Dequantize form, for codebooks whose T and W do not fit (G x nc x c
//     above ~10K entries): each tile's codes become fp32 K and V rows in
//     shared memory (tables staged there when they fit, else read through
//     L1/L2), then B2's row loop (flashc::RowGroup) scores them.
// Both read only the split's live token range; a split without a live
// key (pos = -1 lanes, splits past the sequence) writes (-1e30, 0, 0)
// without a load. Arithmetic is fp32 (expf).
//
// Each form has B2's two forms (flash_common.cuh): the triples form (qg
// f32, already scaled; triples to device memory) and the fused form, the
// one flash_decode_paged launches (q f32|bf16, scaled as the score table
// is built; the NS <= 16 splits of one (slot, kv head) form a thread
// block cluster and fold their triples with the new token's self term in
// shared memory, flashc::fold_begin / fold_end; out (B, 1, KVH * G * D)
// in q's type). Also replaces, in the fused form, the XLA tail of
// flash_decode_paged (src/repro/kernels/flash_decode.py:501, 516-527).
// The fused form's triple sits over the ring and T when they hold it,
// its push slots after the page ids; at shapes where those slots tip the
// LUT form over the block's shared memory it takes the dequantize form.

#include "flash_common.cuh"

namespace {

using namespace flashc;

constexpr int TKQ = 32 * WARPS;                   // LUT form: tokens a tile

// Byte layout of the LUT form's shared memory: a ring of nst code tiles,
// T, one W per warp, the warps' (m, l), each warp's 32 probabilities, q,
// the tables when staged, and the split's page ids. The tables are staged when they take at most
// 64 KB (both), else read through L1/L2.
struct LutLayout {
  int rs, nst;                                    // code row stride, stages
  size_t t_off, w_off, red_off, p_off, q_off, tab_off, pages_off, trip_off,
      fold_off, total;
  bool staged;
  __host__ __device__ LutLayout(int G, int D, int nc, int c, int v, int sp,
                                int ps, bool fold) {
    rs = round_up(nc, 16);
    if ((rs / 16) % 2 == 0) rs += 16;             // odd chunk stride: no bank
    nst = (int)(((size_t)sp * ps + TKQ - 1) / TKQ); //   conflicts on uint4
    if (nst > STAGES) nst = STAGES;
    t_off = (size_t)nst * 2 * TKQ * rs;
    w_off = t_off + sizeof(float) * (size_t)G * nc * c;
    red_off = w_off + sizeof(float) * (size_t)WARPS * G * c * nc;
    p_off = red_off + sizeof(float) * 2 * WARPS * G;
    q_off = round_up((int)(p_off + sizeof(float) * WARPS * G * 32), 16);
    tab_off = round_up((int)(q_off + sizeof(float) * (size_t)G * D), 16);
    const size_t tables = 2 * sizeof(float) * (size_t)nc * c * v;
    staged = tables <= 64 * 1024 &&
             tab_off + tables + sizeof(int) * (size_t)sp <= MAX_DYN_SMEM;
    pages_off = tab_off + (staged ? tables : 0);
    total = pages_off + sizeof(int) * (size_t)sp;
    trip_off = fold_off = 0;
    if (!fold) return;
    // the fused form's triple: over the ring and T, free once the keys
    // are scored, when they hold it; else behind the page ids. Its push
    // slots last.
    const size_t trip = sizeof(float) * triple_floats(G, D);
    trip_off = w_off >= trip ? 0 : round_up((int)total, 16);
    if (trip_off != 0) total = trip_off + trip;
    fold_off = round_up((int)total, 16);
    total = fold_off + sizeof(float) * fold_floats(G, D);
  }
};

// Byte layout of the dequantize form's shared memory: one tile of fp32 K
// and V rows (reused for the group merge and, behind it, the fused form's
// triple), the tables when staged, pages.
struct DeqLayout {
  int tk;
  size_t trip_off, tab_off, pages_off, fold_off, total;
  bool staged;
  __host__ __device__ DeqLayout(int G, int D, int nc, int c, int v, int sp,
                                bool fold) {
    const RowGeom geom(D, sizeof(float));
    tk = 64;
    while (tk > 8 && 2 * (size_t)tk * geom.row_bytes() > 32 * 1024) tk /= 2;
    const size_t tile = 2 * (size_t)tk * geom.row_bytes();
    const size_t merge = sizeof(float) * geom.merge_floats(G, D);
    trip_off = round_up((int)merge, 16);
    const size_t trip_end =
        fold ? trip_off + sizeof(float) * triple_floats(G, D) : merge;
    tab_off = round_up((int)(tile > trip_end ? tile : trip_end), 16);
    const size_t tables = 2 * sizeof(float) * (size_t)nc * c * v;
    const size_t slots = fold ? sizeof(float) * fold_floats(G, D) + 16 : 0;
    staged =
        tab_off + tables + sizeof(int) * (size_t)sp + slots <= MAX_DYN_SMEM;
    pages_off = tab_off + (staged ? tables : 0);
    fold_off = round_up((int)(pages_off + sizeof(int) * (size_t)sp), 16);
    total = fold ? fold_off + sizeof(float) * fold_floats(G, D)
                 : pages_off + sizeof(int) * (size_t)sp;
  }
};

// The LUT form's triple over the live range r of a split (not empty).
template <typename QT, int G>
__device__ __forceinline__ void lut_body(
    const QT* __restrict__ qbh, float q_scale,
    const uint8_t* __restrict__ kc, const uint8_t* __restrict__ vc,
    const float* __restrict__ zk, const float* __restrict__ zv,
    const float* __restrict__ sk, const float* __restrict__ sv,
    const int* __restrict__ phys, int b, int h, int KVH, int D, int ps,
    int NP, int nc, int c, int v, const LutLayout& lay, const SplitPages& pg,
    const Range& r, const TripleDst& dst) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nst = lay.nst;
  float* T = reinterpret_cast<float*>(smem + lay.t_off);     // [G][nc][c]
  float* W = reinterpret_cast<float*>(smem + lay.w_off);     // [WARPS][G][c][nc]
  float* red = reinterpret_cast<float*>(smem + lay.red_off); // m, l [WARPS][G]
  float* P = reinterpret_cast<float*>(smem + lay.p_off);     // [WARPS][G][32]
  const QT* q_s = reinterpret_cast<const QT*>(smem + lay.q_off);  // [G][D]
  int* pages_s = reinterpret_cast<int*>(smem + lay.pages_off);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tab = nc * c * v;

  // q and (when staged) both tables: one group of copies, in flight
  // while the page ids are read
  copy_async(smem + lay.q_off, qbh, sizeof(QT) * G * D);
  const float* zk_t = zk;
  const float* zv_t = zv;
  if (lay.staged) {
    float* zks = reinterpret_cast<float*>(smem + lay.tab_off);
    copy_async(zks, zk, sizeof(float) * n_tab);
    copy_async(zks + n_tab, zv, sizeof(float) * n_tab);
    zk_t = zks;
    zv_t = zks + n_tab;
  }
  cp_async_commit();
  store_pages(pg, phys, b, NP, pages_s);
  const int first = pg.first;
  for (int i = tid; i < WARPS * G * c * nc; i += THREADS) W[i] = 0.f;
  __syncthreads();                                // pages_s

  const int ntiles = (r.hi - r.lo + TKQ - 1) / TKQ;
  const size_t stage_bytes = (size_t)2 * TKQ * lay.rs;
  auto load_tile = [&](int i) {
    const int t0 = r.lo + i * TKQ;
    unsigned char* st = smem + (size_t)(i % nst) * stage_bytes;
    load_rows(kc + (size_t)h * nc, vc + (size_t)h * nc, (size_t)KVH * nc, ps,
              pages_s, first, t0, min(TKQ, r.hi - t0), nc, st,
              st + (size_t)TKQ * lay.rs, lay.rs);
  };
  for (int i = 0; i < nst; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }

  // T from q (times q_scale) and zk, scaled by sk
  cp_async_wait(nst);                             // q and the tables
  __syncthreads();
  const float skh = sk[h];
  for (int i = tid; i < G * nc * c; i += THREADS) {
    const int g = i / (nc * c), sub = (i / c) % nc, cc = i % c;
    const float* z = zk_t + ((size_t)sub * c + cc) * v;
    const QT* qq = q_s + g * D + sub * v;
    float a = 0.f;
    for (int e = 0; e < v; ++e) a += scaled(qq[e], q_scale) * z[e];
    T[i] = a * skh;
  }

  float* Ww = W + (size_t)warp * G * c * nc;
  const int nch = (nc + 15) / 16;                 // 16-byte chunks a row
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait(nst - 1);                       // tile i has landed
    __syncthreads();                              // (and T, at i = 0)
    const unsigned char* st = smem + (size_t)(i % nst) * stage_bytes;
    const int n = min(TKQ, r.hi - r.lo - i * TKQ);
    const int nk = min(32, n - warp * 32);        // this warp's keys
    if (nk > 0) {
      // scores: lane = key, nc lookups each
      float sc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = 0.f;
      if (lane < nk) {
        const unsigned char* kr = st + (warp * 32 + lane) * lay.rs;
        for (int ch = 0; ch < nch; ++ch) {
          const uint4 u = *reinterpret_cast<const uint4*>(kr + ch * 16);
          const unsigned w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int bb = 0; bb < 16; ++bb) {
            const int sub = ch * 16 + bb;
            if (sub < nc) {
              const int code = (w4[bb >> 2] >> (8 * (bb & 3))) & 0xff;
#pragma unroll
              for (int g = 0; g < G; ++g) sc[g] += T[((size_t)g * nc + sub) * c + code];
            }
          }
        }
      }
      // online softmax over the warp's keys
      float p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mx = warp_max(lane < nk ? sc[g] : NEG_INF);
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        p[g] = lane < nk ? expf(sc[g] - m_new) : 0.f;
        const float sum = warp_sum(p[g]);
        if (alpha != 1.f && l[g] != 0.f)          // W is all zero while l is
          for (int e = lane; e < c * nc; e += 32) Ww[(size_t)g * c * nc + e] *= alpha;
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
      }
      // values: probability pooled per (centroid, subspace); lane = s.
      // The lane's codes and the probabilities are read before its
      // read-modify-writes of W, which then form the only chain.
      float* Pw = P + warp * G * 32;
#pragma unroll
      for (int g = 0; g < G; ++g) Pw[g * 32 + lane] = p[g];
      __syncwarp();
      const unsigned char* vt = st + (size_t)TKQ * lay.rs + warp * 32 * lay.rs;
      for (int sub = lane; sub < nc; sub += 32) {
        int code[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) code[k] = k < nk ? vt[k * lay.rs + sub] : 0;
#pragma unroll
        for (int k = 0; k < 32; ++k)
          if (k < nk)
#pragma unroll
            for (int g = 0; g < G; ++g)
              Ww[((size_t)g * c + code[k]) * nc + sub] += Pw[g * 32 + k];
      }
    }
    __syncthreads();                              // its stage is free
    if (i + nst < ntiles) load_tile(i + nst);
    cp_async_commit();
  }

  // merge the warps: W[0] = sum_w exp(m_w - M) W[w]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red[warp * G + g] = m[g];
      red[(WARPS + warp) * G + g] = l[g];
    }
  }
  __syncthreads();
  float mt[G], f[WARPS][G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mt[g] = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt[g] = fmaxf(mt[g], red[w * G + g]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) f[w][g] = expf(red[w * G + g] - mt[g]);
  }
  const int per_g = c * nc;
  for (int i = tid; i < G * per_g; i += THREADS) {
    const int g = i / per_g;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
        if (gg == g) a += f[w][gg] * W[(size_t)w * G * per_g + i];
    W[i] = a;
  }
  __syncthreads();
  // acc = sv * sum_c W[g, c, s] zv[s, c, .]
  const float svh = sv[h];
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D, sub = d / v, e = d % v;
    const float* wg = W + (size_t)g * per_g + sub;
    const float* z = zv_t + (size_t)sub * c * v + e;
    float a = 0.f;
    for (int cc = 0; cc < c; ++cc) a += wg[(size_t)cc * nc] * z[(size_t)cc * v];
    dst.acc[i] = a * svh;
    if (d == 0) {
      float lt = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
#pragma unroll
        for (int gg = 0; gg < G; ++gg)
          if (gg == g) lt += f[w][gg] * red[(WARPS + w) * G + gg];
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
        if (gg == g) dst.m[g] = mt[gg];
      dst.l[g] = lt;
    }
  }
}

template <typename QT, int G, bool FOLD>
__global__ void __launch_bounds__(THREADS)
kvq_lut_kernel(const QT* __restrict__ q, float q_scale,
               const uint8_t* __restrict__ kc, const uint8_t* __restrict__ vc,
               const float* __restrict__ zk, const float* __restrict__ zv,
               const float* __restrict__ sk, const float* __restrict__ sv,
               const int* __restrict__ phys, const int* __restrict__ pos,
               const int* __restrict__ kvs, int window, Dest<QT> io, int B,
               int KVH, int D, int ps, int NP, int sp, int nc, int c, int v) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * KVH + h;
  const LutLayout lay(G, D, nc, c, v, sp, ps, FOLD);
  const TripleDst dst = triple_dst<FOLD>(
      io, smem, lay.trip_off, (((size_t)s * B + b) * KVH + h) * G, G, D);
  const SplitPages pg = fetch_pages(phys, b, NP, s, sp);
  const Range r = split_range(pos, kvs, window, b, s, sp, ps, NP);
  float* fold_s = reinterpret_cast<float*>(smem + lay.fold_off);
  [[maybe_unused]] FoldPlan plan;
  if constexpr (FOLD) {
    plan = fold_begin(pos, kvs, window, b, (int)gridDim.x, sp, ps, NP, G, D,
                      io.k_new, io.v_new, bh, fold_s);
    if (plan.leave) return;
  }
  if (r.lo >= r.hi) {
    write_identity(dst, G, D);
  } else {
    lut_body<QT, G>(q + bh * G * D, q_scale, kc, vc, zk, zv, sk, sv, phys, b,
                    h, KVH, D, ps, NP, nc, c, v, lay, pg, r, dst);
  }
  if constexpr (FOLD)
    fold_end<QT, G>(plan, dst, fold_s, q, q_scale, io.v_new, io.out, bh,
                    D, (int)gridDim.x);
}

// The dequantize form's triple over the live range r of a split (not
// empty).
template <typename QT, int G>
__device__ __forceinline__ void deq_body(
    const QT* __restrict__ qbh, float q_scale,
    const uint8_t* __restrict__ kc, const uint8_t* __restrict__ vc,
    const float* __restrict__ zk, const float* __restrict__ zv,
    const float* __restrict__ sk, const float* __restrict__ sv,
    const int* __restrict__ phys, int b, int h, int KVH, int D, int ps,
    int NP, int nc, int c, int v, const DeqLayout& lay, const SplitPages& pg,
    const Range& r, const TripleDst& tri) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RowGeom geom(D, sizeof(float));
  const int rb = geom.row_bytes(), rf = rb / 4;   // row floats (padded)
  int* pages_s = reinterpret_cast<int*>(smem + lay.pages_off);
  store_pages(pg, phys, b, NP, pages_s);
  const int first = pg.first;
  const float* zk_t = zk;
  const float* zv_t = zv;
  if (lay.staged) {
    const int n = nc * c * v;
    float* zks = reinterpret_cast<float*>(smem + lay.tab_off);
    float* zvs = zks + n;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      zks[i] = zk[i];
      zvs[i] = zv[i];
    }
    zk_t = zks;
    zv_t = zvs;
  }
  const float skh = sk[h], svh = sv[h];
  const size_t row_stride = (size_t)KVH * nc;
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + (size_t)lay.tk * rf;
  RowGroup<float, G> grp;
  grp.init(qbh, q_scale, D, geom);
  __syncthreads();                                // pages_s, tables

  for (int t0 = r.lo; t0 < r.hi; t0 += lay.tk) {
    const int n = min(lay.tk, r.hi - t0);
    for (int idx = threadIdx.x; idx < 2 * n * nc; idx += THREADS) {
      const int kv = idx >= n * nc, rem = idx - kv * n * nc;
      const int row = rem / nc, sub = rem % nc, t = t0 + row;
      const size_t page = (size_t)pages_s[t / ps - first];
      const int code = (kv ? vc : kc)[(page * ps + t % ps) * row_stride +
                                      (size_t)h * nc + sub];
      const float* z = (kv ? zv_t : zk_t) + ((size_t)sub * c + code) * v;
      const float scale = kv ? svh : skh;
      float* dst = (kv ? v_s : k_s) + (size_t)row * rf + sub * v;
      for (int e = 0; e < v; ++e) dst[e] = z[e] * scale;
    }
    for (int idx = threadIdx.x; idx < 2 * n * (rf - D); idx += THREADS) {
      const int kv = idx >= n * (rf - D), rem = idx - kv * n * (rf - D);
      (kv ? v_s : k_s)[(size_t)(rem / (rf - D)) * rf + D + rem % (rf - D)] = 0.f;
    }
    __syncthreads();
    grp.tile(reinterpret_cast<const unsigned char*>(k_s),
             reinterpret_cast<const unsigned char*>(v_s), n, geom);
    __syncthreads();
  }
  grp.finish(reinterpret_cast<float*>(smem), geom, tri, D);
}

template <typename QT, int G, bool FOLD>
__global__ void __launch_bounds__(THREADS)
kvq_deq_kernel(const QT* __restrict__ q, float q_scale,
               const uint8_t* __restrict__ kc, const uint8_t* __restrict__ vc,
               const float* __restrict__ zk, const float* __restrict__ zv,
               const float* __restrict__ sk, const float* __restrict__ sv,
               const int* __restrict__ phys, const int* __restrict__ pos,
               const int* __restrict__ kvs, int window, Dest<QT> io, int B,
               int KVH, int D, int ps, int NP, int sp, int nc, int c, int v) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * KVH + h;
  const DeqLayout lay(G, D, nc, c, v, sp, FOLD);
  const TripleDst tri = triple_dst<FOLD>(
      io, smem, lay.trip_off, (((size_t)s * B + b) * KVH + h) * G, G, D);
  const SplitPages pg = fetch_pages(phys, b, NP, s, sp);
  const Range r = split_range(pos, kvs, window, b, s, sp, ps, NP);
  float* fold_s = reinterpret_cast<float*>(smem + lay.fold_off);
  [[maybe_unused]] FoldPlan plan;
  if constexpr (FOLD) {
    plan = fold_begin(pos, kvs, window, b, (int)gridDim.x, sp, ps, NP, G, D,
                      io.k_new, io.v_new, bh, fold_s);
    if (plan.leave) return;
  }
  if (r.lo >= r.hi) {
    write_identity(tri, G, D);
  } else {
    deq_body<QT, G>(q + bh * G * D, q_scale, kc, vc, zk, zv, sk, sv, phys, b,
                    h, KVH, D, ps, NP, nc, c, v, lay, pg, r, tri);
  }
  if constexpr (FOLD)
    fold_end<QT, G>(plan, tri, fold_s, q, q_scale, io.v_new, io.out, bh,
                    D, (int)gridDim.x);
}

// 1: LUT form, 2: dequantize form, 0: neither fits (fold: the fused
// form, whose push slots may tip a shape into the dequantize form).
int pick_form(int G, int D, int ps, int sp, int nc, int c, int v, bool fold) {
  if (LutLayout(G, D, nc, c, v, sp, ps, fold).total <= MAX_DYN_SMEM)
    return 1;
  return DeqLayout(G, D, nc, c, v, sp, fold).total <= MAX_DYN_SMEM ? 2 : 0;
}

template <typename QT, int G, bool FOLD>
int launch(int form, const QT* q, float q_scale, const uint8_t* kc,
           const uint8_t* vc, const float* zk, const float* zv,
           const float* sk, const float* sv, const int* ph, const int* po,
           const int* ks, int window, const Dest<QT>& io, int B, int KVH,
           int D, int ps, int NP, int sp, int nc, int c, int v,
           cudaStream_t st, int* info) {
  const int ns = (NP + sp - 1) / sp;
  const dim3 grid(ns, KVH, B);
  auto kernel = form == 1 ? kvq_lut_kernel<QT, G, FOLD>
                          : kvq_deq_kernel<QT, G, FOLD>;
  const size_t smem = form == 1
                          ? LutLayout(G, D, nc, c, v, sp, ps, FOLD).total
                          : DeqLayout(G, D, nc, c, v, sp, FOLD).total;
  if constexpr (FOLD) {
    if (ns > MAX_SPLITS) return (int)cudaErrorInvalidValue;
    return (int)clus::launch_x(kernel, grid, THREADS, ns, smem,
                               (int)MAX_DYN_SMEM, st, info, q, q_scale, kc,
                               vc, zk, zv, sk, sv, ph, po, ks, window, io, B,
                               KVH, D, ps, NP, sp, nc, c, v);
  } else {
    static bool opted_in[2] = {false, false};
    if (!opted_in[form - 1]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)MAX_DYN_SMEM);
      if (err != cudaSuccess) return (int)err;
      opted_in[form - 1] = true;
    }
    kernel<<<grid, THREADS, smem, st>>>(q, q_scale, kc, vc, zk, zv, sk, sv,
                                        ph, po, ks, window, io, B, KVH, D, ps,
                                        NP, sp, nc, c, v);
    return (int)cudaGetLastError();
  }
}

bool bad_shape(int B, int KVH, int G, int D, int ps, int NP, int sp, int nc,
               int c, int v) {
  return B <= 0 || KVH <= 0 || G < 1 || G > MAX_G || D < 1 || D > MAX_D ||
         ps < 1 || NP < 1 || sp < 1 || nc < 1 || v < 1 || nc * v != D ||
         c < 1 || c > 256 || KVH > 65535 || B > 65535;
}

template <typename QT, bool FOLD>
int launch_typed(const void* q, float q_scale, const void* kc,
                 const void* vc, const void* zk, const void* zv,
                 const void* sk, const void* sv, const void* phys,
                 const void* pos, const void* kv_start, int window,
                 const Dest<QT>& io, int B, int KVH, int G, int D, int ps,
                 int NP, int sp, int nc, int c, int v, void* stream,
                 int* info = nullptr) {
  const int form = pick_form(G, D, ps, sp, nc, c, v, FOLD);
  if (form == 0) return (int)cudaErrorInvalidValue;
  return with_g(G, [&](auto gg) {
    return launch<QT, decltype(gg)::value, FOLD>(
        form, static_cast<const QT*>(q), q_scale,
        static_cast<const uint8_t*>(kc), static_cast<const uint8_t*>(vc),
        static_cast<const float*>(zk), static_cast<const float*>(zv),
        static_cast<const float*>(sk), static_cast<const float*>(sv),
        static_cast<const int*>(phys), static_cast<const int*>(pos),
        static_cast<const int*>(kv_start), window, io, B, KVH, D, ps, NP, sp,
        nc, c, v, static_cast<cudaStream_t>(stream), info);
  });
}

}  // namespace

// The form a launch with these shapes takes: 1 (LUT) or 2 (dequantize),
// or 0 when it cannot launch; fused: the fused form's launch.
extern "C" int flash_decode_kvq_form(int G, int D, int ps, int sp, int nc,
                                     int c, int v, int fused) {
  return pick_form(G, D, ps, sp, nc, c, v, fused != 0);
}

// The triples form. kc, vc uint8 code pools; zk, zv (nc, c, v) f32; sk,
// sv (KVH,) f32. Returns a cudaError_t.
extern "C" int flash_decode_splits_kvq_launch(
    const void* qg, const void* kc, const void* vc, const void* zk,
    const void* zv, const void* sk, const void* sv, const void* phys,
    const void* pos, const void* kv_start, int window, void* m, void* l,
    void* acc, int B, int KVH, int G, int D, int ps, int NP, int sp,
    int nc, int c, int v, void* stream) {
  if (bad_shape(B, KVH, G, D, ps, NP, sp, nc, c, v))
    return (int)cudaErrorInvalidValue;
  const Dest<float> io{static_cast<float*>(m), static_cast<float*>(l),
                       static_cast<float*>(acc), nullptr, nullptr, nullptr};
  return launch_typed<float, false>(qg, 1.f, kc, vc, zk, zv, sk, sv, phys,
                                    pos, kv_start, window, io, B, KVH, G, D,
                                    ps, NP, sp, nc, c, v, stream);
}

// The fused form: q (B, 1, KVH * G, D), k_new, v_new (B, 1, KVH, D) and
// out (B, 1, KVH * G * D) in q's type (q_dtype: 0 f32, 1 bf16); q_scale
// multiplies q as it is read. More than MAX_SPLITS splits, or a cluster
// the card cannot hold, launch nothing. With info non-null: the launch's
// geometry (clus::launch_x) and no launch. Returns a cudaError_t.
extern "C" int flash_decode_paged_kvq_launch(
    const void* q, const void* kc, const void* vc, const void* zk,
    const void* zv, const void* sk, const void* sv, const void* k_new,
    const void* v_new, const void* phys, const void* pos,
    const void* kv_start, int window, void* out, float q_scale, int B,
    int KVH, int G, int D, int ps, int NP, int sp, int nc, int c, int v,
    int q_dtype, void* stream, int* info) {
  if (bad_shape(B, KVH, G, D, ps, NP, sp, nc, c, v) || q_dtype < 0 ||
      q_dtype > 1 || (NP + sp - 1) / sp > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto qt) {
    using QT = decltype(qt);
    const Dest<QT> io{nullptr, nullptr, nullptr,
                      static_cast<const QT*>(k_new),
                      static_cast<const QT*>(v_new), static_cast<QT*>(out)};
    return launch_typed<QT, true>(q, q_scale, kc, vc, zk, zv, sk, sv, phys,
                                  pos, kv_start, window, io, B, KVH, G, D,
                                  ps, NP, sp, nc, c, v, stream, info);
  };
  return q_dtype == 0 ? run(float{}) : run(__nv_bfloat16{});
}
