// Kernel B2: paged split-KV flash decode (single query token per slot)
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py::_splits_pallas (body
// _flash_kernel), the TPU kernel behind every paged decode attention, and,
// in its fused form, the XLA tail of flash_decode_paged that follows it
// (lines 501 and 516-527: the split reduction and the self-term fold).
//
// Per (slot b, kv head h, split s) it computes the softmax triple over the
// keys of the split's pages, for each of the G query heads of the group:
//   m = max_j s_j,  l = sum_j exp(s_j - m),  acc = sum_j exp(s_j - m) v_j
// over live keys j: kv_start <= j < pos (and j > pos - window when
// window > 0). An all-masked split gives exactly (-1e30, 0, 0), the
// identity of the split reduction.
//
//   k_pages, v_pages (P+1, page, KVH, D) f32|bf16 (one layer of the pool;
//     the last page is the trash page)
//   phys (B, NP) int32 physical page ids, trash-redirected
//   pos, kv_start (B,) int32; window (scalar)
//   triples form: qg (B, KVH, G, D) f32, already scaled by D^-0.5;
//     out m, l (NS, B, KVH, G) f32, acc (NS, B, KVH, G, D) f32
//   fused form: q (B, 1, KVH * G, D) f32|bf16 (scaled here), k_new, v_new
//     (B, 1, KVH, D) in q's type; out (B, 1, KVH * G * D) in q's type.
//     The NS <= 16 splits of one (b, h) form a thread block cluster and
//     fold their triples in shared memory (flashc::fold_begin, fold_end).
//
// Its roofline bound on the H100 is bytes: each live K and V row is read
// once (2 * D * 2 bytes in bf16) for 4 * D * G flops, ~G flops per byte,
// far below the ~20 flops/byte at which fp32 CUDA-core arithmetic would
// bind. At decode lengths it runs well above that bound, held back by
// latency: a launch's fixed cost and each block's chain of dependent
// steps (page ids, first tile, scores, merge, write), which only many
// blocks in flight hide. The fused form takes the second launch (the
// fold) and the triples' round trip through device memory off that
// chain.
//
// Design:
//  * One block (128 threads) per (split, kv head, slot); a split spans
//    several pages (the wrapper's split rule, split_pages_for, aims at
//    ten blocks per SM). The block reads its own page ids from phys into
//    shared memory; the TPU's scalar prefetch has no counterpart. The
//    TPU carries (m, l, acc) in VMEM across a page grid axis; here each
//    row group carries them in registers across the block's tiles.
//  * Only the split's live keys are read: one contiguous token range, so
//    dead pages, trash pages and pos = -1 lanes cost nothing, and a split
//    without a live key writes the identity without a load.
//  * Keys stream through a ring of up to STAGES tiles of TK tokens in
//    shared memory, in the storage type: each 16-byte chunk of a row is
//    one cp.async (flashc::load_rows), so the next tiles are in flight
//    while one is scored. A tile holds TK tokens whatever the page size,
//    so every page size takes the same shared memory (at most 48 KB for
//    the ring, less when a split holds fewer tiles than STAGES).
//  * Scores, online softmax and the value sum: flashc::RowGroup (a group
//    of lanes per key, D split across its lanes as 16-byte chunks; state
//    in registers; one merge per block). Arithmetic is fp32 (expf);
//    masked keys get probability 0 by the mask, never through exp(-inf).
//  * GQA: the G query heads sharing a kv head share each K/V row load.
//  * Rows whose byte length is not a multiple of 16 (D * size not 16-byte
//    aligned) are copied byte by byte instead of by cp.async, and
//    zero-padded to whole chunks.
//  * The two forms are one kernel template (FOLD). The fused form's
//    triple sits behind the group merge's scratch, in the ring's space,
//    and its push slots behind the page ids.

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace {

using namespace flashc;

template <typename KT, typename QT, int G, bool FOLD>
__global__ void __launch_bounds__(THREADS)
flash_splits_kernel(const QT* __restrict__ q, float q_scale,
                    const KT* __restrict__ kp, const KT* __restrict__ vp,
                    const int* __restrict__ phys,
                    const int* __restrict__ pos, const int* __restrict__ kvs,
                    int window, Dest<QT> io, int B, int KVH, int D, int ps,
                    int NP, int sp, int tk, int nst, size_t pages_off,
                    size_t trip_off, size_t fold_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * KVH + h;
  const TripleDst dst = triple_dst<FOLD>(
      io, smem, trip_off, (((size_t)s * B + b) * KVH + h) * G, G, D);
  const SplitPages pg = fetch_pages(phys, b, NP, s, sp);
  const Range r = split_range(pos, kvs, window, b, s, sp, ps, NP);
  float* fold_s = reinterpret_cast<float*>(smem + fold_off);
  [[maybe_unused]] FoldPlan plan;
  if constexpr (FOLD) {
    plan = fold_begin(pos, kvs, window, b, (int)gridDim.x, sp, ps, NP, G, D,
                      io.k_new, io.v_new, bh, fold_s);
    if (plan.leave) return;
  }
  if (r.lo >= r.hi) {
    write_identity(dst, G, D);
  } else {
    const RowGeom geom(D, sizeof(KT));
    const int rb = geom.row_bytes();
    const size_t stage_bytes = 2 * (size_t)tk * rb;  // K rows, then V rows
    int* pages_s = reinterpret_cast<int*>(smem + pages_off);
    store_pages(pg, phys, b, NP, pages_s);
    const int first = pg.first;
    const size_t tok_bytes = (size_t)KVH * D * sizeof(KT);
    const unsigned char* kb =
        reinterpret_cast<const unsigned char*>(kp + (size_t)h * D);
    const unsigned char* vb =
        reinterpret_cast<const unsigned char*>(vp + (size_t)h * D);
    RowGroup<KT, G> grp;
    grp.init(q + bh * G * D, q_scale, D, geom);
    __syncthreads();                                 // pages_s

    const int ntiles = (r.hi - r.lo + tk - 1) / tk;
    auto load_tile = [&](int i) {
      const int t0 = r.lo + i * tk;
      unsigned char* st = smem + (size_t)(i % nst) * stage_bytes;
      load_rows(kb, vb, tok_bytes, ps, pages_s, first, t0,
                min(tk, r.hi - t0), D * (int)sizeof(KT), st,
                st + (size_t)tk * rb, rb);
    };
    for (int i = 0; i < nst; ++i) {
      if (i < ntiles) load_tile(i);
      cp_async_commit();
    }
    for (int i = 0; i < ntiles; ++i) {
      cp_async_wait(nst - 1);                        // tile i has landed
      __syncthreads();
      const unsigned char* st = smem + (size_t)(i % nst) * stage_bytes;
      grp.tile(st, st + (size_t)tk * rb, min(tk, r.hi - r.lo - i * tk),
               geom);
      __syncthreads();                               // its stage is free
      if (i + nst < ntiles) load_tile(i + nst);
      cp_async_commit();
    }
    grp.finish(reinterpret_cast<float*>(smem), geom, dst, D);
  }
  if constexpr (FOLD)
    fold_end<QT, G>(plan, dst, fold_s, q, q_scale, io.v_new, io.out, bh,
                    D, (int)gridDim.x);
}

// Tokens per tile: the most (a power of two, 8 to 64) whose ring of
// STAGES tiles of K and V rows fits 48 KB.
int tile_tokens(int row_bytes) {
  int tk = 64;
  while (tk > 8 && (size_t)STAGES * 2 * tk * row_bytes > 48 * 1024) tk /= 2;
  return tk;
}

template <typename KT, typename QT, int G, bool FOLD>
int launch(const QT* q, float q_scale, const KT* kp, const KT* vp,
           const int* ph, const int* po, const int* ks, int window,
           const Dest<QT>& io, int B, int KVH, int D, int ps, int NP, int sp,
           cudaStream_t st, int* info) {
  const RowGeom geom(D, sizeof(KT));
  const int tk = tile_tokens(geom.row_bytes());
  // stages: no more than the tiles a split can hold
  const int nst = min(STAGES, (int)(((size_t)sp * ps + tk - 1) / tk));
  const size_t ring = (size_t)nst * 2 * tk * geom.row_bytes();
  // the fused form's triple behind the group merge's scratch, its push
  // slots behind the page ids
  const size_t merge = sizeof(float) * geom.merge_floats(G, D);
  const size_t trip_off = round_up((int)merge, 16);
  const size_t trip_end =
      FOLD ? trip_off + sizeof(float) * triple_floats(G, D) : merge;
  const size_t pages_off = round_up((int)(ring > trip_end ? ring : trip_end),
                                    16);
  const size_t fold_off =
      round_up((int)(pages_off + sizeof(int) * (size_t)sp), 16);
  const size_t smem = FOLD ? fold_off + sizeof(float) * fold_floats(G, D)
                           : pages_off + sizeof(int) * (size_t)sp;
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  const int ns = (NP + sp - 1) / sp;
  const dim3 grid(ns, KVH, B);
  auto kernel = flash_splits_kernel<KT, QT, G, FOLD>;
  if constexpr (FOLD) {
    if (ns > MAX_SPLITS) return (int)cudaErrorInvalidValue;
    return (int)clus::launch_x(kernel, grid, THREADS, ns, smem,
                               (int)MAX_DYN_SMEM, st, info, q, q_scale, kp,
                               vp, ph, po, ks, window, io, B, KVH, D, ps, NP,
                               sp, tk, nst, pages_off, trip_off, fold_off);
  } else {
    static bool opted_in = false;   // one attribute call per instantiation
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)MAX_DYN_SMEM);
      if (err != cudaSuccess) return (int)err;
      opted_in = true;
    }
    kernel<<<grid, THREADS, smem, st>>>(q, q_scale, kp, vp, ph, po, ks,
                                        window, io, B, KVH, D, ps, NP, sp,
                                        tk, nst, pages_off, trip_off,
                                        fold_off);
    return (int)cudaGetLastError();
  }
}

bool bad_shape(int B, int KVH, int G, int D, int ps, int NP, int sp,
               int kv_dtype) {
  return B <= 0 || KVH <= 0 || G < 1 || G > MAX_G || D < 1 || D > MAX_D ||
         ps < 1 || NP < 1 || sp < 1 || kv_dtype < 0 || kv_dtype > 1 ||
         KVH > 65535 || B > 65535;
}

template <typename KT, typename QT, bool FOLD>
int launch_typed(const void* q, float q_scale, const void* k_pages,
                 const void* v_pages, const void* phys, const void* pos,
                 const void* kv_start, int window, const Dest<QT>& io, int B,
                 int KVH, int G, int D, int ps, int NP, int sp,
                 void* stream, int* info = nullptr) {
  return with_g(G, [&](auto gg) {
    return launch<KT, QT, decltype(gg)::value, FOLD>(
        static_cast<const QT*>(q), q_scale, static_cast<const KT*>(k_pages),
        static_cast<const KT*>(v_pages), static_cast<const int*>(phys),
        static_cast<const int*>(pos), static_cast<const int*>(kv_start),
        window, io, B, KVH, D, ps, NP, sp, static_cast<cudaStream_t>(stream),
        info);
  });
}

}  // namespace

// The triples form. kv_dtype: 0 f32, 1 bf16. Returns a cudaError_t.
extern "C" int flash_decode_splits_launch(
    const void* qg, const void* k_pages, const void* v_pages,
    const void* phys, const void* pos, const void* kv_start, int window,
    void* m, void* l, void* acc, int B, int KVH, int G, int D, int ps,
    int NP, int sp, int kv_dtype, void* stream) {
  if (bad_shape(B, KVH, G, D, ps, NP, sp, kv_dtype))
    return (int)cudaErrorInvalidValue;
  const Dest<float> io{static_cast<float*>(m), static_cast<float*>(l),
                       static_cast<float*>(acc), nullptr, nullptr, nullptr};
  if (kv_dtype == 0)
    return launch_typed<float, float, false>(qg, 1.f, k_pages, v_pages, phys,
                                             pos, kv_start, window, io, B,
                                             KVH, G, D, ps, NP, sp, stream);
  return launch_typed<__nv_bfloat16, float, false>(
      qg, 1.f, k_pages, v_pages, phys, pos, kv_start, window, io, B, KVH, G,
      D, ps, NP, sp, stream);
}

// The fused form: q (B, 1, KVH * G, D), k_new, v_new (B, 1, KVH, D) and
// out (B, 1, KVH * G * D) in q's type; q_scale multiplies q as it is read.
// kv_dtype, q_dtype: 0 f32, 1 bf16. More than MAX_SPLITS splits, or a
// cluster the card cannot hold, launch nothing. With info non-null: the
// launch's geometry (clus::launch_x) and no launch. Returns a
// cudaError_t.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_new, const void* v_new, const void* phys, const void* pos,
    const void* kv_start, int window, void* out, float q_scale, int B,
    int KVH, int G, int D, int ps, int NP, int sp, int kv_dtype, int q_dtype,
    void* stream, int* info) {
  if (bad_shape(B, KVH, G, D, ps, NP, sp, kv_dtype) || q_dtype < 0 ||
      q_dtype > 1 || (NP + sp - 1) / sp > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kt, auto qt) {
    using KT = decltype(kt);
    using QT = decltype(qt);
    const Dest<QT> io{nullptr, nullptr, nullptr,
                      static_cast<const QT*>(k_new),
                      static_cast<const QT*>(v_new), static_cast<QT*>(out)};
    return launch_typed<KT, QT, true>(q, q_scale, k_pages, v_pages, phys, pos,
                                      kv_start, window, io, B, KVH, G, D, ps,
                                      NP, sp, stream, info);
  };
  if (kv_dtype == 0)
    return q_dtype == 0 ? run(float{}, float{}) : run(float{}, __nv_bfloat16{});
  return q_dtype == 0 ? run(__nv_bfloat16{}, float{})
                      : run(__nv_bfloat16{}, __nv_bfloat16{});
}
