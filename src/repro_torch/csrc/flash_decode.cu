// Kernel B2: paged split-KV flash decode (single query token per slot)
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py::_splits_pallas (body
// _flash_kernel), the TPU kernel behind every paged decode attention.
//
// Per (slot b, kv head h, split s) it computes the softmax triple over the
// keys of the split's pages, for each of the G query heads of the group:
//   m = max_j s_j,  l = sum_j exp(s_j - m),  acc = sum_j exp(s_j - m) v_j
// over live keys j: kv_start <= j < pos (and j > pos - window when
// window > 0). An all-masked split gives exactly (-1e30, 0, 0), the
// identity of the split reduction that follows (the fold kernel,
// flash_fold.cu).
//
//   qg (B, KVH, G, D) f32, already scaled by D^-0.5
//   k_pages, v_pages (P+1, page, KVH, D) f32|bf16 (one layer of the pool;
//     the last page is the trash page)
//   phys (B, NP) int32 physical page ids, trash-redirected
//   pos, kv_start (B,) int32; window (scalar)
//   out m, l (NS, B, KVH, G) f32; acc (NS, B, KVH, G, D) f32
//
// Its roofline bound on the H100 is bytes: each live K and V row is read
// once (2 * D * 2 bytes in bf16) for 4 * D * G flops, ~G flops per byte,
// far below the ~20 flops/byte at which fp32 CUDA-core arithmetic would
// bind. At decode lengths it runs well above that bound, held back by
// latency: a launch's fixed cost and each block's chain of dependent
// steps (page ids, first tile, scores, merge, write), which only many
// blocks in flight hide.
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

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace {

using namespace flashc;

template <typename KT, int G>
__global__ void __launch_bounds__(THREADS)
flash_splits_kernel(const float* __restrict__ qg, const KT* __restrict__ kp,
                    const KT* __restrict__ vp, const int* __restrict__ phys,
                    const int* __restrict__ pos, const int* __restrict__ kvs,
                    int window, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ acc_out,
                    int B, int KVH, int D, int ps, int NP, int sp, int tk,
                    int nst, size_t pages_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t o = (((size_t)s * B + b) * KVH + h) * G;
  const SplitPages pg = fetch_pages(phys, b, NP, s, sp);
  const Range r = split_range(pos, kvs, window, b, s, sp, ps, NP);
  if (r.lo >= r.hi) {
    write_identity(m_out, l_out, acc_out, o, G, D);
    return;
  }
  const RowGeom geom(D, sizeof(KT));
  const int rb = geom.row_bytes();
  const size_t stage_bytes = 2 * (size_t)tk * rb;   // K rows, then V rows
  int* pages_s = reinterpret_cast<int*>(smem + pages_off);
  store_pages(pg, phys, b, NP, pages_s);
  const int first = pg.first;
  const size_t tok_bytes = (size_t)KVH * D * sizeof(KT);
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(kp + (size_t)h * D);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(vp + (size_t)h * D);
  RowGroup<KT, G> grp;
  grp.init(qg + ((size_t)b * KVH + h) * G * D, D, geom);
  __syncthreads();                                  // pages_s

  const int ntiles = (r.hi - r.lo + tk - 1) / tk;
  auto load_tile = [&](int i) {
    const int t0 = r.lo + i * tk;
    unsigned char* st = smem + (size_t)(i % nst) * stage_bytes;
    load_rows(kb, vb, tok_bytes, ps, pages_s, first, t0, min(tk, r.hi - t0),
              D * (int)sizeof(KT), st, st + (size_t)tk * rb, rb);
  };
  for (int i = 0; i < nst; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait(nst - 1);                         // tile i has landed
    __syncthreads();
    const unsigned char* st = smem + (size_t)(i % nst) * stage_bytes;
    grp.tile(st, st + (size_t)tk * rb, min(tk, r.hi - r.lo - i * tk), geom);
    __syncthreads();                                // its stage is free
    if (i + nst < ntiles) load_tile(i + nst);
    cp_async_commit();
  }
  grp.finish(reinterpret_cast<float*>(smem), geom, m_out, l_out, acc_out, o,
             D);
}

// Tokens per tile: the most (a power of two, 8 to 64) whose ring of
// STAGES tiles of K and V rows fits 48 KB.
int tile_tokens(int row_bytes) {
  int tk = 64;
  while (tk > 8 && (size_t)STAGES * 2 * tk * row_bytes > 48 * 1024) tk /= 2;
  return tk;
}

template <typename KT, int G>
int launch(const void* qg, const void* kp, const void* vp, const int* ph,
           const int* po, const int* ks, int window, float* mo, float* lo,
           float* ao, int B, int KVH, int D, int ps, int NP, int sp,
           cudaStream_t st) {
  const RowGeom geom(D, sizeof(KT));
  const int tk = tile_tokens(geom.row_bytes());
  // stages: no more than the tiles a split can hold
  const int nst = min(STAGES, (int)(((size_t)sp * ps + tk - 1) / tk));
  const size_t ring = (size_t)nst * 2 * tk * geom.row_bytes();
  const size_t merge = sizeof(float) * geom.merge_floats(G, D);
  const size_t pages_off = round_up((int)(ring > merge ? ring : merge), 16);
  const size_t smem = pages_off + sizeof(int) * (size_t)sp;
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;     // one attribute call per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_splits_kernel<KT, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_DYN_SMEM);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((NP + sp - 1) / sp, KVH, B);
  flash_splits_kernel<KT, G><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(qg), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), ph, po, ks, window, mo, lo, ao, B, KVH, D,
      ps, NP, sp, tk, nst, pages_off);
  return (int)cudaGetLastError();
}

}  // namespace

// kv_dtype: 0 f32, 1 bf16. Returns a cudaError_t.
extern "C" int flash_decode_splits_launch(
    const void* qg, const void* k_pages, const void* v_pages,
    const void* phys, const void* pos, const void* kv_start, int window,
    void* m, void* l, void* acc, int B, int KVH, int G, int D, int ps,
    int NP, int sp, int kv_dtype, void* stream) {
  if (B <= 0 || KVH <= 0 || G < 1 || G > MAX_G || D < 1 || D > MAX_D ||
      ps < 1 || NP < 1 || sp < 1 || kv_dtype < 0 || kv_dtype > 1 ||
      KVH > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ph = static_cast<const int*>(phys);
  const int* po = static_cast<const int*>(pos);
  const int* ks = static_cast<const int*>(kv_start);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  float* ao = static_cast<float*>(acc);
#define B2_F32(GG)                                                          \
  return launch<float, GG>(qg, k_pages, v_pages, ph, po, ks, window, mo, lo, \
                           ao, B, KVH, D, ps, NP, sp, st)
#define B2_BF16(GG)                                                          \
  return launch<__nv_bfloat16, GG>(qg, k_pages, v_pages, ph, po, ks, window, \
                                   mo, lo, ao, B, KVH, D, ps, NP, sp, st)
  if (kv_dtype == 0) {
    FLASHC_DISPATCH_G(G, B2_F32)
  } else {
    FLASHC_DISPATCH_G(G, B2_BF16)
  }
#undef B2_F32
#undef B2_BF16
  return (int)cudaErrorInvalidValue;                // not reached
}
