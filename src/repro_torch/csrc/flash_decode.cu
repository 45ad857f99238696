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
// identity of the split reduction that follows in plain PyTorch.
//
//   qg (B, KVH, G, D) f32, already scaled by D^-0.5
//   k_pages, v_pages (P+1, page, KVH, D) f32|bf16 (one layer of the pool;
//     the last page is the trash page)
//   phys (B, NP) int32 physical page ids, trash-redirected
//   pos, kv_start (B,) int32; window (scalar)
//   out m, l (NS, B, KVH, G) f32; acc (NS, B, KVH, G, D) f32
//
// What bounds it on the H100: bytes. Each live K and V row is read once
// (2 * D * 2 bytes in bf16) for 4 * D * G flops: ~G flops per byte, far
// below the ~20 flops/byte at which fp32 CUDA-core arithmetic would bind.
//
// Design:
//  * One block (128 threads, 4 warps) per (split, kv head, slot). The
//    block reads its own page ids from phys; the TPU's scalar prefetch has
//    no counterpart. The TPU carries (m, l, acc) in VMEM output blocks
//    across a page grid axis; here a loop over the split's pages carries
//    m and l in shared memory and acc in registers (each thread owns
//    D / 128 columns for all G heads).
//  * Pages with no live key are skipped without a read, so masked lanes
//    (pos = -1), trash pages and unallocated pages cost nothing; the mask
//    is a contiguous key range, so inside a page only live keys are read.
//  * Each page's live K and V rows are staged in shared memory first,
//    with 8 loads in flight per thread, so a page costs one memory round
//    trip, not one per key. Scores: warp w scores keys w, w+4, ... from
//    shared memory; a warp shuffle sums each dot product.
//  * Probabilities are exp(s - m_new) on live keys only, so a masked key
//    contributes 0 by the mask, never through exp(-inf). K and V are read
//    in their storage type; all arithmetic is fp32 (expf, not __expf).
//  * GQA: the G query heads sharing a kv head share each K/V row load.
//  * The split loop (flash_split) lives in flash_common.cuh, shared with
//    B5 (flash_decode_kvq.cu); this file supplies how a page's rows reach
//    shared memory (FpPages).

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace {

using namespace flashc;

__device__ __forceinline__ float to_f(float a) { return a; }
__device__ __forceinline__ float to_f(__nv_bfloat16 a) { return __bfloat162float(a); }

// Pages of fp K/V rows (P+1, page, KVH, D): a page's live rows are copied
// to shared memory, LD loads in flight per thread before any is used, so
// a page costs one memory round trip per LD * THREADS elements.
template <typename KT>
struct FpPages {
  const KT* kp;
  const KT* vp;
  int KVH, D, ps, h;

  __device__ __forceinline__ void stage(size_t page, int tlo, int thi,
                                        float* k_s, float* v_s) const {
    const size_t row_stride = (size_t)KVH * D;   // one token of one page
    const KT* kbase = kp + page * ps * row_stride + (size_t)h * D;
    const KT* vbase = vp + page * ps * row_stride + (size_t)h * D;
    const int n_el = (thi - tlo) * D;
    for (int base = threadIdx.x; base < n_el; base += THREADS * LD) {
      float kr[LD], vr[LD];
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int i = base + u * THREADS;
        if (i < n_el) {
          const size_t off = (size_t)(tlo + i / D) * row_stride + i % D;
          kr[u] = to_f(kbase[off]);
          vr[u] = to_f(vbase[off]);
        }
      }
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int i = base + u * THREADS;
        if (i < n_el) {
          k_s[tlo * D + i] = kr[u];
          v_s[tlo * D + i] = vr[u];
        }
      }
    }
  }
};

template <typename KT>
__global__ void __launch_bounds__(THREADS)
flash_splits_kernel(const float* __restrict__ qg, const KT* __restrict__ kp,
                    const KT* __restrict__ vp, const int* __restrict__ phys,
                    const int* __restrict__ pos, const int* __restrict__ kvs,
                    int window, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ acc_out,
                    int B, int KVH, int G, int D, int ps, int NP, int sp) {
  extern __shared__ float smem[];
  const FpPages<KT> pages{kp, vp, KVH, D, ps, (int)blockIdx.y};
  flash_split(pages, qg, phys, pos, kvs, window, m_out, l_out, acc_out, B,
              KVH, G, D, ps, NP, sp, smem);
}

}  // namespace

// kv_dtype: 0 f32, 1 bf16. Returns a cudaError_t.
extern "C" int flash_decode_splits_launch(
    const void* qg, const void* k_pages, const void* v_pages,
    const void* phys, const void* pos, const void* kv_start, int window,
    void* m, void* l, void* acc, int B, int KVH, int G, int D, int ps,
    int NP, int sp, int kv_dtype, void* stream) {
  if (B <= 0 || KVH <= 0 || G < 1 || G > MAX_G || D < 1 || D > MAX_D ||
      ps < 1 || NP < 1 || sp < 1 || kv_dtype < 0 || kv_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int ns = (NP + sp - 1) / sp;
  if (KVH > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(ns, KVH, B);
  const size_t smem = sizeof(float) * split_floats(G, D, ps);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qg);
  const int* ph = static_cast<const int*>(phys);
  const int* po = static_cast<const int*>(pos);
  const int* ks = static_cast<const int*>(kv_start);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  float* ao = static_cast<float*>(acc);
  if (kv_dtype == 0)
    flash_splits_kernel<float><<<grid, THREADS, smem, st>>>(
        q, static_cast<const float*>(k_pages), static_cast<const float*>(v_pages),
        ph, po, ks, window, mo, lo, ao, B, KVH, G, D, ps, NP, sp);
  else
    flash_splits_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        q, static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages),
        ph, po, ks, window, mo, lo, ao, B, KVH, G, D, ps, NP, sp);
  return (int)cudaGetLastError();
}
