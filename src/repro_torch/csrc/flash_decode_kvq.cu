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
// What bounds it on the H100: bytes. Each live token costs 2 * nc code
// bytes per kv head (64 at the main shape, nc = 32) instead of B2's
// 2 * D * 2 = 512 in bf16, an 8x cut of the pool traffic; the tables are
// 2 * nc * c * v * 4 bytes per layer (16 KB) and the dequant is one
// shared-memory lookup and one multiply per element.
//
// Design:
//  * Dequantize into shared memory, then run B2's own score / softmax /
//    value loop on the fp rows (flash_split). The TPU kernel does the
//    same (_deq_tile, a one-hot matmul on the MXU); the alternative, a
//    per-query score table q_s . z_s and probability mass pooled per
//    (subspace, centroid) as _flash_xla_kvq does, saves arithmetic only
//    when a split holds many more tokens than there are centroids, and
//    needs its own softmax path. Dequantizing keeps one verified loop for
//    both pool types and takes every (nc, c, v) the codebook allows. fp
//    K/V rows never reach device memory: they live in shared memory for
//    one page.
//  * The block stages its layer's zk and zv tables in shared memory once
//    (coalesced), then reads each page's live codes (LD in flight per
//    thread, one byte per subspace, neighbouring threads on neighbouring
//    bytes) and writes z[s, code] * scale into the page's K and V rows. A
//    split with no live key (pos = -1 lanes, splits past the sequence)
//    stages nothing and reads nothing, and emits exactly (-1e30, 0, 0).
//  * Tables above 48 KB (the exact-cover codebook: nc = 1, v = D, c up to
//    256 is 128 KB a table at D = 128) opt into dynamic shared memory up
//    to 227 KB; when both tables and B2's buffers do not fit even then,
//    the block reads the tables from device memory (through L1 and L2)
//    instead of staging them. No shape is refused.
//  * Everything else (masks, skipped pages, GQA, fp32 arithmetic) is B2's.

#include "flash_common.cuh"

namespace {

using namespace flashc;

constexpr size_t MAX_DYN_SMEM = 227 * 1024;

// Pages of uint8 codes (P+1, page, KVH, nc); z tables in shared memory
// (staged) or in device memory.
struct CodePages {
  const uint8_t* kc;
  const uint8_t* vc;
  const float* zk;
  const float* zv;
  float sk, sv;
  int KVH, nc, c, v, D, ps, h;

  __device__ __forceinline__ void stage(size_t page, int tlo, int thi,
                                        float* k_s, float* v_s) const {
    const size_t row_stride = (size_t)KVH * nc;  // one token of one page
    const uint8_t* kbase = kc + page * ps * row_stride + (size_t)h * nc;
    const uint8_t* vbase = vc + page * ps * row_stride + (size_t)h * nc;
    const int n_el = (thi - tlo) * D;
    const int cv = c * v;
    for (int base = threadIdx.x; base < n_el; base += THREADS * LD) {
      int kcode[LD], vcode[LD], zoff[LD];
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int i = base + u * THREADS;
        if (i < n_el) {
          const int d = i % D, sub = d / v;
          const size_t off = (size_t)(tlo + i / D) * row_stride + sub;
          kcode[u] = kbase[off];
          vcode[u] = vbase[off];
          zoff[u] = sub * cv + (d - sub * v);
        }
      }
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int i = base + u * THREADS;
        if (i < n_el) {
          k_s[tlo * D + i] = zk[zoff[u] + kcode[u] * v] * sk;
          v_s[tlo * D + i] = zv[zoff[u] + vcode[u] * v] * sv;
        }
      }
    }
  }
};

__global__ void __launch_bounds__(THREADS)
flash_splits_kvq_kernel(
    const float* __restrict__ qg, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ vc, const float* __restrict__ zk,
    const float* __restrict__ zv, const float* __restrict__ sk,
    const float* __restrict__ sv, const int* __restrict__ phys,
    const int* __restrict__ pos, const int* __restrict__ kvs, int window,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, int B, int KVH, int G, int D, int ps,
    int NP, int sp, int nc, int c, int v, int staged) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  // does the split hold a live key? (the same range flash_split masks)
  const int hi = pos[b];
  int lo = kvs[b];
  if (window > 0 && hi - window + 1 > lo) lo = hi - window + 1;
  const int t_first = s * sp * ps;
  const int t_end = min(NP, (s + 1) * sp) * ps;
  const bool live = max(lo, t_first) < min(hi, t_end);
  const float* zk_t = zk;
  const float* zv_t = zv;
  if (staged && live) {
    const int n = nc * c * v;
    float* zks = smem + split_floats(G, D, ps);
    float* zvs = zks + n;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      zks[i] = zk[i];
      zvs[i] = zv[i];
    }
    zk_t = zks;                 // published by flash_split's first barrier
    zv_t = zvs;
  }
  const CodePages pages{kc, vc, zk_t, zv_t, sk[h], sv[h], KVH, nc, c, v,
                        D, ps, h};
  flash_split(pages, qg, phys, pos, kvs, window, m_out, l_out, acc_out, B,
              KVH, G, D, ps, NP, sp, smem);
}

}  // namespace

// kc, vc uint8 code pools; zk, zv (nc, c, v) f32; sk, sv (KVH,) f32.
// Returns a cudaError_t.
extern "C" int flash_decode_splits_kvq_launch(
    const void* qg, const void* kc, const void* vc, const void* zk,
    const void* zv, const void* sk, const void* sv, const void* phys,
    const void* pos, const void* kv_start, int window, void* m, void* l,
    void* acc, int B, int KVH, int G, int D, int ps, int NP, int sp,
    int nc, int c, int v, void* stream) {
  if (B <= 0 || KVH <= 0 || G < 1 || G > MAX_G || D < 1 || D > MAX_D ||
      ps < 1 || NP < 1 || sp < 1 || nc < 1 || v < 1 || nc * v != D ||
      c < 1 || c > 256 || KVH > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t base = sizeof(float) * split_floats(G, D, ps);
  const size_t tables = 2 * sizeof(float) * (size_t)nc * c * v;
  const int staged = base + tables <= MAX_DYN_SMEM;
  const size_t smem = staged ? base + tables : base;
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_splits_kvq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((NP + sp - 1) / sp, KVH, B);
  flash_splits_kvq_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qg), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(vc), static_cast<const float*>(zk),
      static_cast<const float*>(zv), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(phys),
      static_cast<const int*>(pos), static_cast<const int*>(kv_start),
      window, static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), B, KVH, G, D, ps, NP, sp, nc, c, v, staged);
  return (int)cudaGetLastError();
}
