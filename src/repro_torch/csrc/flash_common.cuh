// Device code shared by the paged flash-decode kernels: B2
// (flash_decode.cu, pages of fp K/V rows) and B5 (flash_decode_kvq.cu,
// pages of uint8 centroid codes).
//
// flash_split computes, per (split s, kv head h, slot b) = one block of
// THREADS threads, the softmax triple over the keys of the split's pages,
// for each of the G query heads of the group:
//   m = max_j s_j,  l = sum_j exp(s_j - m),  acc = sum_j exp(s_j - m) v_j
// over live keys j: kv_start <= j < pos (and j > pos - window when
// window > 0). An all-masked split gives exactly (-1e30, 0, 0), the
// identity of the split reduction that follows in plain PyTorch.
//
// The two kernels differ only in how a page's live K and V rows reach
// shared memory: a Pages policy's stage(page, tlo, thi, k_s, v_s) writes
// rows tlo .. thi-1 of one physical page, head h, as fp32 rows of D.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flashc {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;
constexpr int MAX_D = 256;
constexpr int DT = MAX_D / THREADS;    // columns of acc per thread
constexpr int LD = 8;                  // loads in flight per thread
constexpr float NEG_INF = -1e30f;

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

// Floats of shared memory flash_split uses: q (G x D), the page's K and V
// rows (ps x D each), scores (G x ps), then m, l and alpha (G each).
__host__ __device__ inline size_t split_floats(int G, int D, int ps) {
  return (size_t)G * D + 2 * (size_t)ps * D + (size_t)G * ps + 3 * (size_t)G;
}

//   qg (B, KVH, G, D) f32, already scaled by D^-0.5
//   phys (B, NP) int32 physical page ids, trash-redirected
//   pos, kv_start (B,) int32; window (scalar)
//   out m, l (NS, B, KVH, G) f32; acc (NS, B, KVH, G, D) f32
// The block is (s, h, b) = (blockIdx.x, blockIdx.y, blockIdx.z). smem
// holds split_floats(G, D, ps) floats. Anything the caller wrote to
// shared memory before the call is visible after its first barrier.
template <class Pages>
__device__ __forceinline__ void flash_split(
    const Pages& pages, const float* __restrict__ qg,
    const int* __restrict__ phys, const int* __restrict__ pos,
    const int* __restrict__ kvs, int window, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, int B, int KVH,
    int G, int D, int ps, int NP, int sp, float* smem) {
  float* q_s = smem;                   // [G][D]
  float* k_s = q_s + G * D;            // [ps][D] live K rows of the page
  float* v_s = k_s + ps * D;           // [ps][D] live V rows of the page
  float* p_s = v_s + ps * D;           // [G][ps] scores, then probabilities
  float* m_s = p_s + G * ps;           // [G]
  float* l_s = m_s + G;                // [G]
  float* alpha_s = l_s + G;            // [G]

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < G * D; i += THREADS)
    q_s[i] = qg[((size_t)b * KVH + h) * G * D + i];
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float a[MAX_G][DT];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int i = 0; i < DT; ++i) a[g][i] = 0.f;

  // live keys form the range [lo, hi)
  const int hi = pos[b];
  int lo = kvs[b];
  if (window > 0 && hi - window + 1 > lo) lo = hi - window + 1;
  __syncthreads();

  for (int ip = 0; ip < sp; ++ip) {
    const int lp = s * sp + ip;                  // logical page
    if (lp >= NP) break;
    const int t0 = lp * ps;
    const int tlo = max(lo - t0, 0), thi = min(hi - t0, ps);
    if (tlo >= thi) continue;                    // no live key: no read
    pages.stage((size_t)phys[(size_t)b * NP + lp], tlo, thi, k_s, v_s);
    __syncthreads();

    // scores of the live keys: warp w scores keys w, w+4, ...
    for (int t = tlo + warp; t < thi; t += WARPS) {
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        for (int d = lane; d < D; d += 32) part += q_s[g * D + d] * k_s[t * D + d];
        part = warp_sum(part);
        if (lane == 0) p_s[g * ps + t] = part;
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int t = tlo + lane; t < thi; t += 32) mx = fmaxf(mx, p_s[g * ps + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = tlo + lane; t < thi; t += 32) {
        const float p = expf(p_s[g * ps + t] - m_new);
        p_s[g * ps + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + sum_t p_t v_t
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int d = tid + THREADS * i;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) a[g][i] *= alpha_s[g];
        for (int t = tlo; t < thi; ++t) {
          const float vv = v_s[t * D + d];
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) a[g][i] += p_s[g * ps + t] * vv;
        }
      }
    }
    __syncthreads();                             // smem is reused next page
  }

  const size_t o = (((size_t)s * B + b) * KVH + h) * G;
  for (int g = tid; g < G; g += THREADS) {
    m_out[o + g] = m_s[g];
    l_out[o + g] = l_s[g];
  }
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = tid + THREADS * i;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc_out[(o + g) * D + d] = a[g][i];
    }
  }
}

}  // namespace flashc
