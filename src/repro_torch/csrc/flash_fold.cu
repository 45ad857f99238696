// Split reduction and self-term fold of paged flash decode, for Hopper
// (sm_90a): the step after kernel B2 (flash_decode.cu) or B5
// (flash_decode_kvq.cu).
//
// Replaces: the XLA tail of src/repro/kernels/flash_decode.py::
// flash_decode_paged (lines 501 and 516-527: the split reduction and the
// self-term fold that follows it), which XLA fuses on the TPU; it has no
// Pallas kernel. Its plain version, kernels/flash_decode.py::fold_splits,
// is ~25 small torch ops.
//
// Per (slot b, kv head h) and each of the G query heads g of the group:
//   M = max_s m[s],  L = sum_s l[s] w_s,  A = sum_s acc[s] w_s,
//     w_s = exp(m[s] - M), summed in split order
//   s_new = qg . k_new,  m_f = max(M, s_new),  alpha = exp(M - m_f),
//   p_new = exp(s_new - m_f),  out = (A alpha + p_new v_new)
//                                    / (L alpha + p_new)
//
//   m, l (NS, B, KVH, G) f32; acc (NS, B, KVH, G, D) f32: the triples
//   qg (B, KVH, G, D) f32, pre-scaled by D^-0.5 (B2's and B5's input)
//   k_new, v_new (B, 1, KVH, D) f32|bf16: the fresh token's rows
//   out (B, 1, KVH * G * D) f32|bf16 (q's type)
//
// The new token is always live, so the denominator is at least exp(0):
// never zero. A lane whose splits are all the identity (-1e30, 0, 0), as
// for pos = -1, gets alpha = exp(-1e30 - s_new) = 0 and p_new = 1, so its
// output is exactly its v_new row.
//
// What bounds it on the H100: bytes, ~0.7 MB of triples at the main path
// (8 splits x 8 slots x 20 heads x 130 floats), ~0.2 us at 3.35 TB/s; the
// arithmetic is a few exps per output. In practice the launch bounds it.
//
// Design: one block per (slot, kv head), one thread per column d of D
// (rounded up to whole warps; D <= 256). Its time is latency: a launch
// and a chain of dependent loads. So every load of the block is issued
// before anything waits: each thread first loads, for each of the G
// heads, eight splits' m, l (the same address across the block: a
// broadcast) and its column of acc (one coalesced row a split) at once,
// and merges them into a running (max, sum, sum) in split order; more
// splits take further rounds of eight. Only then do the G self scores
// qg[g] . k_new meet over D (a warp shuffle tree, then the warps'
// partial sums in warp order through shared memory), and the fold
// follows in registers. Every sum runs in a fixed order, so the result
// does not depend on scheduling. expf is the accurate one (no
// fast-math), so exp(0) is exactly 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_G = 8;
constexpr int MAX_D = 256;
constexpr int MAX_WARPS = MAX_D / 32;
constexpr int CH = 8;                  // splits whose loads go at once
constexpr float NEG_INF = -1e30f;      // the identity's m

__device__ __forceinline__ float to_f(float a) { return a; }
__device__ __forceinline__ float to_f(__nv_bfloat16 a) {
  return __bfloat162float(a);
}
__device__ __forceinline__ void store(float* p, float a) { *p = a; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

template <typename KT, typename OT>
__global__ void __launch_bounds__(MAX_D)
flash_fold_kernel(const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ acc,
                  const float* __restrict__ qg,
                  const KT* __restrict__ k_new, const KT* __restrict__ v_new,
                  OT* __restrict__ out, int ns, int bkvh, int G, int D) {
  __shared__ float part[MAX_G][MAX_WARPS];
  __shared__ float s_new[MAX_G];
  const int bh = blockIdx.x;             // b * KVH + h
  const int d = threadIdx.x;
  const int warp = d / 32, lane = d % 32, warps = blockDim.x / 32;
  const bool live = d < D;
  const size_t step = (size_t)bkvh * G;  // one split of m and l
  const float kd = live ? to_f(k_new[(size_t)bh * D + d]) : 0.f;
  const float vd = live ? to_f(v_new[(size_t)bh * D + d]) : 0.f;

  // split reduction, before the first barrier so that every load of the
  // block is in flight at once: per head a running (mx, ls, as), merged
  // with CH splits at a time in split order. It starts at the identity,
  // so for ns <= CH it is exactly max, then sum of w_s-weighted terms.
  float mx[MAX_G], ls[MAX_G], as[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    mx[g] = NEG_INF;
    ls[g] = 0.f;
    as[g] = 0.f;
  }
  for (int s0 = 0; s0 < ns; s0 += CH) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const size_t t = (size_t)bh * G + g;
        float mv[CH], lv[CH], av[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) {    // padding: the identity
          const size_t i = (size_t)(s0 + j) * step + t;
          const bool ok = s0 + j < ns;
          mv[j] = ok ? m[i] : NEG_INF;
          lv[j] = ok ? l[i] : 0.f;
          av[j] = ok && live ? acc[i * D + d] : 0.f;
        }
        float mc = mx[g];
#pragma unroll
        for (int j = 0; j < CH; ++j) mc = fmaxf(mc, mv[j]);
        const float w0 = expf(mx[g] - mc);
        float lsum = ls[g] * w0, asum = as[g] * w0;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const float w = expf(mv[j] - mc);
          lsum += lv[j] * w;
          asum += av[j] * w;
        }
        mx[g] = mc;
        ls[g] = lsum;
        as[g] = asum;
      }
    }
  }

  // self scores: s_new[g] = qg[b, h, g, :] . k_new[b, 0, h, :]
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      float p = live ? qg[((size_t)bh * G + g) * D + d] * kd : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) part[g][warp] = p;
    }
  }
  __syncthreads();
  if (d < G) {
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) sum += part[d][w];
    s_new[d] = sum;
  }
  __syncthreads();
  if (!live) return;

#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      const float sn = s_new[g];
      const float mf = fmaxf(mx[g], sn);
      const float alpha = expf(mx[g] - mf);
      const float pn = expf(sn - mf);
      const float denom = ls[g] * alpha + pn;
      store(out + ((size_t)bh * G + g) * D + d,
            (as[g] * alpha + pn * vd) / denom);
    }
  }
}

template <typename KT, typename OT>
cudaError_t launch_typed(const float* m, const float* l, const float* acc,
                         const float* qg, const void* k_new,
                         const void* v_new, void* out, int ns, int bkvh,
                         int G, int D, cudaStream_t st) {
  const int threads = (D + 31) / 32 * 32;
  flash_fold_kernel<KT, OT><<<bkvh, threads, 0, st>>>(
      m, l, acc, qg, static_cast<const KT*>(k_new),
      static_cast<const KT*>(v_new), static_cast<OT*>(out), ns, bkvh, G, D);
  return cudaGetLastError();
}

}  // namespace

// kv_dtype (k_new, v_new) and out_dtype: 0 f32, 1 bf16. ns splits,
// B * KVH blocks, G <= 8 heads a group, D <= 256. Returns a cudaError_t.
extern "C" int flash_fold_launch(const void* m, const void* l,
                                 const void* acc, const void* qg,
                                 const void* k_new, const void* v_new,
                                 void* out, int ns, int B, int KVH, int G,
                                 int D, int kv_dtype, int out_dtype,
                                 void* stream) {
  if (ns < 1 || B < 1 || KVH < 1 || G < 1 || G > MAX_G || D < 1 ||
      D > MAX_D || kv_dtype < 0 || kv_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const float* ap = static_cast<const float*>(acc);
  const float* qp = static_cast<const float*>(qg);
  const int bkvh = B * KVH;
  cudaError_t err;
  if (kv_dtype == 0 && out_dtype == 0)
    err = launch_typed<float, float>(mp, lp, ap, qp, k_new, v_new, out, ns,
                                     bkvh, G, D, st);
  else if (kv_dtype == 0)
    err = launch_typed<float, __nv_bfloat16>(mp, lp, ap, qp, k_new, v_new,
                                             out, ns, bkvh, G, D, st);
  else if (out_dtype == 0)
    err = launch_typed<__nv_bfloat16, float>(mp, lp, ap, qp, k_new, v_new,
                                             out, ns, bkvh, G, D, st);
  else
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        mp, lp, ap, qp, k_new, v_new, out, ns, bkvh, G, D, st);
  return (int)err;
}
