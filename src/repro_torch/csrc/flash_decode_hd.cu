// Kernels B2s and B2a: paged single-token decode attention split by
// head_dim (the head_dim layout of tensor parallelism), for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py::_splits_pallas (B2) where
// the reference's pool is sharded on head_dim: its kv heads do not divide
// the model axis, so each rank holds every kv head's head_dim slice of
// the pages (src/repro/parallel/sharding.py::_kv_model_axes), and a
// rank's keys give only partial dot products. The decode then runs in
// three steps, the middle one outside any kernel:
//   B2s  partial scores: for each (slot b, q head h, key j) the dot
//        product of the rank's q slice with key row j's slice, over the
//        slot's live keys, read through the trash-redirected page table;
//        dead and trash pages and keys outside the live range give 0
//        without a load; the last column is the new token's self term
//        (from k_new). Out: sc (B, H, T + 1) f32, T = NP * page.
//   an all-reduce of sc over the model axis, in rank order;
//   B2a  attend: s = sc * scale (hd^-0.5 of the whole head_dim), the masks
//        (kv_start <= j < pos, j > pos - window when window > 0; the self
//        column always live), one f32 softmax (max, sum of exp, each
//        probability divided by the sum and rounded to the output's
//        type), then the probabilities times the rank's V slice over the
//        same keys plus v_new, summed in f32. Out: (B, 1, H, D) in q's
//        type. A pos = -1 lane has no live key: its output is exactly its
//        v_new slice (probability 1).
// This is the arithmetic of the port's dense head_dim decode
// (models/layers.py::_sdpa_decode with tp): the scale after the
// all-reduce, probabilities in the activations' type, f32 sums.
//
//   q (B, 1, KVH * G, D) f32|bf16 (the rank's head_dim slice, unscaled)
//   k_pages, v_pages (P+1, page, KVH, D) f32|bf16 (one layer of the
//     rank's pool; the last page is the trash page); k_new, v_new (B, 1,
//     KVH, D) in the pool's type
//   phys (B, NP) int32 physical page ids, trash-redirected
//   pos, kv_start (B,) int32; window (scalar)
//
// Bound on the H100: bytes. B2s reads each live key row slice once (D
// elements) and does 2 * G * D flops on it; B2a reads each live value row
// slice once and the scores, 2 * G * D flops a row. At D = 16 (qwen1.5-4b
// over 8 ranks) a row slice is 32 bytes of bf16: the work is latency and
// launch bound, far from either peak.
//
// Design (simple first; wgmma and TMA are later work):
//  * B2s: one block of 128 threads a (page of the table, slot), plus one
//    block a slot for the self column. The slot's q slice (H * D floats)
//    sits in shared memory; a thread takes (head, key) pairs, key
//    fastest, so the score writes coalesce; each pair reads its key
//    row's D elements of its kv head (the G heads of a group hit the same
//    row in L1). Element loads: any pool offset and alignment works.
//  * B2a: one block a (q head, slot). Max and sum over the live keys are
//    block reductions (warp shuffles, then the warps in order). The value
//    sum goes a tile of TILE keys at a time: each key's probability and
//    its V row's offset (through the page table) once into shared
//    memory, then threads mapped to (dim, key group), dims fastest so the
//    V loads of a warp coalesce, each summing its keys of the tile in
//    order; the key groups are added in order and the self term last:
//    the same sums on every launch.

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace {

using namespace flashc;

template <typename T>
__device__ __forceinline__ float rounded(float x);
template <>
__device__ __forceinline__ float rounded<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The slot's live keys [lo, hi): kv_start <= j < pos, within the window.
struct Live {
  int lo, hi;
};
__device__ __forceinline__ Live live_keys(const int* pos, const int* kvs,
                                          int window, int b, int T) {
  const int p = pos[b];
  int lo = kvs[b];
  if (window > 0 && p - window + 1 > lo) lo = p - window + 1;
  return {lo, min(p, T)};
}

template <typename QT>
__device__ __forceinline__ void load_q(const QT* q, float* q_s, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) q_s[i] = to_f(q[i]);
  __syncthreads();
}

template <typename KT, typename QT>
__global__ void __launch_bounds__(THREADS)
hd_scores_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                 const KT* __restrict__ k_new, const int* __restrict__ phys,
                 const int* __restrict__ pos, const int* __restrict__ kvs,
                 int window, float* __restrict__ sc, int KVH, int G, int D,
                 int ps, int NP) {
  extern __shared__ float q_s[];                  // (H, D) of slot b
  const int pg = blockIdx.x, b = blockIdx.y;
  const int H = KVH * G, T = NP * ps;
  const size_t row = (size_t)T + 1;
  float* out = sc + (size_t)b * H * row;
  const QT* qb = q + (size_t)b * H * D;
  if (pg == NP) {                                 // the self column
    load_q(qb, q_s, H * D);
    for (int h = threadIdx.x; h < H; h += THREADS) {
      const KT* k = k_new + ((size_t)b * KVH + h / G) * D;
      const float* qh = q_s + (size_t)h * D;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qh[d], to_f(k[d]), acc);
      out[(size_t)h * row + T] = acc;
    }
    return;
  }
  const Live lv = live_keys(pos, kvs, window, b, T);
  const int t0 = pg * ps;
  const int a = max(lv.lo, t0), e = min(lv.hi, t0 + ps);
  if (a >= e) {          // a dead or trash page, or a pos = -1 lane
    for (int i = threadIdx.x; i < H * ps; i += THREADS)
      out[(size_t)(i / ps) * row + t0 + i % ps] = 0.f;
    return;
  }
  load_q(qb, q_s, H * D);
  const int page = phys[(size_t)b * NP + pg];
  const KT* base = kp + (size_t)page * ps * KVH * D;
  for (int i = threadIdx.x; i < H * ps; i += THREADS) {
    const int h = i / ps, t = t0 + i % ps;
    float acc = 0.f;
    if (t >= a && t < e) {
      const KT* k = base + ((size_t)(t - t0) * KVH + h / G) * D;
      const float* qh = q_s + (size_t)h * D;
      for (int d = 0; d < D; ++d) acc = fmaf(qh[d], to_f(k[d]), acc);
    }
    out[(size_t)h * row + t] = acc;
  }
}

// A block-wide max / sum of one value a thread: warp shuffles, then the
// warps' results in warp order (red: WARPS floats of shared memory).
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Keys whose probabilities (and V row offsets) one block keeps in shared
// memory at a time in B2a's value sum.
constexpr int TILE = 1024;

template <typename KT, typename QT>
__global__ void __launch_bounds__(THREADS)
hd_attend_kernel(const float* __restrict__ sc, const KT* __restrict__ vp,
                 const KT* __restrict__ v_new, const int* __restrict__ phys,
                 const int* __restrict__ pos, const int* __restrict__ kvs,
                 int window, float scale, QT* __restrict__ out, int KVH,
                 int G, int D, int ps, int NP) {
  __shared__ float red[WARPS];
  __shared__ float part[THREADS];
  __shared__ float p_s[TILE];                    // a tile's probabilities
  __shared__ size_t r_s[TILE];                   // and its V rows' offsets
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = KVH * G, kvh = h / G, T = NP * ps;
  const float* s = sc + ((size_t)b * H + h) * ((size_t)T + 1);
  const Live lv = live_keys(pos, kvs, window, b, T);
  const float s_self = s[T] * scale;
  float m = NEG_INF;
  for (int j = lv.lo + threadIdx.x; j < lv.hi; j += THREADS)
    m = fmaxf(m, s[j] * scale);
  m = fmaxf(block_max(m, red), s_self);
  float l = 0.f;
  for (int j = lv.lo + threadIdx.x; j < lv.hi; j += THREADS)
    l += expf(s[j] * scale - m);
  l = block_sum(l, red) + expf(s_self - m);
  const float p_self = rounded<QT>(expf(s_self - m) / l);
  const int dw = min(D, THREADS), ng = THREADS / dw;
  const int lane = threadIdx.x % dw, grp = threadIdx.x / dw;
  const int* pb = phys + (size_t)b * NP;
  const KT* vn = v_new + ((size_t)b * KVH + kvh) * D;
  QT* o = out + ((size_t)b * H + h) * D;
  for (int d0 = 0; d0 < D; d0 += dw) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int t0 = lv.lo; t0 < lv.hi; t0 += TILE) {
      const int n = min(TILE, lv.hi - t0);
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const int j = t0 + i;
        p_s[i] = rounded<QT>(expf(s[j] * scale - m) / l);
        r_s[i] = (((size_t)pb[j / ps] * ps + j % ps) * KVH + kvh) * D;
      }
      __syncthreads();
      if (grp < ng && d < D)
        for (int i = grp; i < n; i += ng)
          acc = fmaf(p_s[i], to_f(vp[r_s[i] + d]), acc);
      __syncthreads();
    }
    part[threadIdx.x] = acc;
    __syncthreads();
    if (grp == 0 && d < D) {
      float tot = 0.f;
      for (int g = 0; g < ng; ++g) tot += part[g * dw + lane];
      store(o + d, fmaf(p_self, to_f(vn[d]), tot));
    }
    __syncthreads();
  }
}

bool bad_shape(int B, int KVH, int G, int D, int ps, int NP, int kv_dtype,
               int q_dtype) {
  return B <= 0 || B > 65535 || KVH <= 0 || G < 1 || D < 1 || ps < 1 ||
         NP < 1 || kv_dtype < 0 || kv_dtype > 1 || q_dtype < 0 ||
         q_dtype > 1 || (size_t)KVH * G > 65535;
}

// Runs f(KT{}, QT{}) for the pool's and q's types.
template <typename F>
int with_types(int kv_dtype, int q_dtype, F f) {
  if (kv_dtype == 0)
    return q_dtype == 0 ? f(float{}, float{}) : f(float{}, __nv_bfloat16{});
  return q_dtype == 0 ? f(__nv_bfloat16{}, float{})
                      : f(__nv_bfloat16{}, __nv_bfloat16{});
}

}  // namespace

// B2s. q (B, 1, KVH * G, D) in q_dtype; pages, k_new in kv_dtype (0 f32,
// 1 bf16); sc (B, KVH * G, NP * ps + 1) f32. The slot's q slice must fit
// 48 KB of shared memory. Returns a cudaError_t.
extern "C" int flash_decode_hd_scores_launch(
    const void* q, const void* k_pages, const void* k_new, const void* phys,
    const void* pos, const void* kv_start, int window, void* sc, int B,
    int KVH, int G, int D, int ps, int NP, int kv_dtype, int q_dtype,
    void* stream) {
  const size_t smem = sizeof(float) * (size_t)KVH * G * D;
  if (bad_shape(B, KVH, G, D, ps, NP, kv_dtype, q_dtype) ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(NP + 1, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(kv_dtype, q_dtype, [&](auto kt, auto qt) {
    using KT = decltype(kt);
    using QT = decltype(qt);
    hd_scores_kernel<KT, QT><<<grid, THREADS, smem, st>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
        static_cast<const KT*>(k_new), static_cast<const int*>(phys),
        static_cast<const int*>(pos), static_cast<const int*>(kv_start),
        window, static_cast<float*>(sc), KVH, G, D, ps, NP);
    return (int)cudaGetLastError();
  });
}

// B2a. sc (B, KVH * G, NP * ps + 1) f32 (the all-reduced scores); pages,
// v_new in kv_dtype; out (B, 1, KVH * G, D) in out_dtype (0 f32, 1 bf16).
// Returns a cudaError_t.
extern "C" int flash_decode_hd_attend_launch(
    const void* sc, const void* v_pages, const void* v_new, const void* phys,
    const void* pos, const void* kv_start, int window, float scale,
    void* out, int B, int KVH, int G, int D, int ps, int NP, int kv_dtype,
    int out_dtype, void* stream) {
  if (bad_shape(B, KVH, G, D, ps, NP, kv_dtype, out_dtype))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(KVH * G, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(kv_dtype, out_dtype, [&](auto kt, auto qt) {
    using KT = decltype(kt);
    using QT = decltype(qt);
    hd_attend_kernel<KT, QT><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(sc), static_cast<const KT*>(v_pages),
        static_cast<const KT*>(v_new), static_cast<const int*>(phys),
        static_cast<const int*>(pos), static_cast<const int*>(kv_start),
        window, scale, static_cast<QT*>(out), KVH, G, D, ps, NP);
    return (int)cudaGetLastError();
  });
}
