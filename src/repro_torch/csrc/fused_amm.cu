// Kernel B1: fused VQ-AMM (nearest-centroid assignment + LUT
// gather-accumulate) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_amm.py::vq_amm_pallas (body
// _fused_kernel), the TPU kernel behind every lut_infer projection.
//
//   out[m, n] = scale[n] * sum_k lut[k, argmin_j d(x[m, k, :], z[k, j, :]), n]
//
//   x (M, nc, v) f32|bf16, z (nc, c, v) same type, lut (nc, c, N)
//   f32|bf16|int8, scale (N,) f32 or null, out (M, N) f32.
//   d is L2 (|x|^2 - 2 x.z + |z|^2), L1 or Chebyshev, in fp32.
//
// What bounds it on the H100: bytes. At decode (M = 8) a projection must
// read each LUT row that some row of x selects, once: for c = 16 about
// 40% of the table, one byte per entry in int8, for one integer add per
// byte. The distance work (M * nc * c * v multiply-adds) is noise beside.
//
// Design:
//  * One block per (128-column tile, group of ks subspaces, 8-row tile).
//    The TPU's sequential k grid axis with its VMEM accumulator has no
//    counterpart here: blocks run in parallel and in no order, so the
//    k range is split across blocks (split-K) to put ~2 blocks on each of
//    the 132 SMs even at M = 8, and the partial sums meet with atomicAdd
//    in a (M, N) accumulator. For int8 LUTs that accumulator is int32, so
//    the sum is exact and the result does not depend on the order.
//  * Phase 1: the block stages its ks subspaces of z and its rows' slices
//    of x in shared memory (fp32, coalesced, all loads in flight), then
//    every thread assigns one (row, subspace) pair: it scans the c
//    centroids in order and keeps the first strict minimum, so the lowest
//    index wins a tie, as jnp.argmin and torch.argmin do. The indices go
//    to shared memory (uint8, c <= 256); the (M, nc) indices never reach
//    device memory -- the point of the fusion. ks is capped so the staged
//    tiles fit in 48 KB.
//  * Phase 2: each of the 8 warps takes every 8th subspace of the group;
//    a lane adds 4 consecutive columns of the selected LUT row, so a warp
//    reads one 128-byte line (int8) per row: a gather-accumulate, not the
//    TPU's one-hot matmul (an MXU idiom). The warps' partial tiles meet
//    in shared memory, then one atomicAdd per output element per block.
//  * The int8 scale is applied once, after all subspaces, by a second
//    small kernel (the TPU kernel's flush + scale step).
//  * The ragged edges (M, N, nc not multiples of the tiles) are masked in
//    the kernel; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;                  // rows of x per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 4;                 // output columns per lane
constexpr int BN = 32 * VEC;           // 128 output columns per block
constexpr int TARGET_BLOCKS = 2 * 132; // ~2 blocks per SM on an H100
constexpr size_t MAX_SMEM = 48 * 1024;

__device__ __forceinline__ float to_f(float a) { return a; }
__device__ __forceinline__ float to_f(__nv_bfloat16 a) { return __bfloat162float(a); }

__device__ __forceinline__ int to_acc(int8_t a) { return (int)a; }
__device__ __forceinline__ float to_acc(float a) { return a; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 a) { return __bfloat162float(a); }

// Add lut[p .. p+3] into a[0..3]; p is 4-element aligned.
__device__ __forceinline__ void add4(const int8_t* p, int* a) {
  const char4 q = *reinterpret_cast<const char4*>(p);
  a[0] += q.x; a[1] += q.y; a[2] += q.z; a[3] += q.w;
}
__device__ __forceinline__ void add4(const float* p, float* a) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  a[0] += q.x; a[1] += q.y; a[2] += q.z; a[3] += q.w;
}
__device__ __forceinline__ void add4(const __nv_bfloat16* p, float* a) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  a[0] += __low2float(lo); a[1] += __high2float(lo);
  a[2] += __low2float(hi); a[3] += __high2float(hi);
}

// Distance of the sub-vector xr to the centroid zj (v elements), fp32.
template <int METRIC>
__device__ __forceinline__ float distance(const float* xr, const float* zj,
                                          int v) {
  float acc = 0.f, x2 = 0.f, z2 = 0.f;
  for (int i = 0; i < v; ++i) {
    const float xv = xr[i], zv = zj[i];
    if (METRIC == 0) {                 // l2: |x|^2 - 2 x.z + |z|^2
      x2 += xv * xv;
      acc += xv * zv;
      z2 += zv * zv;
    } else if (METRIC == 1) {          // l1
      acc += fabsf(xv - zv);
    } else {                           // chebyshev
      acc = fmaxf(acc, fabsf(xv - zv));
    }
  }
  return METRIC == 0 ? x2 - 2.f * acc + z2 : acc;
}

// Shared memory of one block: the (BM, BN) partial tile, then the staged
// z and x (fp32; rows padded by one float against bank conflicts), then
// the indices.
__host__ __device__ inline int z_stride(int c, int v) { return c * v + 1; }
__host__ __device__ inline int x_stride(int ks, int v) { return ks * v + 1; }
__host__ __device__ inline size_t smem_bytes(size_t acc_size, int ks, int c,
                                             int v) {
  return acc_size * BM * BN + sizeof(float) * ((size_t)ks * z_stride(c, v) +
                                               (size_t)BM * x_stride(ks, v)) +
         (size_t)BM * ks;
}

template <typename XT, typename LT, typename AccT, int METRIC>
__global__ void __launch_bounds__(THREADS)
vq_amm_kernel(const XT* __restrict__ x, const XT* __restrict__ z,
              const LT* __restrict__ lut, AccT* __restrict__ acc,
              int M, int nc, int c, int v, int N, int ks, int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  AccT* red = reinterpret_cast<AccT*>(smem);             // [BM][BN]
  float* zs = reinterpret_cast<float*>(red + BM * BN);   // [ks][c*v + 1]
  float* xs = zs + (size_t)ks * z_stride(c, v);          // [BM][ks*v + 1]
  unsigned char* sidx =
      reinterpret_cast<unsigned char*>(xs + (size_t)BM * x_stride(ks, v));

  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * ks;
  const int m0 = blockIdx.z * BM;
  const int kn = min(ks, nc - k0);
  const int mn = min(BM, M - m0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int cv = c * v, zst = z_stride(c, v), xst = x_stride(ks, v);

  // phase 1a: stage z[k0 .. k0+kn) and x[m0 .. m0+mn, k0 .. k0+kn)
  const XT* zsrc = z + (size_t)k0 * cv;
#pragma unroll 4
  for (int i = tid; i < kn * cv; i += THREADS)
    zs[(i / cv) * zst + i % cv] = to_f(zsrc[i]);
  const int xw = kn * v;                 // elements of one row's slice
#pragma unroll 4
  for (int i = tid; i < mn * xw; i += THREADS) {
    const int mi = i / xw, j = i % xw;
    xs[mi * xst + j] = to_f(x[((size_t)(m0 + mi) * nc + k0) * v + j]);
  }
  __syncthreads();

  // phase 1b: one thread per (subspace, row) pair; the 8 rows of one
  // subspace are neighbouring threads, so their z reads are broadcasts
  for (int t = tid; t < kn * BM; t += THREADS) {
    const int kk = t / BM, mi = t % BM;
    if (mi < mn) {
      const float* xr = xs + mi * xst + kk * v;
      const float* zk = zs + kk * zst;
      float best = INFINITY;
      int best_j = 0;
      for (int j = 0; j < c; ++j) {      // j rises: strict < keeps lowest
        const float d = distance<METRIC>(xr, zk + j * v, v);
        if (d < best) {
          best = d;
          best_j = j;
        }
      }
      sidx[mi * ks + kk] = (unsigned char)best_j;
    }
  }
  for (int i = tid; i < BM * BN; i += THREADS) red[i] = AccT(0);
  __syncthreads();

  // phase 2: gather-accumulate; warp w takes subspaces w, w+8, ...
  const int n = n0 + lane * VEC;
  AccT a[BM][VEC];
#pragma unroll
  for (int mi = 0; mi < BM; ++mi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[mi][j] = AccT(0);
  if (n < N) {
    const bool full = vec_ok && (n + VEC <= N);
    for (int kk = warp; kk < kn; kk += WARPS) {
      const LT* base = lut + (size_t)(k0 + kk) * c * N + n;
#pragma unroll
      for (int mi = 0; mi < BM; ++mi) {
        if (mi < mn) {
          const LT* p = base + (size_t)sidx[mi * ks + kk] * N;
          if (full) {
            add4(p, a[mi]);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              if (n + j < N) a[mi][j] += to_acc(p[j]);
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < BM; ++mi)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (mi < mn) atomicAdd(&red[mi * BN + lane * VEC + j], a[mi][j]);
  }
  __syncthreads();

  // one global atomic per output element of this block's tile
  for (int i = tid; i < mn * BN; i += THREADS) {
    const int col = n0 + i % BN;
    if (col < N) atomicAdd(&acc[(size_t)(m0 + i / BN) * N + col], red[i]);
  }
}

// out = acc (x scale); acc may alias out (float LUTs scale in place).
template <typename AccT>
__global__ void scale_kernel(const AccT* acc, const float* scale,
                             float* out, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  float val = (float)acc[i];
  if (scale != nullptr) val *= scale[i % N];
  out[i] = val;
}

template <typename XT, typename LT, typename AccT>
cudaError_t launch_typed(const void* x, const void* z, const void* lut,
                         AccT* acc, int M, int nc, int c, int v, int N,
                         int metric, cudaStream_t st) {
  const int nbn = (N + BN - 1) / BN;
  const int nbm = (M + BM - 1) / BM;
  int splits = (TARGET_BLOCKS + nbn * nbm - 1) / (nbn * nbm);
  splits = splits < 1 ? 1 : (splits > nc ? nc : splits);
  int ks = (nc + splits - 1) / splits;
  while (ks > 1 && smem_bytes(sizeof(AccT), ks, c, v) > MAX_SMEM) --ks;
  const size_t smem = smem_bytes(sizeof(AccT), ks, c, v);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  splits = (nc + ks - 1) / ks;
  const int vec_ok = (N % VEC == 0) && ((uintptr_t)lut % 16 == 0);
  const dim3 grid(nbn, splits, nbm);
  const XT* xp = static_cast<const XT*>(x);
  const XT* zp = static_cast<const XT*>(z);
  const LT* lp = static_cast<const LT*>(lut);
  if (metric == 0)
    vq_amm_kernel<XT, LT, AccT, 0><<<grid, THREADS, smem, st>>>(xp, zp, lp, acc, M, nc, c, v, N, ks, vec_ok);
  else if (metric == 1)
    vq_amm_kernel<XT, LT, AccT, 1><<<grid, THREADS, smem, st>>>(xp, zp, lp, acc, M, nc, c, v, N, ks, vec_ok);
  else
    vq_amm_kernel<XT, LT, AccT, 2><<<grid, THREADS, smem, st>>>(xp, zp, lp, acc, M, nc, c, v, N, ks, vec_ok);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_x(const void* x, const void* z, const void* lut,
                     const float* scale, float* out, int* work, int M,
                     int nc, int c, int v, int N, int lut_dtype, int metric,
                     cudaStream_t st) {
  cudaError_t err;
  if (lut_dtype == 2) {                // int8: exact int32 accumulator
    err = cudaMemsetAsync(work, 0, sizeof(int) * (size_t)M * N, st);
    if (err != cudaSuccess) return err;
    err = launch_typed<XT, int8_t, int>(x, z, lut, work, M, nc, c, v, N,
                                        metric, st);
  } else {                             // float LUT: accumulate in out
    err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)M * N, st);
    if (err != cudaSuccess) return err;
    if (lut_dtype == 0)
      err = launch_typed<XT, float, float>(x, z, lut, out, M, nc, c, v, N,
                                           metric, st);
    else
      err = launch_typed<XT, __nv_bfloat16, float>(x, z, lut, out, M, nc,
                                                   c, v, N, metric, st);
  }
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + 255) / 256);
  if (lut_dtype == 2)
    scale_kernel<int><<<blocks, 256, 0, st>>>(work, scale, out, M, N);
  else if (scale != nullptr)
    scale_kernel<float><<<blocks, 256, 0, st>>>(out, scale, out, M, N);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 f32, 1 bf16. lut_dtype: 0 f32, 1 bf16, 2 int8.
// metric: 0 l2, 1 l1, 2 chebyshev. scale may be null. work is an (M, N)
// int32 scratch buffer, used for int8 LUTs only. Returns a cudaError_t.
extern "C" int vq_amm_launch(const void* x, const void* z, const void* lut,
                             const void* scale, void* out, void* work,
                             int M, int nc, int c, int v, int N,
                             int x_dtype, int lut_dtype, int metric,
                             void* stream) {
  if (M <= 0 || nc <= 0 || N <= 0 || c < 1 || c > 256 || v < 1 ||
      x_dtype < 0 || x_dtype > 1 || lut_dtype < 0 ||
      lut_dtype > 2 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  int* wp = static_cast<int*>(work);
  cudaError_t err = x_dtype == 0
      ? launch_x<float>(x, z, lut, sp, op, wp, M, nc, c, v, N, lut_dtype,
                        metric, st)
      : launch_x<__nv_bfloat16>(x, z, lut, sp, op, wp, M, nc, c, v, N,
                                lut_dtype, metric, st);
  return (int)err;
}
