// Device code shared by the VQ-AMM kernels: B1 (fused_amm.cu, through
// vq_gather.cuh), B3 (assign.cu) and B4 (lut_gemm.cu).
//
// B1 and B3 assign with the one distance and nearest code below, so B3's
// indices are B1's bit for bit (the same fp32 order, the first strict
// minimum). B3 stages its tiles with assign_tile; B4 is the first
// version's LUT gather-accumulate (lut_tile, split_width, zero_acc,
// finish) with the indices read in; its int8 output, (float)(int32 sum) *
// scale, is the expression B1 writes. The distance sums use explicit
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs in
// one kernel and not in another.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace vqc {

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
// metric 0 l2 (|x|^2 - 2 x.z + |z|^2), 1 l1, 2 chebyshev.
template <int METRIC>
__device__ __forceinline__ float distance(const float* xr, const float* zj,
                                          int v) {
  float acc = 0.f, x2 = 0.f, z2 = 0.f;
  for (int i = 0; i < v; ++i) {
    const float xv = xr[i], zv = zj[i];
    if (METRIC == 0) {
      x2 = __fmaf_rn(xv, xv, x2);
      acc = __fmaf_rn(xv, zv, acc);
      z2 = __fmaf_rn(zv, zv, z2);
    } else if (METRIC == 1) {
      acc = __fadd_rn(acc, fabsf(__fsub_rn(xv, zv)));
    } else {
      acc = fmaxf(acc, fabsf(__fsub_rn(xv, zv)));
    }
  }
  return METRIC == 0 ? __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, acc)), z2)
                     : acc;
}

// Index of the nearest of the c centroids zk (one every zrow floats) to
// xr. j rises and only a strict < replaces the best, so the lowest index
// wins a tie, as jnp.argmin and torch.argmin do.
template <int METRIC>
__device__ __forceinline__ int nearest(const float* xr, const float* zk,
                                       int c, int v, int zrow) {
  float best = INFINITY;
  int best_j = 0;
  for (int j = 0; j < c; ++j) {
    const float d = distance<METRIC>(xr, zk + j * zrow, v);
    if (d < best) {
      best = d;
      best_j = j;
    }
  }
  return best_j;
}

// Staged layout of the assignment phase: the ks subspaces' centroids
// (one row of c * v + 1 floats each, the +1 against bank conflicts), then
// BM rows of x, each ks * v + 1 floats.
__host__ __device__ inline int z_stride(int c, int v) { return c * v + 1; }
__host__ __device__ inline int x_stride(int ks, int v) { return ks * v + 1; }
__host__ __device__ inline size_t stage_floats(int ks, int c, int v) {
  return (size_t)ks * z_stride(c, v) + (size_t)BM * x_stride(ks, v);
}

// Assign the block's (row, subspace) pairs: stage z[k0 .. k0+kn) and
// x[m0 .. m0+mn, k0 .. k0+kn) in shared memory (fp32, coalesced, all
// loads in flight), then one thread per pair; the BM rows of one
// subspace are neighbouring threads, so their z reads are broadcasts.
// put(mi, kk, j) receives each index. Ends with a __syncthreads.
template <typename XT, int METRIC, typename Put>
__device__ __forceinline__ void assign_tile(
    const XT* __restrict__ x, const XT* __restrict__ z, float* zs,
    float* xs, int nc, int c, int v, int ks, int m0, int mn, int k0,
    int kn, Put put) {
  const int tid = threadIdx.x;
  const int cv = c * v, zst = z_stride(c, v), xst = x_stride(ks, v);
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
  for (int t = tid; t < kn * BM; t += THREADS) {
    const int kk = t / BM, mi = t % BM;
    if (mi < mn)
      put(mi, kk, nearest<METRIC>(xs + mi * xst + kk * v, zs + kk * zst, c,
                                  v, v));
  }
  __syncthreads();
}

// LUT gather-accumulate of one block: rows m0 .. m0+mn, subspaces
// k0 .. k0+kn with their indices in sidx[mi * ks + kk], columns
// n0 .. n0+BN. Each of the 8 warps takes every 8th subspace; a lane adds
// 4 consecutive columns of the selected LUT row, so a warp reads one
// 128-byte line (int8) per row. The warps' partial tiles meet in red
// (BM x BN, shared), and the tile goes to acc:
//  * int8 LUTs (AccT int): shared and global atomicAdd into acc (M, N).
//    Integer sums are exact, so the order does not matter.
//  * float LUTs (AccT float): no atomic anywhere, so the result does not
//    depend on which warp or block finishes first. The warps add their
//    tiles into red one after another, in warp order, between barriers;
//    the block then stores its tile into its own split's slice of acc
//    (split_slice), and finish sums the splits in split order.
template <typename AccT>
__device__ __forceinline__ AccT* split_slice(AccT* acc, int M, int N) {
  if constexpr (std::is_same<AccT, int>::value) return acc;
  else return acc + (size_t)blockIdx.y * M * N;
}

template <typename LT, typename AccT>
__device__ __forceinline__ void lut_tile(
    const LT* __restrict__ lut, const unsigned char* sidx, AccT* red,
    AccT* __restrict__ acc, int c, int N, int ks, int m0, int mn, int k0,
    int kn, int n0, int vec_ok) {
  constexpr bool EXACT = std::is_same<AccT, int>::value;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < BM * BN; i += THREADS) red[i] = AccT(0);
  __syncthreads();
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
    if constexpr (EXACT) {
#pragma unroll
      for (int mi = 0; mi < BM; ++mi)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (mi < mn) atomicAdd(&red[mi * BN + lane * VEC + j], a[mi][j]);
    }
  }
  if constexpr (EXACT) {
    __syncthreads();
  } else {
    for (int w = 0; w < WARPS; ++w) {   // fixed order: warp 0, 1, ..., 7
      if (warp == w && n < N) {
#pragma unroll
        for (int mi = 0; mi < BM; ++mi) {
          if (mi < mn) {
            float4* r = reinterpret_cast<float4*>(red + mi * BN + lane * VEC);
            float4 t = *r;
            t.x += a[mi][0]; t.y += a[mi][1]; t.z += a[mi][2]; t.w += a[mi][3];
            *r = t;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < mn * BN; i += THREADS) {
    const int col = n0 + i % BN;
    if (col < N) {
      AccT* dst = &acc[(size_t)(m0 + i / BN) * N + col];
      if constexpr (EXACT) atomicAdd(dst, red[i]);
      else *dst = red[i];
    }
  }
}

// int8 LUTs: out = acc x scale, acc the exact int32 (M, N) sum.
__global__ void scale_kernel(const int* acc, const float* scale, float* out,
                             int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  float val = (float)acc[i];
  if (scale != nullptr) val *= scale[i % N];
  out[i] = val;
}

// Float LUTs: out = (sum of the splits' tiles, in split order) (x scale),
// acc the (splits, M, N) work buffer of per-split tiles.
__global__ void sum_splits_kernel(const float* acc, const float* scale,
                                  float* out, int M, int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float val = acc[i];
  for (int s = 1; s < splits; ++s) val += acc[(size_t)s * mn + i];
  if (scale != nullptr) val *= scale[i % N];
  out[i] = val;
}

// Subspaces per block for the split-K LUT accumulation: enough splits of
// nc that the grid puts ~2 blocks on each SM even at M = 8.
inline int split_width(int M, int nc, int N) {
  const int nbn = (N + BN - 1) / BN;
  const int nbm = (M + BM - 1) / BM;
  int splits = (TARGET_BLOCKS + nbn * nbm - 1) / (nbn * nbm);
  splits = splits < 1 ? 1 : (splits > nc ? nc : splits);
  return (nc + splits - 1) / splits;
}

// The accumulator of the split-K sum, `work`: for int8 LUTs an (M, N)
// int32 buffer that zero_acc clears before the accumulating kernel; for
// float LUTs a (splits, M, N) float32 buffer that every block writes its
// tile into once (nothing to clear). finish writes out after the
// accumulating kernel: one launch either way.
inline cudaError_t zero_acc(int lut_dtype, void* work, int M, int N,
                            cudaStream_t st) {
  if (lut_dtype != 2) return cudaSuccess;
  return cudaMemsetAsync(work, 0, sizeof(int) * (size_t)M * N, st);
}

inline cudaError_t finish(int lut_dtype, const float* scale, float* out,
                          const void* work, int M, int N, int splits,
                          cudaStream_t st) {
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + 255) / 256);
  if (lut_dtype == 2)
    scale_kernel<<<blocks, 256, 0, st>>>(static_cast<const int*>(work),
                                         scale, out, M, N);
  else
    sum_splits_kernel<<<blocks, 256, 0, st>>>(
        static_cast<const float*>(work), scale, out, M, N, splits);
  return cudaGetLastError();
}

}  // namespace vqc
