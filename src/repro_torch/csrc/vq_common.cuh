// Distance and argmin code of the VQ-AMM kernels: B1 (fused_amm.cu) and
// B3 (assign.cu) both assign through vq_gather.cuh's assign_block, which
// runs nearest below, so B3's indices are B1's bit for bit (the same fp32
// order, the first strict minimum). The distance sums use explicit
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs in
// one kernel and not in another.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vqc {

__device__ __forceinline__ float to_f(float a) { return a; }
__device__ __forceinline__ float to_f(__nv_bfloat16 a) { return __bfloat162float(a); }

__device__ __forceinline__ int to_acc(int8_t a) { return (int)a; }
__device__ __forceinline__ float to_acc(float a) { return a; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 a) { return __bfloat162float(a); }

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

// Staged layout of the assignment (vq_gather.cuh, assign_block): each
// subspace's centroids as one row of c * v + 1 floats (the +1 against
// bank conflicts), then each row of x as ks * v + 1 floats for ks staged
// subspaces.
__host__ __device__ inline int z_stride(int c, int v) { return c * v + 1; }
__host__ __device__ inline int x_stride(int ks, int v) { return ks * v + 1; }

}  // namespace vqc
