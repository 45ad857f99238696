// Kernel B3: VQ centroid assignment (the CCM stage of the two-pass path)
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/assign.py::vq_assign_pallas (body
// _assign_kernel), which lut_infer projections run under
// QuantConfig(fuse=False), before kernel B4.
//
//   idx[m, k] = argmin_j d(x[m, k, :], z[k, j, :])
//
//   x (M, nc, v) f32|bf16, z (nc, c, v) same type, idx (M, nc) int32.
//   d is L2 (|x|^2 - 2 x.z + |z|^2), L1 or Chebyshev, in fp32.
//
// What bounds it on the H100: bytes. It must read x and z once and write
// the indices: at decode (M = 8, K = 2560, v = 8, c = 16, bf16) that is
// 41 KB of x, 82 KB of z and 10 KB of indices, 0.04 us at 3.35 TB/s; the
// distance work (M * nc * c * v * 3 multiply-adds, about a million) takes
// a small fraction of a microsecond on the CUDA cores. So at the main shapes a launch costs
// what any launch costs, and the design keeps every load in flight.
//
// Design: B1's assignment with the indices written out (the two-pass
// baseline's whole point). One block of 256 threads per (group of ks
// subspaces, 8-row tile) stages its z and x slices in shared memory as
// fp32 (vq_common.cuh, assign_tile), then each thread assigns one (row,
// subspace) pair with the nearest that B1 runs and writes its int32
// index. ks is 32
// (256 threads / 8 rows), fewer when the staged tiles would not fit in
// 48 KB; when even one subspace needs more (c * v above ~11,900 floats)
// the block opts into up to 227 KB of dynamic shared memory. Ragged M and
// nc are masked; nothing is padded.

#include "vq_common.cuh"

namespace {

using namespace vqc;

constexpr size_t MAX_DYN_SMEM = 227 * 1024;

template <typename XT, int METRIC>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const XT* __restrict__ x, const XT* __restrict__ z,
              int* __restrict__ idx, int M, int nc, int c, int v, int ks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);            // [ks][c*v + 1]
  float* xs = zs + (size_t)ks * z_stride(c, v);          // [BM][ks*v + 1]
  const int k0 = blockIdx.x * ks;
  const int m0 = blockIdx.y * BM;
  const int kn = min(ks, nc - k0);
  const int mn = min(BM, M - m0);
  assign_tile<XT, METRIC>(x, z, zs, xs, nc, c, v, ks, m0, mn, k0, kn,
                          [&](int mi, int kk, int j) {
                            idx[(size_t)(m0 + mi) * nc + k0 + kk] = j;
                          });
}

template <typename XT, int METRIC>
cudaError_t launch_metric(const XT* x, const XT* z, int* idx, int M, int nc,
                          int c, int v, int ks, size_t smem,
                          cudaStream_t st) {
  if (smem > MAX_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_kernel<XT, METRIC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((nc + ks - 1) / ks, (M + BM - 1) / BM);
  assign_kernel<XT, METRIC><<<grid, THREADS, smem, st>>>(x, z, idx, M, nc,
                                                         c, v, ks);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_x(const void* x, const void* z, int* idx, int M, int nc,
                     int c, int v, int metric, cudaStream_t st) {
  int ks = THREADS / BM;
  if (ks > nc) ks = nc;
  while (ks > 1 && sizeof(float) * stage_floats(ks, c, v) > MAX_SMEM) --ks;
  const size_t smem = sizeof(float) * stage_floats(ks, c, v);
  if (smem > MAX_DYN_SMEM) return cudaErrorInvalidValue;
  const XT* xp = static_cast<const XT*>(x);
  const XT* zp = static_cast<const XT*>(z);
  if (metric == 0)
    return launch_metric<XT, 0>(xp, zp, idx, M, nc, c, v, ks, smem, st);
  if (metric == 1)
    return launch_metric<XT, 1>(xp, zp, idx, M, nc, c, v, ks, smem, st);
  return launch_metric<XT, 2>(xp, zp, idx, M, nc, c, v, ks, smem, st);
}

}  // namespace

// x_dtype: 0 f32, 1 bf16. metric: 0 l2, 1 l1, 2 chebyshev. idx is an
// (M, nc) int32 output. Returns a cudaError_t.
extern "C" int vq_assign_launch(const void* x, const void* z, void* idx,
                                int M, int nc, int c, int v, int x_dtype,
                                int metric, void* stream) {
  if (M <= 0 || nc <= 0 || c < 1 || c > 256 || v < 1 || x_dtype < 0 ||
      x_dtype > 1 || metric < 0 || metric > 2 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ip = static_cast<int*>(idx);
  const cudaError_t err =
      x_dtype == 0
          ? launch_x<float>(x, z, ip, M, nc, c, v, metric, st)
          : launch_x<__nv_bfloat16>(x, z, ip, M, nc, c, v, metric, st);
  return (int)err;
}
