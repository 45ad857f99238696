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
//    the 132 SMs even at M = 8. For int8 LUTs the partial sums meet with
//    atomicAdd in an (M, N) int32 accumulator: exact, so the result does
//    not depend on the order. For float LUTs each block stores its tile
//    into its own split's slice of a (splits, M, N) fp32 buffer, and the
//    finish kernel sums the splits in split order: no float atomic, so
//    the same input gives the same bits on every run, as the TPU's
//    sequential k axis does.
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
//    in shared memory (int8: shared atomics; float: warp by warp, in warp
//    order), then go to the accumulator once per output element.
//  * The scale is applied once, after all subspaces, by a second small
//    kernel (the TPU kernel's flush + scale step), which for float LUTs
//    also sums the splits. Launches a call: int8 three (memset, kernel,
//    scale), float two (kernel, sum + scale).
//  * The ragged edges (M, N, nc not multiples of the tiles) are masked in
//    the kernel; nothing is padded.
//  * Phase 1 (assign_tile) and phase 2 (lut_tile) live in vq_common.cuh,
//    shared with the two-pass kernels B3 (assign.cu) and B4 (lut_gemm.cu),
//    so that B4(B3(x)) is this kernel's result bit for bit on int8 LUTs.

#include "vq_common.cuh"

namespace {

using namespace vqc;

// Shared memory of one block: the (BM, BN) partial tile, then the staged
// z and x (vq_common.cuh), then the indices.
inline size_t smem_bytes(size_t acc_size, int ks, int c, int v) {
  return acc_size * BM * BN + sizeof(float) * stage_floats(ks, c, v) +
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

  // phase 1: indices into shared memory only
  assign_tile<XT, METRIC>(x, z, zs, xs, nc, c, v, ks, m0, mn, k0, kn,
                          [&](int mi, int kk, int j) {
                            sidx[mi * ks + kk] = (unsigned char)j;
                          });
  // phase 2: gather-accumulate, then the tile to acc (lut_tile)
  lut_tile<LT, AccT>(lut, sidx, red, split_slice(acc, M, N), c, N, ks, m0,
                     mn, k0, kn, n0, vec_ok);
}

// Subspaces per block: the split rule, cut until the staged tiles fit.
// The same for every LUT type (the accumulators are 4 bytes each).
inline int block_width(int M, int nc, int c, int v, int N) {
  int ks = split_width(M, nc, N);
  while (ks > 1 && smem_bytes(4, ks, c, v) > MAX_SMEM) --ks;
  return ks;
}

template <typename XT, typename LT, typename AccT>
cudaError_t launch_typed(const void* x, const void* z, const void* lut,
                         AccT* acc, int M, int nc, int c, int v, int N,
                         int metric, cudaStream_t st) {
  const int ks = block_width(M, nc, c, v, N);
  const size_t smem = smem_bytes(sizeof(AccT), ks, c, v);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int splits = (nc + ks - 1) / ks;
  const int vec_ok = (N % VEC == 0) && ((uintptr_t)lut % 16 == 0);
  const dim3 grid((N + BN - 1) / BN, splits, (M + BM - 1) / BM);
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
                     const float* scale, float* out, void* work, int M,
                     int nc, int c, int v, int N, int lut_dtype, int metric,
                     cudaStream_t st) {
  cudaError_t err = zero_acc(lut_dtype, work, M, N, st);
  if (err != cudaSuccess) return err;
  float* fw = static_cast<float*>(work);
  if (lut_dtype == 2)                  // int8: exact int32 accumulator
    err = launch_typed<XT, int8_t, int>(x, z, lut, static_cast<int*>(work),
                                        M, nc, c, v, N, metric, st);
  else if (lut_dtype == 0)             // float LUT: one tile per split
    err = launch_typed<XT, float, float>(x, z, lut, fw, M, nc, c, v, N,
                                         metric, st);
  else
    err = launch_typed<XT, __nv_bfloat16, float>(x, z, lut, fw, M, nc, c,
                                                 v, N, metric, st);
  if (err != cudaSuccess) return err;
  const int ks = block_width(M, nc, c, v, N);
  return finish(lut_dtype, scale, out, work, M, N, (nc + ks - 1) / ks,
                st);
}

}  // namespace

// Split-K blocks of a call at these shapes: the float-LUT work buffer
// holds one (M, N) tile per split.
extern "C" int vq_amm_splits(int M, int nc, int c, int v, int N) {
  if (M <= 0 || nc <= 0 || N <= 0 || c < 1 || v < 1) return 0;
  const int ks = block_width(M, nc, c, v, N);
  return (nc + ks - 1) / ks;
}

// x_dtype: 0 f32, 1 bf16. lut_dtype: 0 f32, 1 bf16, 2 int8.
// metric: 0 l2, 1 l1, 2 chebyshev. scale may be null. work is the split-K
// accumulator: (M, N) int32 for int8 LUTs, (vq_amm_splits(...), M, N)
// float32 for float LUTs. Returns a cudaError_t.
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
  cudaError_t err = x_dtype == 0
      ? launch_x<float>(x, z, lut, sp, op, work, M, nc, c, v, N, lut_dtype,
                        metric, st)
      : launch_x<__nv_bfloat16>(x, z, lut, sp, op, work, M, nc, c, v, N,
                                lut_dtype, metric, st);
  return (int)err;
}
