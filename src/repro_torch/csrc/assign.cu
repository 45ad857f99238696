// Kernel B3: VQ centroid assignment (the CCM stage of the two-pass path)
// for Hopper (sm_90a), one launch a call.
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
// a small fraction of a microsecond on the CUDA cores. So at the main
// shapes a launch costs a launch plus one block's chain of dependent
// steps, and the design keeps that chain short.
//
// Design: kernel B1's assignment (vq_gather.cuh, assign_block) with the
// indices written out.
//  * One block of 256 threads per (k range, group of up to 64 rows). By
//    default a block takes 8 subspaces, fewer above 32 rows so that a
//    thread has at most one (row, subspace) pair: at M = 8, 4-8 measured
//    ~0.5 us faster than 16-64 on the H100 (PERF.md, nc sweep); the
//    caller may name another count.
//  * The block stages its z and x slices in shared memory as fp32 with
//    16-byte loads, all of them in flight at once (eight a thread), then
//    each thread assigns its pairs with vq_common.cuh's nearest (x in
//    registers when v = 8), so the indices are B1's bit for bit. The
//    uint8 indices then go from shared memory to idx, neighbouring
//    threads on neighbouring subspaces (coalesced).
//  * The general path lives in the same kernel: any M, c up to 256, any
//    v (rows of x and z that are not 16-byte aligned take element
//    loads), ragged nc. Subspaces whose slices do not fit the 48 KB
//    staging area go ka at a time; when one subspace needs more, the
//    block opts into up to the card's 227 KB, with fewer rows a block if
//    even that is short.

#include "vq_gather.cuh"

namespace {

using namespace vqg;

constexpr int SMEM_DEFAULT = 48 * 1024;   // no opt-in needed below this
constexpr int BLOCK_SUBSPACES = 8;        // the default, see above

template <typename XT>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const XT* __restrict__ x, const XT* __restrict__ z,
              int* __restrict__ out, int M, int nc, int c, int v,
              int metric, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned char* idx = smem + g.off_idx;
  const int k0 = blockIdx.x * g.kmax;
  const int kn = min(g.kmax, nc - k0);
  const int m0 = blockIdx.y * g.rows;
  const int mt = min(g.rows, M - m0);
  const int rs = g.rows;
  assign_block<XT>(x, z, smem + g.off_stage, smem + g.off_idx, g, metric,
                   nc, c, v, m0, mt, k0, kn, rs);
  for (int i = threadIdx.x; i < mt * kn; i += THREADS) {
    const int m = i / kn, kk = i % kn;
    out[(size_t)(m0 + m) * nc + k0 + kk] = idx[kk * rs + m];
  }
}

// The block layout: rows and subspaces a block (kb, or the default when
// kb is 0), the subspaces staged at once and the shared memory. Returns
// false when no layout fits max_smem.
inline bool assign_geometry(Geometry& g, int M, int nc, int c, int v,
                            int kb, bool vec_x, int max_smem) {
  g = Geometry{};
  g.vec_x = vec_x;
  for (int rows = M < ROW_CAP ? M : ROW_CAP; rows >= 1; rows /= 2) {
    int kmax = kb > 0 ? kb : THREADS / rows;
    if (kb == 0 && kmax > BLOCK_SUBSPACES) kmax = BLOCK_SUBSPACES;
    if (kmax > nc) kmax = nc;
    g.rows = rows;
    g.kmax = kmax;
    g.ka = staged_subspaces(kmax, rows, c, v, STAGING_BYTES);
    g.off_idx = 0;
    g.off_stage = (int)up16((size_t)kmax * rows);
    const size_t smem = g.off_stage + staging_bytes(g.ka, rows, c, v);
    g.smem = (int)smem;
    if (smem <= (size_t)max_smem) return true;
  }
  return false;
}

template <typename XT>
cudaError_t launch_x(const void* x, const void* z, int* idx, int M, int nc,
                     int c, int v, int metric, int kb, cudaStream_t st,
                     int* info) {
  const bool vec_x = (uintptr_t)x % 16 == 0 && (uintptr_t)z % 16 == 0 &&
                     (v * sizeof(XT)) % 16 == 0;
  Geometry g;
  if (!assign_geometry(g, M, nc, c, v, kb, vec_x, SMEM_DEFAULT)) {
    // one subspace needs more than 48 KB: opt into the card's maximum
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (!assign_geometry(g, M, nc, c, v, kb, vec_x, max_smem))
      return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(assign_kernel<XT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((nc + g.kmax - 1) / g.kmax, (M + g.rows - 1) / g.rows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (info != nullptr) {
    info[0] = (int)grid.x; info[1] = (int)grid.y; info[2] = g.kmax;
    info[3] = g.rows; info[4] = g.smem;
    return cudaSuccess;
  }
  assign_kernel<XT><<<grid, THREADS, g.smem, st>>>(
      static_cast<const XT*>(x), static_cast<const XT*>(z), idx, M, nc, c,
      v, metric, g);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 f32, 1 bf16. metric: 0 l2, 1 l1, 2 chebyshev. idx is an
// (M, nc) int32 output. kb: subspaces a block, or 0 for the default.
// Enqueues one kernel on stream and nothing else; with info non-null it
// launches nothing and writes the launch's k ranges, row groups,
// subspaces a block, rows a block and shared memory bytes to info[0..4].
// Returns a cudaError_t.
extern "C" int vq_assign_launch(const void* x, const void* z, void* idx,
                                int M, int nc, int c, int v, int x_dtype,
                                int metric, int kb, void* stream,
                                int* info) {
  if (M <= 0 || nc <= 0 || c < 1 || c > 256 || v < 1 || x_dtype < 0 ||
      x_dtype > 1 || metric < 0 || metric > 2 || kb < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ip = static_cast<int*>(idx);
  const cudaError_t err =
      x_dtype == 0
          ? launch_x<float>(x, z, ip, M, nc, c, v, metric, kb, st, info)
          : launch_x<__nv_bfloat16>(x, z, ip, M, nc, c, v, metric, kb, st,
                                    info);
  return (int)err;
}
