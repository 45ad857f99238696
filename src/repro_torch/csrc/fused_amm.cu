// Kernel B1: fused VQ-AMM (nearest-centroid assignment + LUT
// gather-accumulate) for Hopper (sm_90a), one launch a call.
//
// Replaces: src/repro/kernels/fused_amm.py::vq_amm_pallas (body
// _fused_kernel), the TPU kernel behind every lut_infer projection.
//
//   out[m, n] = scale[n] * sum_k lut[k, argmin_j d(x[m, k, :], z[k, j, :]), n]
//
//   x (M, nc, v) f32|bf16, z (nc, c, v) same type, lut (nc, c, N)
//   f32|bf16|int8, scale (N,) f32 or null, out (M, N) f32.
//   d is L2 (|x|^2 - 2 x.z + |z|^2), L1 or Chebyshev, in fp32; the lowest
//   index wins a tie.
//
// What bounds it on the H100: bytes. A projection must read each LUT row
// that some row of x selects, once: at decode (M = 8, c = 16) about 40%
// of the table, at the prefill chunk (M = 32) about 87%, one byte per
// entry in int8, for one integer add per byte and row of x. The distance
// work (M * nc * c * v multiply-adds) is small beside it. What held the
// first version back was not the bytes (PERF.md, PR 18): three launches
// a call, one chain of dependent small loads a block with <= 8 KB in
// flight, and an 8-row tile that re-read every LUT row once per 8 rows.
//
// Design (device and host code in vq_gather.cuh, which B3 and B4 share):
//  * One launch, one kernel: no memset, no work buffer, no second pass.
//    One block per (256-byte column tile, k range, group of up to 64
//    rows); the k ranges of one column tile form a thread block cluster
//    (grid y). The host picks the cluster size (1-16) from the card's own
//    occupancy report for this launch (cudaOccupancyMaxActiveClusters):
//    the least estimated time, waves of resident clusters x (subspaces a
//    block + a fixed cost), so the grid fits in one wave of the H100's
//    132 SMs at every main-path shape. The choice is cached per shape.
//  * A block stages its x rows and z slice with 16-byte loads, then
//    assigns every (row, subspace) pair with vq_common.cuh's nearest
//    (distance code, scan order and tie rule unchanged), so B3's indices
//    are these bit for bit. The indices stay in shared memory.
//  * Then every thread gathers its 16-byte column chunk of the selected
//    LUT rows straight into registers, 16 loads in flight (two batches,
//    one added while the next lands); up to 8 rows of x, the threads
//    split the subspaces into two halves so all 8 warps gather. Rows that
//    select the same LUT row load the same line at about the same time,
//    so each selected row comes from device memory once per (column
//    tile, k range) for every row of x: the first version read it once
//    per 8 rows.
//  * Sums stay in registers (int8: dp4a into exact int32; float: fp32,
//    subspace order). Each block pushes its partial tile into the shared
//    memory of the ranks that own its parts (distributed shared memory),
//    and after one cluster barrier each rank sums its share over the
//    ranks in rank order, applies the scale and writes out. No atomic
//    touches a sum: a float result is the same on every launch, and an
//    int8 result is (float)(int32 sum) * scale[n], B4's expression, so
//    B4(B3(x)) == B1(x) bit for bit on int8 LUTs.
//  * A shared-memory ring of selected rows fed by 16-byte cp.async, then
//    by one TMA bulk copy a row, was tried first and measured slower:
//    the copies stalled at issue (PERF.md, PR 18).
//  * The general path lives in the same kernel: any M (row groups in grid
//    z), c up to 256, any v (x and z rows that are not 16-byte aligned
//    take element loads), ragged N (masked) and LUTs whose rows are not
//    16-byte aligned (element loads).

#ifdef VQG_PROFILE
namespace { __device__ __forceinline__ void stamp(int i); }
#define VQG_STAMP(i) stamp(i)
#endif
#include "vq_gather.cuh"

namespace {

using namespace vqg;

// Phase timestamps of each block, for scripts/b1_phases.py: built only
// with -DVQG_PROFILE; thread 0 of each block writes clock64() at phase i
// to slot i of its 16 slots, and the global timer at start and end to
// slots 14 and 15.
#ifdef VQG_PROFILE
__device__ long long* vqg_prof = nullptr;
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0 && vqg_prof != nullptr) {
    long long* p = vqg_prof + 16 * (blockIdx.x + gridDim.x *
                                     (blockIdx.y + gridDim.y * blockIdx.z));
    p[i] = clock64();
    if (i == 0 || i == 6) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      p[i == 0 ? 14 : 15] = (long long)t;
    }
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

template <typename XT, typename LT, int R>
__global__ void __launch_bounds__(THREADS)
vq_amm_kernel(const XT* __restrict__ x, const XT* __restrict__ z,
              const LT* __restrict__ lut, const float* __restrict__ scale,
              float* __restrict__ out, int M, int nc, int c, int v, int N,
              int metric, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of<LT>(g, M, nc);
  stamp(0);
  copy_scale<LT>(smem, g, scale, t.n0, N);
  assign_block<XT>(x, z, smem + g.off_stage, smem + g.off_idx, g, metric,
                   nc, c, v, t.m0, t.mt, t.k0, t.kn, idx_rows(R));
  stamp(2);                            // assigned (1: x and z staged)
  sum_block<LT, R>(lut, scale, out, smem, g, c, N, t);
  stamp(6);                            // (3 gathered, 4 pushed, 5 barrier)
}

// Fixed cost of a block (assignment, partition and cluster sums) in
// units of one subspace's LUT rows, for plan's cluster-size estimate.
constexpr int FIXED_SUBSPACES = 16;

template <typename XT, typename LT, int R>
cudaError_t launch_r(const void* x, const void* z, const void* lut,
                     const float* scale, float* out, int M, int nc, int c,
                     int v, int N, int metric, cudaStream_t st, int* info) {
  const Shape s{M, nc, c, v, N, R,
                (uintptr_t)x % 16 == 0 && (uintptr_t)z % 16 == 0 &&
                    (v * sizeof(XT)) % 16 == 0,
                (uintptr_t)lut % 16 == 0 &&
                    ((size_t)N * sizeof(LT)) % 16 == 0};
  return launch_cluster<LT>(vq_amm_kernel<XT, LT, R>, FIXED_SUBSPACES, s,
                            st, info, static_cast<const XT*>(x),
                            static_cast<const XT*>(z),
                            static_cast<const LT*>(lut), scale, out, M, nc,
                            c, v, N, metric);
}

// Rows a thread sums: 1, 2 or 4 (up to 16, 32 or 64 rows a block).
template <typename XT, typename LT>
cudaError_t launch_lt(const void* x, const void* z, const void* lut,
                      const float* scale, float* out, int M, int nc, int c,
                      int v, int N, int metric, cudaStream_t st,
                      int* info) {
  const int rows = M < ROW_CAP ? M : ROW_CAP;
  if (rows <= SLOTS)
    return launch_r<XT, LT, 1>(x, z, lut, scale, out, M, nc, c, v, N,
                               metric, st, info);
  if (rows <= 2 * SLOTS)
    return launch_r<XT, LT, 2>(x, z, lut, scale, out, M, nc, c, v, N,
                               metric, st, info);
  return launch_r<XT, LT, 4>(x, z, lut, scale, out, M, nc, c, v, N, metric,
                             st, info);
}

template <typename XT>
cudaError_t launch_x(const void* x, const void* z, const void* lut,
                     const float* scale, float* out, int M, int nc, int c,
                     int v, int N, int lut_dtype, int metric,
                     cudaStream_t st, int* info) {
  if (lut_dtype == 2)
    return launch_lt<XT, int8_t>(x, z, lut, scale, out, M, nc, c, v, N,
                                 metric, st, info);
  if (lut_dtype == 0)
    return launch_lt<XT, float>(x, z, lut, scale, out, M, nc, c, v, N,
                                metric, st, info);
  return launch_lt<XT, __nv_bfloat16>(x, z, lut, scale, out, M, nc, c, v,
                                      N, metric, st, info);
}

}  // namespace

#ifdef VQG_PROFILE
// Where the phase timestamps go (16 int64 a block), or null for none.
extern "C" int vq_amm_set_prof(long long* p) {
  return (int)cudaMemcpyToSymbol(vqg_prof, &p, sizeof(p));
}
#endif

// x_dtype: 0 f32, 1 bf16. lut_dtype: 0 f32, 1 bf16, 2 int8.
// metric: 0 l2, 1 l1, 2 chebyshev. scale may be null. Enqueues one
// kernel on stream and nothing else; with info non-null it launches
// nothing and writes the launch's geometry (launch_r). Returns a
// cudaError_t.
extern "C" int vq_amm_launch(const void* x, const void* z, const void* lut,
                             const void* scale, void* out, int M, int nc,
                             int c, int v, int N, int x_dtype,
                             int lut_dtype, int metric, void* stream,
                             int* info) {
  if (M <= 0 || nc <= 0 || N <= 0 || c < 1 || c > 256 || v < 1 ||
      x_dtype < 0 || x_dtype > 1 || lut_dtype < 0 ||
      lut_dtype > 2 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  cudaError_t err = x_dtype == 0
      ? launch_x<float>(x, z, lut, sp, op, M, nc, c, v, N, lut_dtype,
                        metric, st, info)
      : launch_x<__nv_bfloat16>(x, z, lut, sp, op, M, nc, c, v, N,
                                lut_dtype, metric, st, info);
  return (int)err;
}
