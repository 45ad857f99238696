// Kernel B1: fused VQ-AMM (nearest-centroid assignment + LUT
// gather-accumulate) for Hopper (sm_90a), one launch a call.
//
// Replaces: src/repro/kernels/fused_amm.py::vq_amm_pallas (body
// _fused_kernel), the TPU kernel behind every lut_infer projection.
//
//   out[m, n] = scale[n] * sum_k lut[k, argmin_j d(x[m, k, :], z[k, j, :]), n]
//
//   x (M, nc, v) f32|bf16, z (nc, c, v) same type, lut (nc, c, N)
//   f32|bf16|int8, scale (N,) f32 or null, out (M, N) f32; or E such
//   problems in one launch, each operand with a leading expert axis
//   (x (E, M, nc, v), ..., out (E, M, N)): the per-expert projections of
//   an MoE layer, which src/repro/models/moe.py::expert_proj runs as
//   vq_amm_pallas vmapped over the experts (one pallas_call with the
//   expert as one more grid axis).
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
//    132 SMs at every dense main-path shape. The choice is cached per
//    shape.
//  * A grouped launch (E experts) is one grid: grid z holds E x the row
//    groups, and each block moves its operand pointers to its expert's
//    (64-bit offsets). Without counts the cluster-size estimate counts the
//    clusters of all E experts, so at E = 64 and M = 8 it picks far
//    smaller clusters (often 1: the grid already fills the card) than at
//    E = 1. At E = 1 the launch is the ungrouped one, bit for bit.
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
//
// Live rows (a routed MoE layer's grouped call with counts, E int64 live
// rows an expert, the pairs the router kept in each capacity buffer).
// At decode most buffer rows are empty: deepseek-moe-16b's routed
// experts hold at most 48 pairs in 64 x 8 rows, dbrx-132b's 32 in 16 x
// 8. What bounds the call there is the bytes the live rows need: their
// LUT rows (at most 48 x 256 x 1408 B = 17.3 MB for routed wg/wu, 6.7 us
// at 3.35 TB/s) and the whole output (2.9 MB, the empty rows' zeros
// included). The k-split layout above spends its time elsewhere: every
// column tile's cluster re-stages and re-assigns the same one or two rows
// and the grid runs in waves of short dependent chains (PERF.md:
// 59 us, 1536 blocks starting over 52 us). So with counts:
//  * A block reads its expert's count first; rows past it are written
//    0.0 and never touched again, and a row group with no live row writes
//    its zeros and returns before any cluster barrier (every rank of a
//    cluster holds one expert and row group).
//  * Up to 16 rows (the decode buffers), tile clusters (vq_gather.cuh):
//    a cluster spans up to 8 column tiles, rank r assigns 1 / tcs of the
//    subspaces and stores its indices into every rank's shared memory
//    over DSMEM, and each block gathers all subspaces of its own tile and
//    writes its rows out: no cross-block sum, one assignment per expert.
//  * A live block spreads its 16 row slots over its lt live rows (16 / lt
//    k partitions), so every warp gathers with 16 loads in flight a
//    thread; the partitions meet in a parallel pass in partition order.
//  * Few (row, subspace) pairs take several threads each (assign_split:
//    vq_common.cuh's distances, the lowest index wins a tie), and a
//    block stages its subspaces in one round.
//  * The planner sizes the launch over the row groups that can be live,
//    min(E x groups, most_live = T x k), not over all E experts.
//  Live rows are the launch without counts bit for bit on int8 LUTs.

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

// LIVE: the launch takes live-row counts (compiled on its own, so a launch
// without them runs the code it ran before counts existed: the flushed
// time of a launch grew ~9 us when one kernel held both, PERF.md).
template <typename XT, typename LT, int R, bool LIVE>
__global__ void __launch_bounds__(THREADS)
vq_amm_kernel(const XT* __restrict__ x, const XT* __restrict__ z,
              const LT* __restrict__ lut, const float* __restrict__ scale,
              float* __restrict__ out, const long long* __restrict__ counts,
              int M, int nc, int c, int v, int N, int metric, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of<LT>(g, M, nc, LIVE ? counts : nullptr);
  out = expert_ptr(out, t.e, (size_t)M * N);
  if constexpr (LIVE) {
    zero_dead_rows<LT>(out, g, N, t);
    if (t.lt == 0) return;  // every rank of the cluster: no barrier met
  }
  x = expert_ptr(x, t.e, (size_t)M * nc * v);
  z = expert_ptr(z, t.e, (size_t)nc * c * v);
  lut = expert_ptr(lut, t.e, (size_t)nc * c * N);
  scale = expert_ptr(scale, t.e, (size_t)N);
  if constexpr (LIVE && R == 1) {
    if (g.tcs) {            // tile clusters (live rows, vq_gather.cuh)
      stamp(0);
      tile_block<XT, LT>(x, z, lut, scale, out, smem, g, nc, c, v, N,
                         metric, t);
      stamp(6);
      return;
    }
  }
  stamp(0);
  copy_scale<LT>(smem, g, scale, t.n0, N);
  assign_block<XT, LIVE>(x, z, smem + g.off_stage, smem + g.off_idx, g,
                         metric, nc, c, v, t.m0, t.lt, t.k0, t.kn,
                         idx_rows(R));
  stamp(2);                            // assigned (1: x and z staged)
  sum_block<LT, R, LIVE>(lut, scale, out, smem, g, c, N, t);
  stamp(6);                            // (3 gathered, 4 pushed, 5 barrier)
}

// Fixed cost of a block (assignment, partition and cluster sums) in
// units of one subspace's LUT rows, for plan's cluster-size estimate.
constexpr int FIXED_SUBSPACES = 16;

template <typename XT, typename LT, int R>
cudaError_t launch_r(const void* x, const void* z, const void* lut,
                     const float* scale, float* out, int E, Live lv, int M,
                     int nc, int c, int v, int N, int metric, int cluster,
                     cudaStream_t st, int* info) {
  const Shape s{E, M, nc, c, v, N, R,
                (uintptr_t)x % 16 == 0 && (uintptr_t)z % 16 == 0 &&
                    (v * sizeof(XT)) % 16 == 0,
                (uintptr_t)lut % 16 == 0 &&
                    ((size_t)N * sizeof(LT)) % 16 == 0,
                lv.counts != nullptr, lv.most, cluster};
  auto kern = lv.counts != nullptr ? vq_amm_kernel<XT, LT, R, true>
                                   : vq_amm_kernel<XT, LT, R, false>;
  return launch_cluster<LT>(kern, FIXED_SUBSPACES, s,
                            st, info, static_cast<const XT*>(x),
                            static_cast<const XT*>(z),
                            static_cast<const LT*>(lut), scale, out,
                            lv.counts, M, nc, c, v, N, metric);
}

// Rows a thread sums: 1, 2 or 4 (up to 16, 32 or 64 rows a block).
template <typename XT, typename LT>
cudaError_t launch_lt(const void* x, const void* z, const void* lut,
                      const float* scale, float* out, int E, Live lv, int M,
                      int nc, int c, int v, int N, int metric, int cluster,
                      cudaStream_t st, int* info) {
  const int rows = M < ROW_CAP ? M : ROW_CAP;
  if (rows <= SLOTS)
    return launch_r<XT, LT, 1>(x, z, lut, scale, out, E, lv, M, nc, c, v,
                               N, metric, cluster, st, info);
  if (rows <= 2 * SLOTS)
    return launch_r<XT, LT, 2>(x, z, lut, scale, out, E, lv, M, nc, c, v,
                               N, metric, cluster, st, info);
  return launch_r<XT, LT, 4>(x, z, lut, scale, out, E, lv, M, nc, c, v, N,
                             metric, cluster, st, info);
}

template <typename XT>
cudaError_t launch_x(const void* x, const void* z, const void* lut,
                     const float* scale, float* out, int E, Live lv, int M,
                     int nc, int c, int v, int N, int lut_dtype, int metric,
                     int cluster, cudaStream_t st, int* info) {
  if (lut_dtype == 2)
    return launch_lt<XT, int8_t>(x, z, lut, scale, out, E, lv, M, nc, c, v,
                                 N, metric, cluster, st, info);
  if (lut_dtype == 0)
    return launch_lt<XT, float>(x, z, lut, scale, out, E, lv, M, nc, c, v,
                                N, metric, cluster, st, info);
  return launch_lt<XT, __nv_bfloat16>(x, z, lut, scale, out, E, lv, M, nc,
                                      c, v, N, metric, cluster, st, info);
}

}  // namespace

#ifdef VQG_PROFILE
// Where the phase timestamps go (16 int64 a block), or null for none.
extern "C" int vq_amm_set_prof(long long* p) {
  return (int)cudaMemcpyToSymbol(vqg_prof, &p, sizeof(p));
}
#endif

// E experts (1: no expert axis), each with its own x (M, nc, v), z, lut
// and scale, stored one after another. counts: null, or E int64 live-row
// counts (rows past an expert's count come out 0.0 and are not
// computed); most_live: the most live rows the call can have in all, for
// the planner (0: E x M). x_dtype: 0 f32, 1 bf16. lut_dtype: 0 f32,
// 1 bf16, 2 int8. metric: 0 l2, 1 l1, 2 chebyshev. scale may be null.
// cluster: the layout a sweep asks for, k splits (1-16) or -tiles of a
// tile cluster (-1 to -8, live rows only), or 0 for the planner's. Enqueues one kernel on stream and nothing else; with info
// non-null it launches nothing and writes the launch's geometry
// (launch_cluster). Returns a cudaError_t.
extern "C" int vq_amm_launch(const void* x, const void* z, const void* lut,
                             const void* scale, void* out, int E,
                             const void* counts, int most_live, int M,
                             int nc, int c, int v, int N, int x_dtype,
                             int lut_dtype, int metric, int cluster,
                             void* stream, int* info) {
  if (E <= 0 || M <= 0 || nc <= 0 || N <= 0 || c < 1 || c > 256 || v < 1 ||
      x_dtype < 0 || x_dtype > 1 || lut_dtype < 0 ||
      lut_dtype > 2 || metric < 0 || metric > 2 || most_live < 0 ||
      cluster < -TILE_CLUSTER || cluster > MAX_CLUSTER ||
      (cluster < 0 && counts == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  const Live lv{static_cast<const long long*>(counts), most_live};
  cudaError_t err = x_dtype == 0
      ? launch_x<float>(x, z, lut, sp, op, E, lv, M, nc, c, v, N, lut_dtype,
                        metric, cluster, st, info)
      : launch_x<__nv_bfloat16>(x, z, lut, sp, op, E, lv, M, nc, c, v, N,
                                lut_dtype, metric, cluster, st, info);
  return (int)err;
}
