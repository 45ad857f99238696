// Kernel B4: LUT gather-accumulate GEMM (the IMM stage of the two-pass
// path) for Hopper (sm_90a), one launch a call.
//
// Replaces: src/repro/kernels/lut_gemm.py::lut_gemm_pallas (body
// _lut_gemm_kernel), which lut_infer projections run under
// QuantConfig(fuse=False), after kernel B3.
//
//   out[m, n] = scale[n] * sum_k lut[k, idx[m, k], n]
//
//   idx (M, nc) int32 in [0, c), lut (nc, c, N) f32|bf16|int8, scale (N,)
//   f32 or null, out (M, N) f32.
//
// What bounds it on the H100: bytes. It must read the index tensor and
// each LUT row that some index selects, once: at decode (M = 8, c = 16)
// about 40% of the table, one byte per entry in int8, for one integer
// add per byte -- the same LUT traffic as B1, plus the (M, nc) indices
// that the fused kernel never writes or reads.
//
// Design: kernel B1 (fused_amm.cu) with its assignment replaced by
// reading the indices in; everything else is B1's device and host code
// in vq_gather.cuh.
//  * One launch, one kernel: no memset, no work buffer, no second pass.
//    One block per (256-byte column tile, k range, group of up to 64
//    rows); the k ranges of one column tile form a thread block cluster
//    (grid y), its size picked per shape from the card's occupancy
//    report (vq_gather.cuh, plan) and cached.
//  * The block loads its (rows, k range) slice of idx with coalesced
//    4-byte loads, eight in flight a thread, into shared memory as uint8
//    (load_indices); the tile's scale columns come in by cp.async.
//  * Then B1's sum_block: each thread gathers its 16-byte column chunk of
//    the selected LUT rows into registers (16 loads in flight), sums in
//    subspace order (int8: dp4a into exact int32), pushes its partial
//    tile to the owning ranks (distributed shared memory, one cluster
//    barrier), and each rank sums its share in rank order, scales and
//    writes out. No atomic: float results are the same on every launch;
//    an int8 result is (float)(int32 sum) * scale[n], B1's expression,
//    so B4(B3(x)) == B1(x) bit for bit on int8 LUTs, and on float LUTs
//    wherever this launch's cluster size and partitions are B1's.
//  * The general path lives in the same kernel: any M (row groups in grid
//    z), c up to 256, ragged nc and N (masked), and LUTs whose rows are
//    not 16-byte aligned (element loads).

#include "vq_gather.cuh"

namespace {

using namespace vqg;

template <typename LT, int R>
__global__ void __launch_bounds__(THREADS)
lut_gemm_kernel(const int* __restrict__ idx, const LT* __restrict__ lut,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int nc, int c, int N, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of<LT>(g, M, nc);
  copy_scale<LT>(smem, g, scale, t.n0, N);
  load_indices(idx, smem + g.off_idx, nc, t, idx_rows(R));
  sum_block<LT, R>(lut, scale, out, smem, g, c, N, t);
}

// Fixed cost of a block (index load, partition and cluster sums) in
// units of one subspace's LUT rows, for plan's cluster-size estimate:
// B1's measured cycles for the push, cluster barrier and finish plus one
// index load, against its gather's cycles a subspace (L2 flushed). The
// flushed nc sweep at one cluster size reads far higher (~75), but that
// intercept holds the launch too; no main-path shape's cluster size
// changes between the two (PERF.md).
constexpr int FIXED_SUBSPACES = 12;

template <typename LT, int R>
cudaError_t launch_r(const int* idx, const void* lut, const float* scale,
                     float* out, int M, int nc, int c, int N,
                     cudaStream_t st, int* info) {
  const Shape s{M, nc, c, 0, N, R, false,
                (uintptr_t)lut % 16 == 0 &&
                    ((size_t)N * sizeof(LT)) % 16 == 0};
  return launch_cluster<LT>(lut_gemm_kernel<LT, R>, FIXED_SUBSPACES, s, st,
                            info, idx, static_cast<const LT*>(lut), scale,
                            out, M, nc, c, N);
}

// Rows a thread sums: 1, 2 or 4 (up to 16, 32 or 64 rows a block).
template <typename LT>
cudaError_t launch_lt(const int* idx, const void* lut, const float* scale,
                      float* out, int M, int nc, int c, int N,
                      cudaStream_t st, int* info) {
  const int rows = M < ROW_CAP ? M : ROW_CAP;
  if (rows <= SLOTS)
    return launch_r<LT, 1>(idx, lut, scale, out, M, nc, c, N, st, info);
  if (rows <= 2 * SLOTS)
    return launch_r<LT, 2>(idx, lut, scale, out, M, nc, c, N, st, info);
  return launch_r<LT, 4>(idx, lut, scale, out, M, nc, c, N, st, info);
}

}  // namespace

// lut_dtype: 0 f32, 1 bf16, 2 int8. scale may be null. Enqueues one
// kernel on stream and nothing else; with info non-null it launches
// nothing and writes the launch's geometry (vq_gather.cuh,
// launch_cluster). Returns a cudaError_t.
extern "C" int lut_gemm_launch(const void* idx, const void* lut,
                               const void* scale, void* out, int M, int nc,
                               int c, int N, int lut_dtype, void* stream,
                               int* info) {
  if (M <= 0 || nc <= 0 || N <= 0 || c < 1 || c > 256 || lut_dtype < 0 ||
      lut_dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  cudaError_t err;
  if (lut_dtype == 2)
    err = launch_lt<int8_t>(ip, lut, sp, op, M, nc, c, N, st, info);
  else if (lut_dtype == 0)
    err = launch_lt<float>(ip, lut, sp, op, M, nc, c, N, st, info);
  else
    err = launch_lt<__nv_bfloat16>(ip, lut, sp, op, M, nc, c, N, st, info);
  return (int)err;
}
