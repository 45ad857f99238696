// Kernel B3: VQ centroid assignment (the CCM stage of the two-pass path)
// for Hopper (sm_90a), one launch a call.
//
// Replaces: src/repro/kernels/assign.py::vq_assign_pallas (body
// _assign_kernel), which lut_infer projections run under
// QuantConfig(fuse=False), before kernel B4.
//
//   idx[m, k] = argmin_j d(x[m, k, :], z[k, j, :])
//
//   x (M, nc, v) f32|bf16, z (nc, c, v) same type, idx (M, nc) int32;
//   or E such problems in one launch, each operand with a leading expert
//   axis (x (E, M, nc, v), z (E, nc, c, v), idx (E, M, nc)):
//   src/repro/models/moe.py::expert_proj runs vq_assign_pallas vmapped
//   over the experts under fuse=False.
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
//  * A grouped launch (E experts) is one grid: grid z is the expert, and
//    each block moves its operand pointers to its expert's (64-bit
//    offsets). At E = 1 it is the ungrouped launch.
//  * With live-row counts (a routed MoE layer's buffers, mostly empty at
//    decode: 48 pairs in 64 x 8 rows for deepseek-moe-16b) a block reads
//    its expert's count first, writes index 0 for the rows past it, and
//    assigns only the live rows; an expert with no live row costs its
//    blocks a count read and the zeros. The bound there is x's live rows,
//    z of the experts with one and the whole (E, M, nc) index tensor
//    (~1 us); the launch is one block's chain: a live block takes 32
//    subspaces (LIVE_SUBSPACES: 10.0-11.9 us against 10.6-17.0 at 64 and
//    12.3-13.9 at 16, PERF.md), staged in one round, each pair on
//    several threads (vq_gather.cuh, assign_split: the same distances and
//    tie rule, so the indices are still B1's).
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
// with live-row counts: at one or two live rows an expert, 32 subspaces
// a block measured fastest on an H100 (the header; PERF.md)
constexpr int LIVE_THREADS_A_PAIR = 4;
constexpr int LIVE_SUBSPACES = 32;

template <typename XT>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const XT* __restrict__ x, const XT* __restrict__ z,
              int* __restrict__ out, const long long* __restrict__ counts,
              int M, int nc, int c, int v, int metric, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned char* idx = smem + g.off_idx;
  const int e = blockIdx.z;
  const int k0 = blockIdx.x * g.kmax;
  const int kn = min(g.kmax, nc - k0);
  const int m0 = blockIdx.y * g.rows;
  const int mt = min(g.rows, M - m0);
  const int lt = live_rows(counts, e, m0, mt);
  const int rs = g.rows;
  out = expert_ptr(out, e, (size_t)M * nc);
  if (lt > 0) {
    x = expert_ptr(x, e, (size_t)M * nc * v);
    z = expert_ptr(z, e, (size_t)nc * c * v);
    assign_block<XT>(x, z, smem + g.off_stage, smem + g.off_idx, g, metric,
                     nc, c, v, m0, lt, k0, kn, rs);
  }
  // rows past the live ones take index 0
  for (int i = threadIdx.x; i < mt * kn; i += THREADS) {
    const int m = i / kn, kk = i % kn;
    out[(size_t)(m0 + m) * nc + k0 + kk] = m < lt ? idx[kk * rs + m] : 0;
  }
}

// Rows a live block is planned for: the call's most live rows (0: E x
// M) over the experts that can hold them, at least 1 and at most M.
inline int planned_rows(int E, int M, int most) {
  const long m = most > 0 ? most : (long)E * M;
  const long experts = m < E ? m : E;
  const long r = (m + experts - 1) / experts;
  return (int)(r < 1 ? 1 : r > M ? M : r);
}

// The block layout: rows and subspaces a block (kb, or the rule's when kb
// is 0), the subspaces staged at once and the shared memory. Without
// counts the rule takes THREADS / rows subspaces, at most
// BLOCK_SUBSPACES, staged within 48 KB; with counts it takes THREADS /
// (LIVE_THREADS_A_PAIR x the planned live rows), at most
// LIVE_SUBSPACES, so that a live block's pairs take several threads each
// (assign_split), all staged at once where max_smem allows. Returns
// false when no layout fits max_smem.
inline bool assign_geometry(Geometry& g, int E, int M, int nc, int c, int v,
                            int kb, Live lv, bool vec_x, int max_smem) {
  g = Geometry{};
  g.vec_x = vec_x;
  g.live = lv.counts != nullptr;
  for (int rows = M < ROW_CAP ? M : ROW_CAP; rows >= 1; rows /= 2) {
    int kmax = kb;
    if (kb == 0 && g.live) {
      const int r = planned_rows(E, M, lv.most);
      kmax = THREADS / (LIVE_THREADS_A_PAIR * (r < rows ? r : rows));
      if (kmax > LIVE_SUBSPACES) kmax = LIVE_SUBSPACES;
    } else if (kb == 0) {
      kmax = THREADS / rows;
      if (kmax > BLOCK_SUBSPACES) kmax = BLOCK_SUBSPACES;
    }
    if (kmax > nc) kmax = nc;
    g.rows = rows;
    g.kmax = kmax;
    g.off_idx = 0;
    g.off_stage = (int)up16((size_t)kmax * rows);
    const long room = (long)max_smem - g.off_stage;
    g.ka = staged_subspaces(kmax, rows, c, v,
                            g.live && room > STAGING_BYTES ? room
                                                           : STAGING_BYTES);
    const size_t smem = g.off_stage + staging_bytes(g.ka, rows, c, v);
    g.smem = (int)smem;
    if (smem <= (size_t)max_smem) return true;
  }
  return false;
}

// Host: the card's largest dynamic shared memory a block, and kern opted
// into it, once per kernel and device.
inline cudaError_t opt_in_max(const void* kern, int& max_smem) {
  static std::mutex mutex;
  static std::map<std::pair<const void*, int>, int> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  auto it = done.find({kern, dev});
  if (it != done.end()) {
    max_smem = it->second;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return err;
  done[{kern, dev}] = max_smem;
  return cudaSuccess;
}

template <typename XT>
cudaError_t launch_x(const void* x, const void* z, int* idx, int E, Live lv,
                     int M, int nc, int c, int v, int metric, int kb,
                     cudaStream_t st, int* info) {
  const bool vec_x = (uintptr_t)x % 16 == 0 && (uintptr_t)z % 16 == 0 &&
                     (v * sizeof(XT)) % 16 == 0;
  const void* kern = (const void*)assign_kernel<XT>;
  Geometry g;
  if (lv.counts != nullptr ||
      !assign_geometry(g, E, M, nc, c, v, kb, lv, vec_x, SMEM_DEFAULT)) {
    // live rows, or one subspace needs more than 48 KB: the card's maximum
    int max_smem = 0;
    const cudaError_t err = opt_in_max(kern, max_smem);
    if (err != cudaSuccess) return err;
    if (!assign_geometry(g, E, M, nc, c, v, kb, lv, vec_x, max_smem))
      return cudaErrorInvalidValue;
  }
  const dim3 grid((nc + g.kmax - 1) / g.kmax, (M + g.rows - 1) / g.rows,
                  E);
  if (grid.y > 65535 || E > 65535) return cudaErrorInvalidValue;
  if (info != nullptr) {
    info[0] = (int)grid.x; info[1] = (int)grid.y; info[2] = g.kmax;
    info[3] = g.rows; info[4] = g.smem;
    return cudaSuccess;
  }
  assign_kernel<XT><<<grid, THREADS, g.smem, st>>>(
      static_cast<const XT*>(x), static_cast<const XT*>(z), idx, lv.counts,
      M, nc, c, v, metric, g);
  return cudaGetLastError();
}

}  // namespace

// E experts (1: no expert axis), each with its own x (M, nc, v), z and
// (M, nc) int32 output idx, stored one after another. counts: null, or E
// int64 live-row counts (rows past an expert's count take index 0 and
// are not assigned); most_live: the most live rows the call can have in
// all, for the block layout (0: E x M). x_dtype: 0 f32, 1 bf16. metric:
// 0 l2, 1 l1, 2 chebyshev. kb: subspaces a block, or 0 for the rule's.
// Enqueues one kernel on stream and nothing else; with info non-null it
// launches nothing and writes the launch's k ranges, row groups (of one
// expert), subspaces a block, rows a block and shared memory bytes to
// info[0..4]. Returns a cudaError_t.
extern "C" int vq_assign_launch(const void* x, const void* z, void* idx,
                                int E, const void* counts, int most_live,
                                int M, int nc, int c, int v, int x_dtype,
                                int metric, int kb, void* stream,
                                int* info) {
  if (E <= 0 || M <= 0 || nc <= 0 || c < 1 || c > 256 || v < 1 ||
      x_dtype < 0 || x_dtype > 1 || metric < 0 || metric > 2 || kb < 0 ||
      most_live < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ip = static_cast<int*>(idx);
  const Live lv{static_cast<const long long*>(counts), most_live};
  const cudaError_t err =
      x_dtype == 0
          ? launch_x<float>(x, z, ip, E, lv, M, nc, c, v, metric, kb, st,
                            info)
          : launch_x<__nv_bfloat16>(x, z, ip, E, lv, M, nc, c, v, metric,
                                    kb, st, info);
  return (int)err;
}
