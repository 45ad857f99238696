// Thread block clusters on Hopper (sm_90a), shared by the kernels that
// launch as grids of clusters: B1 and B4 (vq_gather.cuh: the split-K
// blocks of one column tile) and B2 and B5 in their fused form
// (flash_common.cuh: the splits of one slot and kv head).
//
// Device: the split cluster barrier (arrive.release / wait.acquire; the
// blocks of a cluster can do local work between the two; a wait counts
// the threads that have not exited), and stores into another rank's
// shared memory (mapa + st.async) that the receiver awaits on an
// mbarrier of its own. The barrier is the PTX instruction itself:
// cg::this_cluster().sync() compiles to a MEMBAR.ALL.GPU before it.
//
// Host: a launch configuration with the cluster-dimension attribute, the
// opt-in to clusters above the portable 8 blocks (Hopper takes 16) and
// to dynamic shared memory above 48 KB, and the card's occupancy report
// of how many such clusters it can hold at once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace clus {

constexpr int MAX_CLUSTER = 16;           // non-portable cluster size

__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// An arrival that orders no memory: "this block has started".
__device__ __forceinline__ void arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of p (this block's shared memory) in rank's shared memory.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// A store into another rank's shared memory (st.async) that completes 4
// bytes of the transaction on that rank's mbarrier: the receiver waits on
// its own barrier for the bytes, not on a cluster barrier.
__device__ __forceinline__ void store_async(uint32_t addr, float v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "f"(v), "r"(bar)
      : "memory");
}

// An mbarrier in this block's shared memory, for one arrival and a count
// of transaction bytes. init, then fence_init before any other rank may
// signal it (the cluster barrier's acquire on their side).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar))
               : "memory");
}
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The one arrival, expecting `bytes` of transactions (which may already
// have landed).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          (uint32_t)__cvta_generic_to_shared(bar)),
      "r"(bytes)
      : "memory");
}
// Wait for the barrier's first phase to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"((uint32_t)__cvta_generic_to_shared(bar))
      : "memory");
}

// Host: cfg launches grid in blocks of `threads`, clusters of `cluster`.
inline void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                   dim3 grid, int threads, dim3 cluster, size_t smem,
                   cudaStream_t st) {
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// Host: let kern take smem bytes of dynamic shared memory and clusters of
// up to MAX_CLUSTER blocks.
inline cudaError_t opt_in(const void* kern, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Host: clusters of cfg's shape the card holds at once; 0 for a shape it
// refuses (the error is cleared).
inline int max_active(const void* kern, const cudaLaunchConfig_t& cfg) {
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return active;
}

using FitKey = std::tuple<const void*, int, int, int, size_t>;
inline std::mutex fit_mutex;
inline std::map<FitKey, bool> fits;

// Host: launch kern(args...) over grid, in clusters of cs blocks along x,
// each block `threads` threads and smem bytes of dynamic shared memory.
// The first launch of a (kernel, device, cluster size, shared memory)
// opts the kernel in and asks the card whether it can hold one such
// cluster at all; the answer is cached. When it cannot, nothing launches
// and the error is cudaErrorInvalidConfiguration. With info non-null:
// write the cluster size, the clusters of the grid, the clusters the
// card holds at once, the shared memory and the registers a thread to
// info[0..4] and launch nothing.
template <typename... Params, typename... Args>
cudaError_t launch_x(void (*kern)(Params...), dim3 grid, int threads, int cs,
                     size_t smem, int smem_max, cudaStream_t st, int* info,
                     Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config(cfg, attr, grid, threads, dim3(cs, 1, 1), smem, st);
  const FitKey key{(const void*)kern, dev, cs, threads, smem};
  {
    std::lock_guard<std::mutex> lock(fit_mutex);
    auto it = fits.find(key);
    if (it == fits.end()) {
      err = opt_in((const void*)kern, smem_max);
      if (err != cudaSuccess) return err;
      it = fits.emplace(key, max_active((const void*)kern, cfg) > 0).first;
    }
    if (!it->second) return cudaErrorInvalidConfiguration;
  }
  if (info != nullptr) {
    cudaFuncAttributes attrs;
    err = cudaFuncGetAttributes(&attrs, (const void*)kern);
    if (err != cudaSuccess) return err;
    info[0] = cs;
    info[1] = (int)(grid.x / cs * grid.y * grid.z);
    info[2] = max_active((const void*)kern, cfg);
    info[3] = (int)smem;
    info[4] = attrs.numRegs;
    return cudaSuccess;
  }
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace clus
