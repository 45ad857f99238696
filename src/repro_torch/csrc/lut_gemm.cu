// Kernel B4: LUT gather-accumulate GEMM (the IMM stage of the two-pass
// path) for Hopper (sm_90a).
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
// Design: the first version of B1's gather-accumulate (vq_common.cuh,
// lut_tile) with the indices read in. One block per (128-column tile,
// group of ks subspaces, 8-row tile); the nc subspaces are split across
// blocks by split_width, so M = 8 still puts ~2 blocks on each of the 132
// SMs. For int8 LUTs the partial sums meet with atomics in an (M, N)
// int32 accumulator (exact and order-free). For float LUTs each block
// stores its tile into its split's slice of a (splits, M, N) fp32 buffer
// and the finish kernel sums the splits in split order, so no float
// atomic decides the last bits: the same input gives the same output on
// every run, as the TPU kernel's sequential k axis does. The block loads
// its tile of indices into shared memory (uint8, c <= 256); the scale is
// applied once at the end by the finish kernel. For int8 LUTs the output
// is (float)(exact int32 sum) * scale, the expression B1 writes, so
// B4(B3(x)) equals B1(x) bit for bit (float LUTs: not in general, the two
// sum in different orders). Ragged M, nc and N are masked; nothing is
// padded.

#include "vq_common.cuh"

namespace {

using namespace vqc;

template <typename LT, typename AccT>
__global__ void __launch_bounds__(THREADS)
lut_gemm_kernel(const int* __restrict__ idx, const LT* __restrict__ lut,
                AccT* __restrict__ acc, int M, int nc, int c, int N, int ks,
                int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  AccT* red = reinterpret_cast<AccT*>(smem);                    // [BM][BN]
  unsigned char* sidx = reinterpret_cast<unsigned char*>(red + BM * BN);
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * ks;
  const int m0 = blockIdx.z * BM;
  const int kn = min(ks, nc - k0);
  const int mn = min(BM, M - m0);
  for (int i = threadIdx.x; i < mn * kn; i += THREADS) {
    const int mi = i / kn, kk = i % kn;
    sidx[mi * ks + kk] =
        (unsigned char)idx[(size_t)(m0 + mi) * nc + k0 + kk];
  }
  // lut_tile's first barrier (after it zeroes red) publishes sidx
  lut_tile<LT, AccT>(lut, sidx, red, split_slice(acc, M, N), c, N, ks, m0,
                     mn, k0, kn, n0, vec_ok);
}

// Subspaces per block: the split rule, cut until the tile and the
// indices fit (4-byte accumulators for every LUT type).
inline int block_width(int M, int nc, int N) {
  int ks = split_width(M, nc, N);
  while (ks > 1 && 4 * BM * BN + (size_t)BM * ks > MAX_SMEM) --ks;
  return ks;
}

template <typename LT, typename AccT>
cudaError_t launch_typed(const int* idx, const void* lut, AccT* acc, int M,
                         int nc, int c, int N, int ks, cudaStream_t st) {
  const size_t smem = sizeof(AccT) * BM * BN + (size_t)BM * ks;
  const int vec_ok = (N % VEC == 0) && ((uintptr_t)lut % 16 == 0);
  const dim3 grid((N + BN - 1) / BN, (nc + ks - 1) / ks, (M + BM - 1) / BM);
  lut_gemm_kernel<LT, AccT><<<grid, THREADS, smem, st>>>(
      idx, static_cast<const LT*>(lut), acc, M, nc, c, N, ks, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// Split-K blocks of a call at these shapes: the float-LUT work buffer
// holds one (M, N) tile per split.
extern "C" int lut_gemm_splits(int M, int nc, int N) {
  if (M <= 0 || nc <= 0 || N <= 0) return 0;
  const int ks = block_width(M, nc, N);
  return (nc + ks - 1) / ks;
}

// lut_dtype: 0 f32, 1 bf16, 2 int8. scale may be null. work is the
// split-K accumulator: (M, N) int32 for int8 LUTs, (lut_gemm_splits(...),
// M, N) float32 for float LUTs. Returns a cudaError_t.
extern "C" int lut_gemm_launch(const void* idx, const void* lut,
                               const void* scale, void* out, void* work,
                               int M, int nc, int c, int N, int lut_dtype,
                               void* stream) {
  if (M <= 0 || nc <= 0 || N <= 0 || c < 1 || c > 256 || lut_dtype < 0 ||
      lut_dtype > 2 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  float* fw = static_cast<float*>(work);
  const int ks = block_width(M, nc, N);
  cudaError_t err = zero_acc(lut_dtype, work, M, N, st);
  if (err != cudaSuccess) return (int)err;
  if (lut_dtype == 2)
    err = launch_typed<int8_t, int>(ip, lut, static_cast<int*>(work), M, nc,
                                    c, N, ks, st);
  else if (lut_dtype == 0)
    err = launch_typed<float, float>(ip, lut, fw, M, nc, c, N, ks, st);
  else
    err = launch_typed<__nv_bfloat16, float>(ip, lut, fw, M, nc, c, N, ks,
                                             st);
  if (err != cudaSuccess) return (int)err;
  return (int)finish(lut_dtype, sp, op, work, M, N, (nc + ks - 1) / ks,
                     st);
}
