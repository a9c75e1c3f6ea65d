// Pareto dominance-count kernels for Hopper (sm_90a), plain C interface.
//
// Point j dominates point i iff obj[:, j] <= obj[:, i] on every objective
// and obj[:, j] < obj[:, i] on at least one (all objectives minimized).
// Objectives arrive feature-major, (D, N) contiguous float64, N padded by
// the caller with +inf points (a +inf point dominates nothing and adds 0
// to every real count).  Compares stay in float64: a narrower type could
// merge distinct values and drop a true front point.
//
// K1  pf_block_dominance_counts replaces the Pallas TPU kernel
//     repro/kernels/pareto_front/kernel.py::block_dominance_counts_pallas
//     (_block_kernel): for each point, the number of points of its own
//     block that dominate it.  counts == 0 is the block-decomposed front
//     superset the fused sweep prefilters with.  One CUDA block per point
//     block, one thread per point; the block's D x B values sit in shared
//     memory and every thread walks all of them.  Each thread reads the
//     same shared word in the same step, a broadcast with no bank
//     conflicts.  Bound: at one sweep chunk (D = 3, N = 65,536, B = 128)
//     the kernel moves 65,536 * (3 * 8 + 4) = 1.8 MB and does N * B = 8.4M
//     point pairs of 2 * D compares each, 50M float64 compares; the
//     compares bound it.  The design keeps every operand but the thread's
//     own point in shared memory, so device memory is read once per input
//     and written once per output.  On this card the launch and the loads
//     and stores alone take a large share of its time, and the pair loop
//     costs the same whether a thread owns 1, 2 or 4 points (fewer shared
//     reads) or the values are first replaced by their ranks in the block
//     (half the float64 compares, then tests of packed ranks or bit masks,
//     which cost as many issue slots as they save and add phases): those
//     designs, in scripts/k1_designs.cu, were no faster (PERF.md;
//     scripts/kernel_variants.py times them), so this one stays.
//
// K2  pf_dominance_counts replaces
//     repro/kernels/pareto_front/kernel.py::dominance_counts_pallas
//     (_pairwise_kernel): global O(N^2) dominance counts.  The TPU walks
//     the j tiles on a sequential grid axis and accumulates in the output
//     tile.  Bound: N^2 point pairs of 2 * D compares each (D = 3, N =
//     4,096: 100M float64 compares, 0.003 ms at the 34 TFLOP/s float64
//     rate); bytes are negligible.  N / 256 blocks, one a 256-point i
//     tile, fill few of the 132 SMs at the survivor cap (16 at N = 4,096),
//     so the grid is (N / 256 i tiles) x (splits of the j tiles), the
//     splits chosen by the caller (kernel.py's pair_splits: at least two
//     blocks an SM); a block counts
//     its i tile against its own j range, staging each j tile through
//     shared memory and keeping its thread's count in a register, and
//     adds it to the zeroed counts with one integer atomicAdd, exact and
//     order-free, so every run gives the same counts.  What holds it back
//     is in PERF.md (section 6).
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPairTile = 256;

template <int D>
__device__ __forceinline__ int dominates(const double* tile, int stride,
                                         int j, const double* mine) {
  bool le = true;
  bool lt = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const double y = tile[d * stride + j];
    le = le && (y <= mine[d]);
    lt = lt || (y < mine[d]);
  }
  return (le && lt) ? 1 : 0;
}

template <int D>
__global__ void block_dominance_kernel(const double* __restrict__ obj,
                                       int64_t n,
                                       int32_t* __restrict__ counts) {
  extern __shared__ double tile[];  // D x blockDim.x
  const int b = blockDim.x;
  const int t = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * b + t;
  double mine[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    mine[d] = obj[d * n + i];
    tile[d * b + t] = mine[d];
  }
  __syncthreads();
  int32_t c = 0;
  for (int j = 0; j < b; ++j) c += dominates<D>(tile, b, j, mine);
  counts[i] = c;
}

template <int D>
__global__ void pairwise_dominance_kernel(const double* __restrict__ obj,
                                          int64_t n, int64_t splits,
                                          int32_t* __restrict__ counts) {
  __shared__ double tile[D * kPairTile];
  const int t = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPairTile + t;
  const int64_t tiles = n / kPairTile, s = blockIdx.y;
  const int64_t first = tiles * s / splits, last = tiles * (s + 1) / splits;
  double mine[D];
#pragma unroll
  for (int d = 0; d < D; ++d) mine[d] = obj[d * n + i];
  int32_t c = 0;
  for (int64_t jt = first; jt < last; ++jt) {
    __syncthreads();  // the previous j tile is fully consumed
#pragma unroll
    for (int d = 0; d < D; ++d)
      tile[d * kPairTile + t] = obj[d * n + jt * kPairTile + t];
    __syncthreads();
    for (int j = 0; j < kPairTile; ++j)
      c += dominates<D>(tile, kPairTile, j, mine);
  }
  if (c) atomicAdd(counts + i, c);
}

}  // namespace

extern "C" {

// obj (d, n) float64 with n a multiple of block, 1 <= block <= 1024,
// d in {2, 3, 4} -> counts (n,) int32.
int pf_block_dominance_counts(const double* obj, int64_t d, int64_t n,
                              int64_t block, int32_t* counts, void* stream) {
  if (block < 1 || block > 1024 || n % block != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n / block));
  const dim3 threads(static_cast<unsigned>(block));
  const size_t smem = static_cast<size_t>(d) * block * sizeof(double);
  switch (d) {
    case 2: block_dominance_kernel<2><<<grid, threads, smem, s>>>(obj, n, counts); break;
    case 3: block_dominance_kernel<3><<<grid, threads, smem, s>>>(obj, n, counts); break;
    case 4: block_dominance_kernel<4><<<grid, threads, smem, s>>>(obj, n, counts); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// obj (d, n) float64 with n a multiple of 256, d in {2, 3, 4}, the j
// tiles split over 1 <= splits blocks (at most n / 256 are used)
// -> counts (n,) int32, zeroed here and then added to.
int pf_dominance_counts(const double* obj, int64_t d, int64_t n,
                        int64_t splits, int32_t* counts, void* stream) {
  if (n % kPairTile != 0 || splits < 1) return cudaErrorInvalidValue;
  if (d < 2 || d > 4) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = n / kPairTile;
  const int64_t sp = splits < tiles ? splits : tiles;
  if (sp > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * n, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(sp));
  switch (d) {
    case 2: pairwise_dominance_kernel<2><<<grid, kPairTile, 0, s>>>(obj, n, sp, counts); break;
    case 3: pairwise_dominance_kernel<3><<<grid, kPairTile, 0, s>>>(obj, n, sp, counts); break;
    case 4: pairwise_dominance_kernel<4><<<grid, kPairTile, 0, s>>>(obj, n, sp, counts); break;
  }
  return cudaGetLastError();
}

}  // extern "C"
