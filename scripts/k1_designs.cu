// Designs of K1 (block dominance counts) tried for Hopper beside the
// kernel the package ships (src/repro_torch/kernels/pareto_front/csrc/
// pareto_front.cu: one thread a point, 2 D float64 compares a pair), timed
// by scripts/kernel_variants.py and not used by the package.  Both entries
// take the shipped entry's arguments.
//
// k1_points: the same pair tests, but a thread owns kPointsPerThread
// points of the block, so each shared read of a point serves that many
// tests, and kLanesPerPoint lanes split the block's j between them and add
// their counts over shuffles, which keeps as many warps in flight as one
// thread a point did.
//
// k1_ranks: each objective is replaced by its rank in the block, the number
// of the block's values strictly below it (D * B float64 compares a point,
// half of a direct test's 2 * D * B); ranks keep every <= and < among the
// block's values exactly.  A thread owns kRankPoints points and kRankLanes
// lanes split the block's j, adding their ranks over shuffles.  Then:
//  * blocks up to kMaskMaxBlock count with bit masks: eq[d][r] holds the
//    points of rank r on objective d, le[d][r] (an OR scan over r) those of
//    rank <= r, and a point's dominators are popc(AND_d le[d][rank_d]) -
//    popc(AND_d eq[d][rank_d]);
//  * larger blocks (or kMaskMaxBlock = 0) pack the D ranks into one word,
//    8-bit lanes to 128 points and 16-bit lanes above, and test pairs:
//    with the top bit G of every lane clear, ((Pi | G) - Pj) & G == G says
//    rank_j <= rank_i on every lane at once, and Pj != Pi then says < on
//    at least one.
// In both, a point with a NaN dominates nothing and nothing dominates it
// (a NaN compares false both ways); the ranks leave it out of the masks,
// pack it as the largest rank on every lane, and count it 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPointsPerThread = 4;  // points of a block a thread owns ...
constexpr int kLanesPerPoint = 4;    // ... and the lanes that split its j
static_assert(kLanesPerPoint <= kPointsPerThread && 32 % kLanesPerPoint == 0,
              "a block of 1,024 points needs at most 1,024 threads");

// whether point y dominates point mine
template <int D>
__device__ __forceinline__ int dominates_point(const double (&y)[D],
                                               const double (&mine)[D]) {
  bool le = true;
  bool lt = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    le = le && (y[d] <= mine[d]);
    lt = lt || (y[d] < mine[d]);
  }
  return (le && lt) ? 1 : 0;
}

// Points [i * block, (i + 1) * block) of obj (D, n), one CUDA block of
// whole warps: thread t is lane t % S of point group t / S, which owns
// points g, g + G, ..., g + (P - 1) G of the block (G = ceil(block / P));
// its S lanes split the block's j between them and add up over shuffles.
template <int D>
__global__ void block_points_kernel(const double* __restrict__ obj,
                                       int64_t n, int block,
                                       int32_t* __restrict__ counts) {
  constexpr int P = kPointsPerThread, S = kLanesPerPoint;
  extern __shared__ double vals[];  // D x block
  const int t = threadIdx.x, lane = t % S, group = t / S;
  const int G = (block + P - 1) / P;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  for (int e = t; e < D * block; e += blockDim.x)
    vals[e] = obj[(e / block) * n + base + e % block];
  __syncthreads();

  int idx[P];
  double mine[P][D];
  int32_t c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    idx[p] = group < G && group + p * G < block ? group + p * G : -1;
#pragma unroll
    for (int d = 0; d < D; ++d)
      mine[p][d] = idx[p] >= 0 ? vals[d * block + idx[p]] : 0.0;
    c[p] = 0;
  }
#pragma unroll 4
  for (int j = lane; j < block; j += S) {
    double y[D];
#pragma unroll
    for (int d = 0; d < D; ++d) y[d] = vals[d * block + j];
#pragma unroll
    for (int p = 0; p < P; ++p) c[p] += dominates_point<D>(y, mine[p]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int o = 1; o < S; o <<= 1)
      c[p] += __shfl_xor_sync(0xffffffffu, c[p], o);
    if (idx[p] >= 0 && lane == 0) counts[base + idx[p]] = c[p];
  }
}

constexpr int kRankPoints = 2;  // points of a block a thread owns ...
constexpr int kRankLanes = 2;   // ... and the lanes that share them
constexpr int kMaskMaxBlock = 128;   // blocks up to it: rank bit masks
static_assert(kRankLanes <= kRankPoints && 32 % kRankLanes == 0,
              "a block of 1024 points needs at most 1024 threads");

// D ranks a word: 8-bit lanes in 32 bits, or 16-bit lanes in 64 bits
template <typename Word>
struct Lanes {
  static constexpr int kBits = 8 * sizeof(Word) / 4;
  static constexpr Word kTop = Word(1) << (kBits - 1);
  static constexpr Word kMax = kTop - 1;  // the largest rank a lane holds
  template <int D>
  __host__ __device__ static constexpr Word fill(Word lane) {
    Word w = 0;
    for (int d = 0; d < D; ++d) w |= lane << (d * kBits);
    return w;
  }
};

// Shared memory of one point block: the D x block values and the D x
// block ranks, then (16-byte aligned) either the two tables of rank masks
// (kMasks: D x block x 4 words each) or the block's packed rank words.
template <int D>
__host__ __device__ constexpr size_t tables_at(int block) {
  return (static_cast<size_t>(block) * D * (sizeof(double) + sizeof(int))
          + 15) / 16 * 16;
}

template <int D, bool kMasks, typename Word>
__host__ __device__ constexpr size_t block_smem(int block) {
  return tables_at<D>(block)
         + static_cast<size_t>(block)
               * (kMasks ? 2 * D * 4 * sizeof(uint32_t) : sizeof(Word));
}

// r += 1 where y < v: the float64 compare and a predicated float32 add,
// which issues on the float32 pipe (counts to 1,024 are exact)
__device__ __forceinline__ void count_below(float& r, double y, double v) {
  asm("{\n .reg .pred p;\n setp.lt.f64 p, %1, %2;\n"
      " @p add.f32 %0, %0, 0f3F800000;\n}"
      : "+f"(r) : "d"(y), "d"(v));
}

// Points [i * block, (i + 1) * block) of obj (D, n), one CUDA block of
// whole warps.  Ranks: thread t is lane t % S of point group t / S, which
// owns points g, g + G, ..., g + (P - 1) G of the block (G = ceil(block /
// P)); its S lanes split the block's j between them and add up over
// shuffles.  Counts: thread t takes points t, t + blockDim.x, ...
template <int D, bool kMasks, typename Word>
__global__ void block_rank_dominance_kernel(const double* __restrict__ obj,
                                            int64_t n, int block,
                                            int32_t* __restrict__ counts) {
  using L = Lanes<Word>;
  constexpr int P = kRankPoints, S = kRankLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  double* vals = reinterpret_cast<double*>(smem);     // D x block
  int* ranks = reinterpret_cast<int*>(vals + D * block);  // -1: a NaN
  uint32_t* eq = reinterpret_cast<uint32_t*>(smem + tables_at<D>(block));
  uint32_t* le = eq + D * block * 4;
  Word* words = reinterpret_cast<Word*>(eq);
  const int t = threadIdx.x, lane = t % S, group = t / S;
  const int G = (block + P - 1) / P;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  for (int e = t; e < D * block; e += blockDim.x)
    vals[e] = obj[(e / block) * n + base + e % block];
  if (kMasks)
    for (int e = t; e < D * block * 4; e += blockDim.x) eq[e] = 0;
  __syncthreads();

  int idx[P];
  double v[P][D];
  float rank[P][D];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    idx[p] = group < G && group + p * G < block ? group + p * G : -1;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      v[p][d] = idx[p] >= 0 ? vals[d * block + idx[p]] : 0.0;
      rank[p][d] = 0.f;
    }
  }
  // ranks: the block's values strictly below each of the points' values
#pragma unroll 4
  for (int j = lane; j < block; j += S) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const double y = vals[d * block + j];
#pragma unroll
      for (int p = 0; p < P; ++p) count_below(rank[p][d], y, v[p][d]);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    bool nan = false;
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int o = 1; o < S; o <<= 1)
        rank[p][d] += __shfl_xor_sync(0xffffffffu, rank[p][d], o);
      nan = nan || v[p][d] != v[p][d];
    }
    if (idx[p] >= 0 && lane == 0)
#pragma unroll
      for (int d = 0; d < D; ++d)
        ranks[d * block + idx[p]] = nan ? -1 : static_cast<int>(rank[p][d]);
  }
  __syncthreads();

  if (kMasks) {
    // eq[d][r]: the points (not NaN) of rank r on objective d, a word of
    // 32 points at a time: the lanes of equal rank agree on their bits
    const int warp = t / 32, wl = t % 32;
    for (int w = warp; w < (block + 31) / 32; w += blockDim.x / 32) {
      const int i = 32 * w + wl;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int r = i < block ? ranks[d * block + i] : -1;
        const uint32_t same = __match_any_sync(0xffffffffu, r);
        if (r >= 0 && wl == __ffs(same) - 1)
          eq[(d * block + r) * 4 + w] = same;
      }
    }
    __syncthreads();
    // le[d][r]: the points of rank <= r, an OR scan over r, one
    // (objective, word) column a warp at a time, 4 ranks a lane
    for (int col = warp; col < D * 4; col += blockDim.x / 32) {
      const int d = col / 4, w = col % 4;
      uint32_t run[4], total = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * wl + e;
        total |= r < block ? eq[(d * block + r) * 4 + w] : 0u;
        run[e] = total;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t below = __shfl_up_sync(0xffffffffu, total, o);
        if (wl >= o) total |= below;
      }
      uint32_t before = __shfl_up_sync(0xffffffffu, total, 1);
      if (wl == 0) before = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * wl + e;
        if (r < block) le[(d * block + r) * 4 + w] = run[e] | before;
      }
    }
    __syncthreads();
    // dominators: rank <= on every objective, less the equal points (the
    // point itself among them)
    for (int i = t; i < block; i += blockDim.x) {
      uint4 below = make_uint4(~0u, ~0u, ~0u, ~0u), same = below;
      bool nan = false;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int r = ranks[d * block + i];
        nan = nan || r < 0;
        const int at = (d * block + (r < 0 ? 0 : r)) * 4;
        const uint4 l = *reinterpret_cast<const uint4*>(le + at);
        const uint4 e = *reinterpret_cast<const uint4*>(eq + at);
        below = make_uint4(below.x & l.x, below.y & l.y, below.z & l.z,
                           below.w & l.w);
        same = make_uint4(same.x & e.x, same.y & e.y, same.z & e.z,
                          same.w & e.w);
      }
      counts[base + i] =
          nan ? 0
              : __popc(below.x) + __popc(below.y) + __popc(below.z)
                    + __popc(below.w) - __popc(same.x) - __popc(same.y)
                    - __popc(same.z) - __popc(same.w);
    }
    return;
  }

  // packed ranks: j dominates i iff rank_j <= rank_i on every lane of the
  // words and the words differ
  for (int i = t; i < block; i += blockDim.x) {
    Word w = 0;
    bool nan = false;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int r = ranks[d * block + i];
      nan = nan || r < 0;
      w |= static_cast<Word>(r < 0 ? 0 : r) << (d * L::kBits);
    }
    words[i] = nan ? L::template fill<D>(L::kMax) : w;
  }
  __syncthreads();
  constexpr Word kGuard = L::template fill<D>(L::kTop);
  Word mine[P], guarded[P];
  int32_t c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    mine[p] = idx[p] >= 0 ? words[idx[p]] : 0;
    guarded[p] = mine[p] | kGuard;
    c[p] = 0;
  }
#pragma unroll 4
  for (int j = lane; j < block; j += S) {
    const Word wj = words[j];
#pragma unroll
    for (int p = 0; p < P; ++p)
      c[p] += (((guarded[p] - wj) & kGuard) == kGuard) & (wj != mine[p]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int o = 1; o < S; o <<= 1)
      c[p] += __shfl_xor_sync(0xffffffffu, c[p], o);
    if (idx[p] >= 0 && lane == 0)
      counts[base + idx[p]] = ranks[idx[p]] < 0 ? 0 : c[p];
  }
}

template <int D, bool kMasks, typename Word>
int launch_kernel(const double* obj, int64_t n, int64_t block,
                  int32_t* counts, cudaStream_t s) {
  const int64_t groups = (block + kRankPoints - 1) / kRankPoints;
  const int threads = static_cast<int>((groups * kRankLanes + 31) / 32 * 32);
  const size_t smem = block_smem<D, kMasks, Word>(static_cast<int>(block));
  auto kernel = block_rank_dominance_kernel<D, kMasks, Word>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n / block), threads, smem, s>>>(
      obj, n, static_cast<int>(block), counts);
  return cudaGetLastError();
}

template <int D>
int launch_ranks(const double* obj, int64_t n, int64_t block,
                 int32_t* counts, cudaStream_t s) {
  if (block <= kMaskMaxBlock)
    return launch_kernel<D, true, uint32_t>(obj, n, block, counts, s);
  if (block <= 128)  // ranks to 127: 8-bit lanes
    return launch_kernel<D, false, uint32_t>(obj, n, block, counts, s);
  return launch_kernel<D, false, uint64_t>(obj, n, block, counts, s);
}

}  // namespace

extern "C" {

int k1_points(const double* obj, int64_t d, int64_t n, int64_t block,
              int32_t* counts, void* stream) {
  if (block < 1 || block > 1024 || n % block != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t groups = (block + kPointsPerThread - 1) / kPointsPerThread;
  const dim3 grid(static_cast<unsigned>(n / block));
  const dim3 threads(static_cast<unsigned>(
      (groups * kLanesPerPoint + 31) / 32 * 32));
  const size_t smem = static_cast<size_t>(d) * block * sizeof(double);
  const int b = static_cast<int>(block);
  switch (d) {
    case 2: block_points_kernel<2><<<grid, threads, smem, s>>>(obj, n, b, counts); break;
    case 3: block_points_kernel<3><<<grid, threads, smem, s>>>(obj, n, b, counts); break;
    case 4: block_points_kernel<4><<<grid, threads, smem, s>>>(obj, n, b, counts); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int k1_ranks(const double* obj, int64_t d, int64_t n, int64_t block,
             int32_t* counts, void* stream) {
  if (block < 1 || block > 1024 || n % block != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_ranks<2>(obj, n, block, counts, s);
    case 3: return launch_ranks<3>(obj, n, block, counts, s);
    case 4: return launch_ranks<4>(obj, n, block, counts, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
