// Matmul against packed LightPE (sum-of-powers-of-two) weights for Hopper
// (sm_90a), plain C interface.
//
// K4 p2mm_forward replaces the Pallas TPU kernel
// repro/kernels/pow2_matmul/kernel.py::pow2_matmul_pallas
// (_pow2_matmul_kernel): x (M, K) float32 or bf16 times the weights that
// uint8 codes decode to, (K, N), summed in float32, then times the
// per-column scale once the K sum is done.  The TPU walks K on a
// sequential grid axis, accumulating into its output block, and needs M, N,
// K padded to 128; here every kernel masks the ragged edges of M, N and K
// itself, so nothing is padded.
//
// Codes are decoded to exact values in the kernel, never to device memory:
// k=1 is a 4-bit code [s m m m] = +/- 2^-m, two to a byte, column 2j in the
// low nibble of byte j and column 2j+1 in the high one; k=2 is a byte
// [. s m1 m1 m1 m2 m2 m2] = +/- (2^-m1 + 2^-m2).  2^-m is built from its
// bits ((127 - m) << 23).  Every value has at most 8 significant bits, so
// it is exact in bf16, and its product with a bf16 x is exact in float32:
// only the order of the float32 sums differs from the plain version.
//
// Bound on this card: at qwen3-0.6b's ffn/wi shape (K = 1024, N = 3072) and
// M = 512 the work is 3.2 GFLOP (3.3 us at the tensor cores' bf16 989
// TFLOP/s) against 1.0 MB of bf16 x, 3.15 MB of k=2 codes (1.57 MB for
// k=1) and 6.29 MB of f32 out (3.1 us at 3.35 TB/s).  At M = 1 the codes
// alone bound it (0.94 us for k=2, 0.47 us for k=1).  p2mm_forward picks
// one of three kernels:
//
//  * M <= kDecodeMaxM, any x (p2mm_decode_kernel): a read of the codes.
//    A block owns 64 columns and a contiguous range of 64-row K tiles; the
//    K tiles are split over the up to kMaxSplits blocks of a thread-block
//    cluster, so N = 3072 runs 48 x 8 = 384 blocks.  Codes and x arrive by
//    16-byte cp.async into a ring of two stages; x is staged once per
//    block, its rows rounded up to 1, 2, 4, 8 or 16 (a template, so M = 1
//    does one multiply-add a code).  A thread owns one column and every
//    fourth K row of a tile, one table lookup a code; its sums meet the
//    other three threads' in shared memory in a fixed order, and block 0
//    of the cluster adds the blocks' partials in rank order through
//    distributed shared memory, all remote reads in flight together.  No
//    float atomics, so two calls give the same bits.
//  * M > kDecodeMaxM, bf16 x (p2mm_tc_kernel): mma.sync.m16n8k16, bf16 in,
//    f32 accumulate, on 128 x 96 output tiles (4 x 32 = 128 blocks at M =
//    512: one wave, one block an SM).  x and the codes arrive by 16-byte
//    cp.async into a ring of kTcStages stages of 64 K rows.  Each code tile
//    is decoded into a bf16 tile in shared memory, one lookup a code in a
//    table of every code's bf16 bits, which B reads through ldmatrix.trans
//    (A through ldmatrix); the decoded tile is double-buffered, so tile
//    j + 1 is decoded while tile j's products run, one barrier a tile.
//    What holds it back (PERF.md): mma.sync reaches about half of the
//    tensor cores' bf16 rate, and x is read from L2 once per column block
//    (32 MB at M = 512); a first design with 128 x 64 tiles (192 blocks)
//    and 64 x 64 tiles with arithmetic decoding was slower.
//  * M > kDecodeMaxM, float32 x (p2mm_f32_kernel): f32 FMAs on the CUDA
//    cores on 64 x 64 tiles, the kernel's first design, kept so an f32 x stays
//    exact in its products.
//
// Every kernel multiplies by scale[column] once per output, with
// __fmul_rn, after the whole K sum.  Where a row of x or of the codes is not
// 16-byte aligned (K or N ragged), the same kernels stage through plain
// loads instead of cp.async.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kDecodeMaxM = 16;  // M at or below: the decode path

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 2^-m for m in 0..7, exact
__device__ __forceinline__ float pow2_neg(uint32_t m) {
  return __int_as_float(static_cast<int>((127u - m) << 23));
}

__device__ __forceinline__ float decode1(uint32_t nibble) {
  const float v = pow2_neg(nibble & 7u);
  return (nibble & 8u) ? -v : v;
}

__device__ __forceinline__ float decode2(uint32_t code) {
  const float v = pow2_neg((code >> 3) & 7u) + pow2_neg(code & 7u);
  return (code & 64u) ? -v : v;
}

// bytes of codes that hold n columns
template <int kTerms>
__host__ __device__ constexpr int code_bytes(int n) {
  return kTerms == 1 ? n / 2 : n;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory; zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A tile of codes, rows [k0, k0 + rows) and the code bytes of columns
// [n0, n0 + cols), into dst (row pitch code_bytes(cols)); rows past K and
// columns past N land as 0.  kVec: 16-byte cp.async (the host checked
// that every chunk is aligned and wholly in or out of N).
template <int kTerms, bool kVec, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_codes(uint8_t* dst,
                                           const uint8_t* __restrict__ codes,
                                           int64_t k0, int64_t n0, int64_t K,
                                           int64_t N, int tid) {
  constexpr int kRow = code_bytes<kTerms>(kCols);
  const int64_t row_bytes = kTerms == 1 ? N / 2 : N;
  const int64_t b0 = kTerms == 1 ? n0 / 2 : n0;
  if (kVec) {
    constexpr int kChunks = kRow / 16;
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int64_t gk = k0 + r, gb = b0 + 16 * c;
      const bool in = gk < K && gb < row_bytes;
      cp_async16(dst + r * kRow + 16 * c,
                 codes + (in ? gk * row_bytes + gb : 0), in);
    }
  } else {
    for (int i = tid; i < kRows * kRow; i += kThreads) {
      const int r = i / kRow, c = i % kRow;
      const int64_t gk = k0 + r, gb = b0 + c;
      dst[i] = gk < K && gb < row_bytes ? codes[gk * row_bytes + gb] : 0;
    }
  }
}

// A tile of x, rows [m0, m0 + rows) and columns [k0, k0 + cols), into dst
// (row pitch `pitch` bytes) in x's own type; outside M x K lands as 0.
template <typename XT, bool kVec, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_x(unsigned char* dst, int pitch,
                                       const XT* __restrict__ x, int64_t m0,
                                       int64_t k0, int64_t M, int64_t K,
                                       int tid) {
  if (kVec) {
    constexpr int kPer = 16 / sizeof(XT);  // elements of a chunk
    constexpr int kChunks = kCols / kPer;
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int64_t gm = m0 + r, gk = k0 + kPer * c;
      const bool in = gm < M && gk < K;
      cp_async16(dst + r * pitch + 16 * c, x + (in ? gm * K + gk : 0), in);
    }
  } else {
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const int64_t gm = m0 + r, gk = k0 + c;
      reinterpret_cast<XT*>(dst + r * pitch)[c] =
          gm < M && gk < K ? x[gm * K + gk] : static_cast<XT>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// M <= kDecodeMaxM: the codes' read, K split over a cluster
// ---------------------------------------------------------------------------

constexpr int kDecBN = 64;        // columns of a block
constexpr int kDecTK = 64;        // K rows of a tile
constexpr int kDecThreads = 256;  // kDecBN columns x kDecGroups K lanes
constexpr int kDecGroups = kDecThreads / kDecBN;
constexpr int kMaxSplits = 8;     // blocks (one cluster) over K

template <typename XT, int kTerms, int kM>
struct DecSmem {
  static constexpr int kCodeRow = code_bytes<kTerms>(kDecBN);
  static constexpr int kXRow = kDecTK * static_cast<int>(sizeof(XT));
  static constexpr size_t kCodes = static_cast<size_t>(kDecTK) * kCodeRow;
  static constexpr size_t kX = static_cast<size_t>(kM) * kXRow;
  static constexpr size_t kStage = kCodes + kX;
  static constexpr size_t part = 2 * kStage;  // kDecGroups x kM x kDecBN f32
  static constexpr size_t red =
      part + sizeof(float) * kDecGroups * kM * kDecBN;
  static constexpr size_t lut = red + sizeof(float) * kM * kDecBN;
  static constexpr int kLut = kTerms == 1 ? 16 : 128;  // every code's value
  static constexpr size_t bytes = lut + sizeof(float) * kLut;
};

// Grid (ceil(N / 64), n_splits) in clusters of (1, n_splits).  Block r of a
// cluster takes a contiguous range of K tiles; see the note at the top.
// kM >= M rows of x are staged (the rows past M as zeros) and summed.
template <typename XT, int kTerms, bool kVec, int kM>
__global__ void __launch_bounds__(kDecThreads) p2mm_decode_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ codes,
    const float* __restrict__ scale, float* __restrict__ out, int64_t M,
    int64_t K, int64_t N) {
  using L = DecSmem<XT, kTerms, kM>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int col = tid % kDecBN, lane_k = tid / kDecBN;
  const int rank = blockIdx.y, n_splits = gridDim.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kDecBN;
  const int64_t n_tiles = (K + kDecTK - 1) / kDecTK;
  const int64_t base = n_tiles / n_splits, extra = n_tiles % n_splits;
  const int64_t first = rank * base + (rank < extra ? rank : extra);
  const int64_t mine = base + (rank < extra ? 1 : 0);

  float* lut = reinterpret_cast<float*>(smem + L::lut);
  for (int i = tid; i < L::kLut; i += kDecThreads)
    lut[i] = kTerms == 1 ? decode1(i) : decode2(i);  // read after a barrier

  float acc[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) acc[m] = 0.f;

  auto load = [&](int stage, int64_t tile) {
    unsigned char* st = smem + stage * L::kStage;
    load_codes<kTerms, kVec, kDecTK, kDecBN, kDecThreads>(
        st, codes, tile * kDecTK, n0, K, N, tid);
    load_x<XT, kVec, kM, kDecTK, kDecThreads>(
        st + L::kCodes, L::kXRow, x, 0, tile * kDecTK, M, K, tid);
    cp_async_commit();
  };
  if (mine > 0) load(0, first);
  for (int64_t j = 0; j < mine; ++j) {
    const int stage = static_cast<int>(j % 2);
    if (j + 1 < mine) {
      load(1 - stage, first + j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* cs = smem + stage * L::kStage;
    const XT* xs = reinterpret_cast<const XT*>(cs + L::kCodes);
#pragma unroll
    for (int kk = lane_k; kk < kDecTK; kk += kDecGroups) {
      const uint32_t byte = cs[kk * L::kCodeRow + (kTerms == 1 ? col / 2
                                                                : col)];
      const float w = lut[kTerms == 1 ? (col % 2 ? byte >> 4 : byte & 15u)
                                      : byte & 127u];
#pragma unroll
      for (int m = 0; m < kM; ++m)
        acc[m] = fmaf(to_f32(xs[m * kDecTK + kk]), w, acc[m]);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // the K lanes' sums, added in lane order; then the blocks' in rank order
  float* part = reinterpret_cast<float*>(smem + L::part);
  float* red = reinterpret_cast<float*>(smem + L::red);
#pragma unroll
  for (int m = 0; m < kM; ++m) part[(lane_k * kM + m) * kDecBN + col] = acc[m];
  __syncthreads();
  for (int i = tid; i < M * kDecBN; i += kDecThreads) {
    float s = part[i];
#pragma unroll
    for (int g = 1; g < kDecGroups; ++g) s += part[g * kM * kDecBN + i];
    red[i] = s;
  }
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < M * kDecBN; i += kDecThreads) {
      float v[kMaxSplits];  // every remote read in flight before the sum
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r)
        v[r] = r < n_splits ? cluster.map_shared_rank(red, r)[i] : 0.f;
      float s = red[i];
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r)
        if (r < n_splits) s += v[r];
      const int64_t gm = i / kDecBN, gn = n0 + i % kDecBN;
      if (gn < N) out[gm * N + gn] = __fmul_rn(s, scale[gn]);
    }
  }
  cluster.sync();  // every block's shared memory outlives block 0's reads
}

// ---------------------------------------------------------------------------
// M > kDecodeMaxM, bf16 x: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128;       // rows of x per block (16 a warp)
constexpr int kTcBN = 96;        // columns per block
constexpr int kTcBK = 64;        // K rows of a tile
constexpr int kTcStages = 4;     // ring of (x, codes) tiles
constexpr int kTcThreads = 256;  // 8 warps

template <int kTerms>
struct TcSmem {
  static constexpr int kRow = kTcBK * 2 + 16;     // padded x row, bytes
  static constexpr int kWRow = kTcBN * 2 + 16;    // padded W row, bytes
  static constexpr int kCodeRow = code_bytes<kTerms>(kTcBN);
  static constexpr size_t kX = static_cast<size_t>(kTcBM) * kRow;
  static constexpr size_t kStage = kX + static_cast<size_t>(kTcBK) * kCodeRow;
  static constexpr size_t kW = static_cast<size_t>(kTcBK) * kWRow;
  static constexpr size_t w = kTcStages * kStage;  // 2 x decoded bf16 (k, n)
  static constexpr size_t lut = w + 2 * kW;
  static constexpr int kCodes = kTerms == 1 ? 16 : 128;  // bf16 of a code
  static constexpr size_t bytes = lut + 2 * kCodes;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 bits of every code's value, decoded once per block.
template <int kTerms>
__device__ __forceinline__ void fill_lut(uint16_t* lut, int tid) {
  for (int i = tid; i < TcSmem<kTerms>::kCodes; i += kTcThreads) {
    const __nv_bfloat16 v =
        __float2bfloat16_rn(kTerms == 1 ? decode1(i) : decode2(i));  // exact
    lut[i] = *reinterpret_cast<const uint16_t*>(&v);
  }
}

// The code tile (kTcBK x kTcBN codes) decoded into the bf16 W tile, row k,
// column n, rows kWRow bytes apart, one table lookup a code.
template <int kTerms>
__device__ __forceinline__ void decode_tile(unsigned char* w,
                                            const uint8_t* cs,
                                            const uint16_t* lut, int tid) {
  using L = TcSmem<kTerms>;
  auto pair = [&](uint32_t lo, uint32_t hi) {
    return static_cast<uint32_t>(lut[lo]) | (static_cast<uint32_t>(lut[hi])
                                             << 16);
  };
  if (kTerms == 1) {  // a word is 8 columns: 16 bytes of bf16
    constexpr int kWords = kTcBN / 8;
    for (int i = tid; i < kTcBK * kWords; i += kTcThreads) {
      const int r = i / kWords, q = i % kWords;
      const uint32_t c = *reinterpret_cast<const uint32_t*>(
          cs + r * L::kCodeRow + 4 * q);
      uint4 v;
      v.x = pair(c & 15u, (c >> 4) & 15u);
      v.y = pair((c >> 8) & 15u, (c >> 12) & 15u);
      v.z = pair((c >> 16) & 15u, (c >> 20) & 15u);
      v.w = pair((c >> 24) & 15u, c >> 28);
      *reinterpret_cast<uint4*>(w + r * L::kWRow + 16 * q) = v;
    }
  } else {  // a word is 4 columns: 8 bytes of bf16; bit 7 is not read
    constexpr int kWords = kTcBN / 4;
    for (int i = tid; i < kTcBK * kWords; i += kTcThreads) {
      const int r = i / kWords, q = i % kWords;
      const uint32_t c = *reinterpret_cast<const uint32_t*>(
          cs + r * L::kCodeRow + 4 * q);
      uint2 v;
      v.x = pair(c & 127u, (c >> 8) & 127u);
      v.y = pair((c >> 16) & 127u, (c >> 24) & 127u);
      *reinterpret_cast<uint2*>(w + r * L::kWRow + 8 * q) = v;
    }
  }
}

// Grid (ceil(N / 96), ceil(M / 128)), 8 warps; warp i owns rows 16 i ..
// 16 i + 15 of the block's tile and all 96 columns.  Thread (warp, lane)
// holds rows g = lane / 4 and g + 8 and, of each 8-column slice, columns
// 2 (lane % 4) and 2 (lane % 4) + 1.
template <int kTerms, bool kVec>
__global__ void __launch_bounds__(kTcThreads) p2mm_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
    const float* __restrict__ scale, float* __restrict__ out, int64_t M,
    int64_t K, int64_t N) {
  using L = TcSmem<kTerms>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kTcBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTcBN;
  const int64_t n_k = (K + kTcBK - 1) / kTcBK;
  unsigned char* ws = smem + L::w;
  uint16_t* lut = reinterpret_cast<uint16_t*>(smem + L::lut);
  fill_lut<kTerms>(lut, tid);  // read after the loop's first barrier

  auto load = [&](int stage, int64_t tile) {
    unsigned char* st = smem + stage * L::kStage;
    load_x<__nv_bfloat16, kVec, kTcBM, kTcBK, kTcThreads>(
        st, L::kRow, x, m0, tile * kTcBK, M, K, tid);
    load_codes<kTerms, kVec, kTcBK, kTcBN, kTcThreads>(
        st + L::kX, codes, tile * kTcBK, n0, K, N, tid);
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }

  float acc[kTcBN / 8][4];
#pragma unroll
  for (int n = 0; n < kTcBN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix row addresses of this lane: A from x rows, B from W rows
  // transposed (the fragment layouts of mma.m16n8k16)
  const int a_off = (warp * 16 + lane % 16) * L::kRow + (lane / 16) * 16;
  const int b_off = (lane % 8 + ((lane / 8) % 2) * 8) * L::kWRow
                    + (lane / 16) * 16;

  // tile 0's codes decoded before the loop; then one barrier a tile: the
  // codes of tile j + 1 are decoded into the other W buffer while tile j's
  // products run, so the two overlap
  cp_async_wait<kTcStages - 2>();
  __syncthreads();  // tile 0 and the table are in
  if (n_k > 0) decode_tile<kTerms>(ws, smem + L::kX, lut, tid);
  for (int64_t j = 0; j < n_k; ++j) {
    const int stage = static_cast<int>(j % kTcStages);
    cp_async_wait<kTcStages - 3>();
    __syncthreads();  // tile j + 1 is in, W[j % 2] is decoded, and every
                      // warp is done with tile j - 1 and W[(j + 1) % 2]
    if (j + kTcStages - 1 < n_k)
      load(static_cast<int>((j + kTcStages - 1) % kTcStages),
           j + kTcStages - 1);
    cp_async_commit();
    if (j + 1 < n_k)
      decode_tile<kTerms>(ws + ((j + 1) % 2) * L::kW,
                          smem + ((j + 1) % kTcStages) * L::kStage + L::kX,
                          lut, tid);
    const unsigned char* xs = smem + stage * L::kStage;
    const unsigned char* wj = ws + (j % 2) * L::kW;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      uint32_t a[4], b[kTcBN / 16][4];
      ldsm_x4(a, xs + a_off + kk * 32);
#pragma unroll
      for (int np = 0; np < kTcBN / 16; ++np)
        ldsm_x4_trans(b[np], wj + b_off + kk * 16 * L::kWRow + np * 32);
#pragma unroll
      for (int np = 0; np < kTcBN / 16; ++np) {
        mma_bf16(acc[2 * np], a, b[np][0], b[np][1]);
        mma_bf16(acc[2 * np + 1], a, b[np][2], b[np][3]);
      }
    }
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < kTcBN / 8; ++n) {
    const int64_t gn = n0 + n * 8 + 2 * t;
    const float s0 = gn < N ? scale[gn] : 0.f;
    const float s1 = gn + 1 < N ? scale[gn + 1] : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t gm = m0 + warp * 16 + g + 8 * r;
      if (gm >= M) continue;
      const float v0 = __fmul_rn(acc[n][2 * r], s0);
      const float v1 = __fmul_rn(acc[n][2 * r + 1], s1);
      float* row = out + gm * N;
      if (gn + 1 < N && N % 2 == 0) {
        *reinterpret_cast<float2*>(row + gn) = make_float2(v0, v1);
      } else {
        if (gn < N) row[gn] = v0;
        if (gn + 1 < N) row[gn + 1] = v1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// M > kDecodeMaxM, float32 x: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32BM = 64;         // rows of x per block
constexpr int kF32BN = 64;         // columns per block
constexpr int kF32BK = 16;         // rows of K per step
constexpr int kF32Threads = 256;   // 16 x 16; each thread 4 rows x 4 columns

// acc[j] += a * b[j] for the four columns of b
__device__ __forceinline__ void fma_row(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// A K step stages 16 rows of K: x's tile transposed to Xs[k][row] and the
// decoded weights as Ws[k][column]; each thread owns 4 rows x 4 columns
// and reads both with 16-byte loads: 2 shared loads per 16 FMAs.
template <int kTerms>
__global__ void __launch_bounds__(kF32Threads)
p2mm_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                const float* __restrict__ scale, float* __restrict__ out,
                int64_t M, int64_t K, int64_t N) {
  __shared__ __align__(16) float Xs[kF32BK][kF32BM + 4];   // [k][row]
  __shared__ __align__(16) float Ws[kF32BK][kF32BN];       // [k][column]

  const int tid = threadIdx.x;
  const int tx = tid % 16;        // columns 4 tx .. 4 tx + 3
  const int ty = tid / 16;        // rows 4 ty .. 4 ty + 3
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kF32BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kF32BN;
  const int64_t code_cols = kTerms == 1 ? N / 2 : N;

  // loaders: x, row tid / 4 and k 4 (tid % 4) .. + 3; codes, k row
  // tid / 16 and columns 4 (tid % 16) .. + 3
  const int lx_row = tid / 4, lx_k = 4 * (tid % 4);
  const int lw_k = tid / 16, lw_n = 4 * (tid % 16);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += kF32BK) {
    {
      const int64_t gm = m0 + lx_row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t gk = k0 + lx_k + c;
        Xs[lx_k + c][lx_row] = gm < M && gk < K ? x[gm * K + gk] : 0.f;
      }
    }
    {
      const int64_t gk = k0 + lw_k;
      const int64_t gn = n0 + lw_n;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < K) {
        const uint8_t* row = codes + gk * code_cols;
        if (kTerms == 1) {
          // columns gn .. gn + 3 are the nibbles of bytes gn / 2, gn / 2 + 1
          // (N is even, so a byte's two columns are both in or both out)
          if (gn < N) {
            const uint32_t byte = row[gn / 2];
            v.x = decode1(byte & 0xFu);
            v.y = decode1(byte >> 4);
          }
          if (gn + 2 < N) {
            const uint32_t byte = row[gn / 2 + 1];
            v.z = decode1(byte & 0xFu);
            v.w = decode1(byte >> 4);
          }
        } else {
          if (gn < N) v.x = decode2(row[gn]);
          if (gn + 1 < N) v.y = decode2(row[gn + 1]);
          if (gn + 2 < N) v.z = decode2(row[gn + 2]);
          if (gn + 3 < N) v.w = decode2(row[gn + 3]);
        }
      }
      *reinterpret_cast<float4*>(&Ws[lw_k][lw_n]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Ws[kk][4 * tx]);
      fma_row(acc[0], a.x, b);
      fma_row(acc[1], a.y, b);
      fma_row(acc[2], a.z, b);
      fma_row(acc[3], a.w, b);
    }
    __syncthreads();
  }

  const int64_t gn = n0 + 4 * tx;
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j] = gn + j < N ? scale[gn + j] : 0.f;
  // four whole, 16-byte aligned columns: one vector store a row
  const bool vec_out = N % 4 == 0 && gn + 3 < N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + 4 * ty + i;
    if (gm >= M) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(acc[i][j], sc[j]);
    if (vec_out) {
      *reinterpret_cast<float4*>(out + gm * N + gn) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) out[gm * N + gn + j] = v[j];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename XT, int kTerms, bool kVec, int kM>
int launch_decode_m(const void* x, const uint8_t* codes, const float* scale,
                  float* out, int64_t M, int64_t K, int64_t N,
                  cudaStream_t stream) {
  auto kernel = p2mm_decode_kernel<XT, kTerms, kVec, kM>;
  constexpr size_t smem = DecSmem<XT, kTerms, kM>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t tiles = (K + kDecTK - 1) / kDecTK;
  const unsigned n_splits = static_cast<unsigned>(
      tiles < 1 ? 1 : (tiles < kMaxSplits ? tiles : kMaxSplits));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_splits;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + kDecBN - 1) / kDecBN),
                     n_splits);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x), codes,
                           scale, out, M, K, N);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the decode kernel for the least of 1, 2, 4, 8, 16 rows that holds M
template <typename XT, int kTerms, bool kVec>
int launch_decode(const void* x, const uint8_t* codes, const float* scale,
                  float* out, int64_t M, int64_t K, int64_t N,
                  cudaStream_t stream) {
  static_assert(kDecodeMaxM == 16, "the row buckets end at kDecodeMaxM");
  if (M <= 1)
    return launch_decode_m<XT, kTerms, kVec, 1>(x, codes, scale, out, M, K,
                                                N, stream);
  if (M <= 2)
    return launch_decode_m<XT, kTerms, kVec, 2>(x, codes, scale, out, M, K,
                                                N, stream);
  if (M <= 4)
    return launch_decode_m<XT, kTerms, kVec, 4>(x, codes, scale, out, M, K,
                                                N, stream);
  if (M <= 8)
    return launch_decode_m<XT, kTerms, kVec, 8>(x, codes, scale, out, M, K,
                                                N, stream);
  return launch_decode_m<XT, kTerms, kVec, 16>(x, codes, scale, out, M, K, N,
                                               stream);
}

template <int kTerms, bool kVec>
int launch_tc(const void* x, const uint8_t* codes, const float* scale,
              float* out, int64_t M, int64_t K, int64_t N,
              cudaStream_t stream) {
  auto kernel = p2mm_tc_kernel<kTerms, kVec>;
  constexpr size_t smem = TcSmem<kTerms>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((N + kTcBN - 1) / kTcBN),
                  static_cast<unsigned>((M + kTcBM - 1) / kTcBM));
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), codes, scale, out, M, K, N);
  return cudaGetLastError();
}

template <int kTerms>
int launch(const void* x, const uint8_t* codes, const float* scale,
           float* out, int64_t M, int64_t K, int64_t N, int x_bf16,
           cudaStream_t stream) {
  // 16-byte copies need every chunk of a row aligned and wholly in or out
  // of the matrix: x rows of whole chunks, code rows of whole 16 bytes
  const int64_t row_bytes = kTerms == 1 ? N / 2 : N;
  const bool vec = aligned16(codes) && row_bytes % 16 == 0 && aligned16(x)
                   && K % (x_bf16 ? 8 : 4) == 0;
  if (M <= kDecodeMaxM) {
    if (x_bf16)
      return vec ? launch_decode<__nv_bfloat16, kTerms, true>(
                       x, codes, scale, out, M, K, N, stream)
                 : launch_decode<__nv_bfloat16, kTerms, false>(
                       x, codes, scale, out, M, K, N, stream);
    return vec ? launch_decode<float, kTerms, true>(x, codes, scale, out, M,
                                                    K, N, stream)
               : launch_decode<float, kTerms, false>(x, codes, scale, out, M,
                                                     K, N, stream);
  }
  if (x_bf16)
    return vec ? launch_tc<kTerms, true>(x, codes, scale, out, M, K, N,
                                         stream)
               : launch_tc<kTerms, false>(x, codes, scale, out, M, K, N,
                                          stream);
  const dim3 grid(static_cast<unsigned>((N + kF32BN - 1) / kF32BN),
                  static_cast<unsigned>((M + kF32BM - 1) / kF32BM));
  p2mm_f32_kernel<kTerms><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(x), codes, scale, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int p2mm_forward(const void* x, const void* codes,
                            const void* scale, void* out, int64_t M,
                            int64_t K, int64_t N, int k_terms, int x_bf16,
                            void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_terms == 1) return launch<1>(x, c, s, o, M, K, N, x_bf16, st);
  return launch<2>(x, c, s, o, M, K, N, x_bf16, st);
}
