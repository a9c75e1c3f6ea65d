// W8A8 int8 matmul for Hopper (sm_90a), plain C interface.
//
// K3 i8mm_forward replaces the Pallas TPU kernel
// repro/kernels/int8_matmul/kernel.py::int8_matmul_pallas
// (_int8_matmul_kernel): int8 x (M, K) times int8 w (K, N) into an int32
// accumulator, then out[m][n] = ((float)acc * x_scale[m]) * w_scale[n] in
// float32.  The TPU walks K on a sequential grid axis with the int32 sum in
// VMEM scratch and needs M, N, K padded to 128; here the kernels mask the
// ragged edges of M, N and K themselves, so nothing is padded.
//
// Bound on this card: at qwen3-0.6b's ffn/wi shape (K = 1024, N = 3072),
// M = 512 moves 0.52 MB of x codes, 3.15 MB of w codes and writes 6.29 MB
// of f32 out (3.0 us at 3.35 TB/s) for 3.2 GOP (1.6 us at the tensor
// cores' 1,979 int8 TOP/s): bytes bound it.  M = 1 is the 3.15 MB of w
// codes alone (0.94 us).  The int8 rate exists only on the tensor cores,
// and a decode token must spread the codes' read over the whole card, so
// i8mm_forward picks one of two kernels by M:
//
//  * M > kDecodeMaxM (i8mm_tc_kernel): mma.sync.m16n8k32 s8 x s8 -> s32 on
//    the tensor cores, 8 warps on a tile of kTcBN = 128 columns and 128 or
//    64 rows, x and w arriving by 16-byte cp.async into a ring of kTcStages
//    tiles of kTcBK = 128 bytes of K.  The s8 mma wants B K-major and there
//    is no transposing load for 8-bit data, while w is stored (K, N): its
//    tile lands in shared memory as it is, and each thread reads four k
//    rows' words of four columns and transposes the 4 x 4 bytes with
//    __byte_perm into four B fragments (one word a column, four consecutive
//    k).  So an mma's eight n slots are columns 4 g + j of a 32-column
//    slice.  The 16-byte chunks of a w row are XOR-swizzled by bits 2-3 of
//    k, so those word reads hit 32 banks; x rows are padded by 16 bytes, so
//    A's ldmatrix reads do too.  (Transposing each w tile once for all warps
//    into a K-major tile that ldmatrix reads was tried and was no faster.)
//    The tile and a split of K are chosen by shape: 128-row tiles unless
//    the grid would hold fewer than kTcMinTiles of them, else 64-row tiles;
//    then K split over 2 or 4 blocks of a cluster (each keeping at least
//    kTcStages tiles of K) while the grid has fewer than kTcMinBlocks
//    blocks.  At M = 512: N = 3072 runs 96 blocks of 128 x 128, N = 2048
//    128 blocks (split 2), N = 1024 128 blocks of 64 x 128 (split 2).  The
//    int32 tile goes to shared memory and each warp stores whole rows,
//    scaled, 16 bytes a thread; with a split, block r of the cluster first
//    sums the cluster's tiles for its share of the rows through distributed
//    shared memory (no atomics, no second launch).  Without a split the
//    launch is not a cluster launch, which costs more, and the epilogue's
//    scales are read before the main loop, which hides their latency.
//  * M <= kDecodeMaxM (i8mm_decode_kernel): a read of w.  A block owns 64
//    columns and a contiguous range of 64-row K tiles; the tiles are split
//    over up to kMaxSplits blocks of a cluster, so N = 3072 runs 48 x 8 =
//    384 blocks.  w and x arrive by 16-byte cp.async into a ring of
//    kDecStages stages; a thread owns four columns and four k rows of a
//    tile, transposes them as above and runs __dp4a against x's words.  x's
//    rows are rounded up to 1, 2, 4, 8 or 16 (a template), so M = 1 does one
//    dp4a per four codes.  The k lanes' sums meet in shared memory and the
//    blocks' through distributed shared memory, as above.
//
// Every int32 sum is exact in any order (|acc| <= 128^2 K < 2^31 for K <
// 131,072), so splitting K changes no bit.  Epilogue: __fmul_rn twice, in
// the reference's order, so nothing is contracted or reordered and the
// result is bit-identical to the plain version (ref.py) on any input.
// x_scale may be float32 or bf16 (the reference keeps a bf16 x's scales in
// bf16 and casts them to float32 in the epilogue); w_scale is float32.
// Where K or N is not a multiple of 16, or the codes are not 16-byte
// aligned, the same kernels stage through byte loads instead of cp.async.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); i8mm_plan reports the kernel, tile
// and split a shape runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kDecodeMaxM = 16;  // M at or below: the decode path

__device__ __forceinline__ float scale_f32(const float* s, int64_t i) {
  return s[i];
}
__device__ __forceinline__ float scale_f32(const __nv_bfloat16* s,
                                           int64_t i) {
  return __bfloat162float(s[i]);
}

__device__ __forceinline__ float epilogue(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
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

// Four words, each four columns of one k row (r[i] = row i), to four words,
// each four consecutive k of one column (out[j] = column j, k in byte order).
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// rows [r0, r0 + kRows) x bytes [c0, c0 + kCols) of a row-major int8 matrix
// (rows x cols) into dst; place(r, c) is the byte offset of (r, c) in dst.
// Outside the matrix lands as 0.  kVec: 16-byte cp.async (the host checked
// that every chunk is aligned and wholly in or out of the matrix).
template <bool kVec, int kRows, int kCols, int kThreads, typename Place>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const int8_t* __restrict__ src,
                                          int64_t r0, int64_t c0,
                                          int64_t rows, int64_t cols,
                                          int tid, Place place) {
  if (kVec) {
    constexpr int kChunks = kCols / 16;
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = 16 * (i % kChunks);
      const int64_t gr = r0 + r, gc = c0 + c;
      const bool in = gr < rows && gc < cols;
      cp_async16(dst + place(r, c), src + (in ? gr * cols + gc : 0), in);
    }
  } else {
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const int64_t gr = r0 + r, gc = c0 + c;
      dst[place(r, c)] = gr < rows && gc < cols
                             ? static_cast<unsigned char>(src[gr * cols + gc])
                             : 0;
    }
  }
}

// The K tiles of split `rank` of n_splits: [first, first + count).
__device__ __forceinline__ void split_range(int64_t n_tiles, int rank,
                                            int n_splits, int64_t& first,
                                            int64_t& count) {
  const int64_t base = n_tiles / n_splits, extra = n_tiles % n_splits;
  first = rank * base + (rank < extra ? rank : extra);
  count = base + (rank < extra ? 1 : 0);
}

// out[gm][gn + e] for e < 4 from four int32 sums, as one 16-byte store
// where the four columns are whole and aligned
__device__ __forceinline__ void store4(float* __restrict__ out, int64_t gm,
                                       int64_t gn, int64_t N,
                                       const int (&sum)[4], float xs,
                                       const float* ws) {
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = epilogue(sum[e], xs, ws[e]);
  float* dst = out + gm * N + gn;
  if (N % 4 == 0 && gn + 3 < N) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (gn + e < N) dst[e] = o[e];
  }
}

// ---------------------------------------------------------------------------
// M > kDecodeMaxM: mma.sync s8 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBN = 128;         // columns of a block: 4 warps x 32
constexpr int kTcBK = 128;         // bytes of K a tile
constexpr int kTcStages = 4;       // ring of (x, w) tiles
constexpr int kTcThreads = 256;    // 8 warps: 2 over rows x 4 over columns
constexpr int kTcBigBM = 128;      // rows of a block ...
constexpr int kTcSmallBM = 64;     // ... or these below kTcMinTiles tiles
constexpr int kTcMinTiles = 48;    // 128-row tiles a grid should reach
constexpr int kTcMinBlocks = 96;   // blocks a launch should reach
constexpr int kTcMaxSplits = 4;    // blocks of a cluster over K

template <int kBM>
struct TcSmem {
  static constexpr int kARow = kTcBK + 16;  // padded x row, bytes
  static constexpr size_t kA = static_cast<size_t>(kBM) * kARow;
  static constexpr size_t kStage = kA + kTcBK * kTcBN;
  static constexpr int kCRow = kTcBN + 4;   // padded int32 row, words
  static constexpr size_t kC = sizeof(int) * kBM * kCRow;
  static constexpr size_t bytes =
      kTcStages * kStage > kC ? kTcStages * kStage : kC;
};

// byte offset of (k, column c) in a w tile: 128-byte rows, the 16-byte
// chunk index XORed with bits 2-3 of k (times 2)
__device__ __forceinline__ int w_place(int k, int c) {
  return k * kTcBN + ((((c >> 4) ^ ((k >> 1) & 6)) << 4) | (c & 15));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// c (16 x 8, s32) += a (16 x 32, s8, row) * b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (ceil(N / 128), ceil(M / kBM), n_splits), in clusters of (1, 1,
// n_splits) when kSplit (a launch without a split is not a cluster launch,
// which costs more).  Warp (wm, wn) owns rows wm * kBM / 2 .. + kBM / 2 and
// columns 32 wn .. 32 wn + 31; lane (g = lane / 4, t = lane % 4) holds, of
// each 16-row slice, rows g and g + 8 at columns 8 t .. 8 t + 7 of the
// warp's 32.
template <int kBM, bool kSplit, bool kVec, typename XS>
__global__ void __launch_bounds__(kTcThreads) i8mm_tc_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const XS* __restrict__ x_scale, const float* __restrict__ w_scale,
    float* __restrict__ out, int64_t M, int64_t K, int64_t N) {
  using L = TcSmem<kBM>;
  constexpr int kWM = kBM / 2;         // rows of a warp
  constexpr int kMT = kWM / 16;        // its 16-row slices
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int rank = blockIdx.z, n_splits = gridDim.z;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTcBN;
  int64_t first, mine;
  split_range((K + kTcBK - 1) / kTcBK, rank, n_splits, first, mine);
  // the epilogue's scales, read now so the main loop hides their latency:
  // this thread's four columns, and lane k holds the x scale of the k-th
  // row its warp stores
  const int rows = kBM / n_splits, c = 4 * (tid % 32);
  const int64_t gn = n0 + c;
  float ws[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ws[e] = gn + e < N ? w_scale[gn + e] : 0.f;
  const int64_t row_m = m0 + rank * rows + warp + 8 * lane;
  const float xs_lane = lane < rows / 8 && row_m < M
                            ? scale_f32(x_scale, row_m) : 0.f;

  auto load = [&](int stage, int64_t tile) {
    unsigned char* st = smem + stage * L::kStage;
    load_tile<kVec, kBM, kTcBK, kTcThreads>(
        st, x, m0, tile * kTcBK, M, K, tid,
        [](int r, int c) { return r * L::kARow + c; });
    load_tile<kVec, kTcBK, kTcBN, kTcThreads>(
        st + L::kA, w, tile * kTcBK, n0, K, N, tid,
        [](int r, int c) { return w_place(r, c); });
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < mine) load(s, first + s);
    cp_async_commit();
  }

  int acc[kMT][4][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // A: ldmatrix rows of this lane (the m16n8k32 A fragment: rows lane % 16,
  // bytes 16 (lane / 16) of each 32-byte k step)
  const int a_off = (wm * kWM + lane % 16) * L::kARow + (lane / 16) * 16;
  for (int64_t j = 0; j < mine; ++j) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (j + kTcStages - 1 < mine)
      load(static_cast<int>((j + kTcStages - 1) % kTcStages),
           first + j + kTcStages - 1);
    cp_async_commit();
    const unsigned char* as = smem + (j % kTcStages) * L::kStage;
    const unsigned char* bs = as + L::kA;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 32; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldsm_x4(a[i], as + a_off + i * 16 * L::kARow + kk * 32);
      // B: k rows 32 kk + 16 h + 4 t + r, four columns from 32 wn + 4 g
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t rows[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          rows[r] = *reinterpret_cast<const uint32_t*>(
              bs + w_place(32 * kk + 16 * h + 4 * t + r, 32 * wn + 4 * g));
        transpose4x4(rows, b[h]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) mma_s8(acc[i][jn], a[i], b[0][jn],
                                              b[1][jn]);
    }
  }

  // The int32 tile to shared memory (n slot 2 t (+ 1) of mma jn is column
  // 8 t + jn (+ 4) of the warp's 32); then block `rank` of the cluster sums
  // the cluster's tiles for its rows, a warp a row and four columns a
  // thread, every remote read in flight before the sum, and stores them
  // as whole rows
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  int* cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int* row = cs + (wm * kWM + 16 * i + g + 8 * h) * L::kCRow + 32 * wn
                 + 8 * t;
      *reinterpret_cast<int4*>(row) = make_int4(
          acc[i][0][2 * h], acc[i][1][2 * h], acc[i][2][2 * h],
          acc[i][3][2 * h]);
      *reinterpret_cast<int4*>(row + 4) = make_int4(
          acc[i][0][2 * h + 1], acc[i][1][2 * h + 1], acc[i][2][2 * h + 1],
          acc[i][3][2 * h + 1]);
    }
  if constexpr (kSplit)
    cluster.sync();
  else
    __syncthreads();
#pragma unroll 4
  for (int k = 0; k < rows / 8; ++k) {
    const int r = rank * rows + warp + 8 * k;
    const float xs = __shfl_sync(0xffffffffu, xs_lane, k);
    int4 v[kSplit ? kTcMaxSplits : 1];
#pragma unroll
    for (int s = 0; s < (kSplit ? kTcMaxSplits : 1); ++s)
      if (s < n_splits)
        v[s] = *reinterpret_cast<const int4*>(
            (kSplit && s != rank ? cluster.map_shared_rank(cs, s) : cs)
            + r * L::kCRow + c);
    int sum[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int s = 1; s < (kSplit ? kTcMaxSplits : 1); ++s)
      if (s < n_splits) {
        sum[0] += v[s].x;
        sum[1] += v[s].y;
        sum[2] += v[s].z;
        sum[3] += v[s].w;
      }
    const int64_t gm = m0 + r;
    if (gm < M) store4(out, gm, gn, N, sum, xs, ws);
  }
  if constexpr (kSplit)
    cluster.sync();  // every block's tile outlives the others' reads
}

// ---------------------------------------------------------------------------
// M <= kDecodeMaxM: the read of w, K split over a cluster
// ---------------------------------------------------------------------------

constexpr int kDecBN = 64;        // columns of a block
constexpr int kDecTK = 64;        // K rows of a tile
constexpr int kDecThreads = 256;  // 16 column words x 16 k quads
constexpr int kDecStages = 4;     // ring of (w, x) tiles
constexpr int kMaxSplits = 8;     // blocks (one cluster) over K

template <int kM>
struct DecSmem {
  static constexpr int kWRow = kDecBN + 16;  // padded w row, bytes
  static constexpr size_t kW = static_cast<size_t>(kDecTK) * kWRow;
  static constexpr size_t kStage = kW + static_cast<size_t>(kM) * kDecTK;
  static constexpr size_t part = kDecStages * kStage;  // 8 warps' sums
  static constexpr size_t red = part + sizeof(int) * 8 * kM * kDecBN;
  static constexpr size_t bytes = red + sizeof(int) * kM * kDecBN;
};

// Grid (ceil(N / 64), n_splits) in clusters of (1, n_splits).  Thread
// (q = tid / 16, c = tid % 16) owns columns 4 c .. 4 c + 3 and k rows
// 4 q .. 4 q + 3 of each tile; kM >= M rows of x are staged (the rows past
// M as zeros) and summed.
template <int kM, bool kVec, typename XS>
__global__ void __launch_bounds__(kDecThreads) i8mm_decode_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const XS* __restrict__ x_scale, const float* __restrict__ w_scale,
    float* __restrict__ out, int64_t M, int64_t K, int64_t N) {
  using L = DecSmem<kM>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int c = tid % 16, q = tid / 16;
  const int rank = blockIdx.y, n_splits = gridDim.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kDecBN;
  int64_t first, mine;
  split_range((K + kDecTK - 1) / kDecTK, rank, n_splits, first, mine);

  auto load = [&](int stage, int64_t tile) {
    unsigned char* st = smem + stage * L::kStage;
    load_tile<kVec, kDecTK, kDecBN, kDecThreads>(
        st, w, tile * kDecTK, n0, K, N, tid,
        [](int r, int col) { return r * L::kWRow + col; });
    load_tile<kVec, kM, kDecTK, kDecThreads>(
        st + L::kW, x, 0, tile * kDecTK, M, K, tid,
        [](int r, int col) { return r * kDecTK + col; });
  };
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < mine) load(s, first + s);
    cp_async_commit();
  }

  int acc[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  for (int64_t j = 0; j < mine; ++j) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // tile j is in; every thread is done with tile j - 1
    if (j + kDecStages - 1 < mine)
      load(static_cast<int>((j + kDecStages - 1) % kDecStages),
           first + j + kDecStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (j % kDecStages) * L::kStage;
    uint32_t rows[4], cols[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rows[r] = *reinterpret_cast<const uint32_t*>(
          st + (4 * q + r) * L::kWRow + 4 * c);
    transpose4x4(rows, cols);
    const int* xs = reinterpret_cast<const int*>(st + L::kW);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int xv = xs[m * (kDecTK / 4) + q];
#pragma unroll
      for (int jc = 0; jc < 4; ++jc)
        acc[m][jc] = __dp4a(xv, static_cast<int>(cols[jc]), acc[m][jc]);
    }
  }

  // the two k quads of a warp, then the 8 warps, then the cluster's blocks
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int jc = 0; jc < 4; ++jc)
      acc[m][jc] += __shfl_xor_sync(0xffffffffu, acc[m][jc], 16);
  cp_async_wait<0>();
  int* part = reinterpret_cast<int*>(smem + L::part);
  int* red = reinterpret_cast<int*>(smem + L::red);
  const int warp = tid / 32;
  if (tid % 32 < 16) {
#pragma unroll
    for (int m = 0; m < kM; ++m)
      *reinterpret_cast<int4*>(part + (warp * kM + m) * kDecBN + 4 * c) =
          make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  for (int i = tid; i < kM * kDecBN; i += kDecThreads) {
    int s = 0;
#pragma unroll
    for (int wp = 0; wp < 8; ++wp) s += part[wp * kM * kDecBN + i];
    red[i] = s;
  }
  cluster.sync();
  for (int i = rank * kDecThreads + tid; i < M * kDecBN;
       i += n_splits * kDecThreads) {
    int v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      v[s] = s < n_splits ? cluster.map_shared_rank(red, s)[i] : 0;
    int sum = 0;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) sum += v[s];
    const int64_t gm = i / kDecBN, gn = n0 + i % kDecBN;
    if (gn < N)
      out[gm * N + gn] = epilogue(sum, scale_f32(x_scale, gm), w_scale[gn]);
  }
  cluster.sync();  // every block's sums outlive the others' reads
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The kernel a shape runs: plan[0] is 0 for the decode path and 1 for the
// tensor-core path, plan[1] the rows of a block's tile (x rows staged on
// the decode path), plan[2] the blocks of a cluster over K.
void make_plan(int64_t M, int64_t K, int64_t N, int (&plan)[3]) {
  if (M <= kDecodeMaxM) {
    const int64_t tiles = cdiv(K, kDecTK);
    int rows = 1;
    while (rows < M) rows *= 2;
    plan[0] = 0;
    plan[1] = rows;
    plan[2] = static_cast<int>(tiles < 1 ? 1
                               : tiles < kMaxSplits ? tiles : kMaxSplits);
    return;
  }
  const int64_t cols = cdiv(N, kTcBN), k_tiles = cdiv(K, kTcBK);
  const int bm =
      cdiv(M, kTcBigBM) * cols >= kTcMinTiles ? kTcBigBM : kTcSmallBM;
  int splits = 1;
  while (cdiv(M, bm) * cols * splits < kTcMinBlocks
         && 2 * splits <= kTcMaxSplits
         && k_tiles >= 2 * splits * kTcStages)
    splits *= 2;
  plan[0] = 1;
  plan[1] = bm;
  plan[2] = splits;
}

// A launch of `kernel` in clusters of `cluster` blocks, or as plain blocks
// without kCluster (a kernel that syncs its cluster needs kCluster).
template <bool kCluster = true, typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, dim3 grid, int threads, size_t smem,
                   dim3 cluster, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kM, bool kVec, typename XS>
int launch_decode(const int8_t* x, const int8_t* w, const XS* xs,
                  const float* ws, float* out, int64_t M, int64_t K,
                  int64_t N, int splits, cudaStream_t stream) {
  const unsigned s = static_cast<unsigned>(splits);
  return launch_cluster(i8mm_decode_kernel<kM, kVec, XS>,
                        dim3(static_cast<unsigned>(cdiv(N, kDecBN)), s),
                        kDecThreads, DecSmem<kM>::bytes, dim3(1, s, 1),
                        stream, x, w, xs, ws, out, M, K, N);
}

template <int kBM, bool kSplit, bool kVec, typename XS>
int launch_tc(const int8_t* x, const int8_t* w, const XS* xs,
              const float* ws, float* out, int64_t M, int64_t K, int64_t N,
              int splits, cudaStream_t stream) {
  const unsigned s = static_cast<unsigned>(splits);
  return launch_cluster<kSplit>(
      i8mm_tc_kernel<kBM, kSplit, kVec, XS>,
      dim3(static_cast<unsigned>(cdiv(N, kTcBN)),
           static_cast<unsigned>(cdiv(M, kBM)), s),
      kTcThreads, TcSmem<kBM>::bytes, dim3(1, 1, s), stream, x, w, xs, ws,
      out, M, K, N);
}

template <bool kVec, typename XS>
int launch(const int8_t* x, const int8_t* w, const XS* xs, const float* ws,
           float* out, int64_t M, int64_t K, int64_t N, cudaStream_t stream) {
  int plan[3];
  make_plan(M, K, N, plan);
  const int rows = plan[1], splits = plan[2];
  if (plan[0] == 0) {
    static_assert(kDecodeMaxM == 16, "the row buckets end at kDecodeMaxM");
    switch (rows) {
      case 1: return launch_decode<1, kVec>(x, w, xs, ws, out, M, K, N,
                                            splits, stream);
      case 2: return launch_decode<2, kVec>(x, w, xs, ws, out, M, K, N,
                                            splits, stream);
      case 4: return launch_decode<4, kVec>(x, w, xs, ws, out, M, K, N,
                                            splits, stream);
      case 8: return launch_decode<8, kVec>(x, w, xs, ws, out, M, K, N,
                                            splits, stream);
      default: return launch_decode<16, kVec>(x, w, xs, ws, out, M, K, N,
                                              splits, stream);
    }
  }
  if (rows == kTcBigBM)
    return splits > 1 ? launch_tc<kTcBigBM, true, kVec>(x, w, xs, ws, out, M,
                                                        K, N, splits, stream)
                      : launch_tc<kTcBigBM, false, kVec>(x, w, xs, ws, out,
                                                         M, K, N, 1, stream);
  return splits > 1 ? launch_tc<kTcSmallBM, true, kVec>(x, w, xs, ws, out, M,
                                                        K, N, splits, stream)
                    : launch_tc<kTcSmallBM, false, kVec>(x, w, xs, ws, out, M,
                                                         K, N, 1, stream);
}

template <typename XS>
int dispatch(const int8_t* x, const int8_t* w, const void* xs,
             const float* ws, float* out, int64_t M, int64_t K, int64_t N,
             cudaStream_t stream) {
  // 16-byte copies need every chunk of a row aligned and wholly in or out
  // of the matrix
  const bool vec = K % 16 == 0 && N % 16 == 0
                   && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const XS* s = static_cast<const XS*>(xs);
  return vec ? launch<true>(x, w, s, ws, out, M, K, N, stream)
             : launch<false>(x, w, s, ws, out, M, K, N, stream);
}

}  // namespace

extern "C" int i8mm_forward(const void* x, const void* w, const void* x_scale,
                            const void* w_scale, void* out, int64_t M,
                            int64_t K, int64_t N, int xs_bf16,
                            void* stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* ws = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xs_bf16)
    return dispatch<__nv_bfloat16>(xp, wp, x_scale, ws, o, M, K, N, s);
  return dispatch<float>(xp, wp, x_scale, ws, o, M, K, N, s);
}

extern "C" void i8mm_plan(int64_t M, int64_t K, int64_t N, int* plan) {
  int p[3];
  make_plan(M, K, N, p);
  for (int i = 0; i < 3; ++i) plan[i] = p[i];
}
