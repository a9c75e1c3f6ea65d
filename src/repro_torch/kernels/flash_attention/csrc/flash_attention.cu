// Prefill flash attention for Hopper (sm_90a), plain C interface.
//
// K6 fa_forward replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (_flash_kernel): causal or sliding-window attention with an online
// softmax, f32 out.  What it computes is the TPU kernel's; the schedule is
// not carried over.  The TPU walks the key blocks on a sequential grid
// axis and keeps (m, l, acc) in VMEM scratch; here one CUDA block owns one
// (batch * head, 64-query tile) and loops over the 64-key tiles itself,
// keeping m, l and its share of acc in registers.
//
// fa_forward chooses between two hand-written kernels by input type:
//
//  * bf16 (the serving path) runs on the tensor cores (flash_bf16_kernel).
//  * float32 (the f32 card-vs-CPU checks) runs as f32 FMAs on the CUDA
//    cores (flash_f32_kernel), which keeps f32 inputs exact.
//
// What both share:
//
//  * Key tiles wholly outside the causal / window band are skipped (the
//    TPU kernel's `live` test), so causal attention does about half the
//    work and a window only its diagonal band.
//  * GQA: the block reads kv head h / G directly instead of a repeated
//    copy of K and V (the reference's ops.py materialises jnp.repeat).
//  * Layout: q (B, S, H, D) and k/v (B, S, Hkv, D) are read through their
//    batch, sequence and head strides (the last dim contiguous), so no
//    transpose copy is made.  The ragged end of the sequence is masked
//    here, with no padding to a tile multiple.
//  * Guards as in the TPU kernel: masked scores are -1e30, a running max
//    that is still -1e30 is treated as 0 in the exponent and masked
//    probabilities are exactly 0, so an all-masked row gives acc = l = 0,
//    and the output is acc / max(l, 1e-30): no NaN.  The output is f32
//    (B, S, H, D); the caller casts back to its dtype.
//
// Bound on this card: at the serving shape (B = 1, S = 512, H = 16,
// Hkv = 8, D = 128, bf16, causal) the kernel must move q, k, v and the f32
// output, 8.4 MB (2.5 us at 3.35 TB/s), and do 1.07 GFLOP of QK^T and PV
// (1.1 us at the bf16 tensor-core rate, 16 us at the 67 TFLOP/s f32
// rate).  So the f32 design is bound by its arithmetic, and the bf16
// kernel moves both products onto the tensor cores:
//
//  * mma.sync.m16n8k16 (bf16 in, f32 accumulate) with ldmatrix from
//    shared memory.  A warp owns 16 query rows; S = Q K^T comes out in
//    registers, the online softmax runs on those registers in f32, and P
//    goes back into the tensor cores from registers as the A operand of
//    PV, with V read through ldmatrix.trans.  (wgmma would reach more of
//    the card's rate, but its shared-memory descriptors cannot be checked
//    without the card; mma.sync already lifts the 16 us f32 floor.)
//  * Numerics held to 1e-4 of max |out| against the f32 plain version:
//    q and k enter the products unscaled and sm_scale multiplies the f32
//    scores (never folded into a bf16 q); P enters PV as two bf16 terms,
//    hi = bf16(p) and lo = bf16(p - hi), both into the same f32
//    accumulator (about 2^-17 relative, where one bf16 P errs by 2^-9).
//    The second PV product is one more tensor-core pass per key tile.
//    The exponentials are __expf (ex2.approx, about 2^-21 relative), far
//    inside the tolerance and cheaper than expf on a latency-bound loop.
//  * K and V tiles arrive by 16-byte cp.async into a ring of two stages,
//    so the next tile's load overlaps this tile's math.  Rows are padded
//    by 16 bytes, so ldmatrix's eight row addresses hit distinct banks.
//  * The causal diagonal: every block fits in one wave, so the block with
//    the longest key walk sets the time.  The query tiles start heaviest
//    first (blockIdx.x reversed), and each block has three walkers, three
//    warpgroups that take the live key tiles in turn, each with its own
//    (m, l, acc) and its own ring, merged through shared memory at the
//    end with the online softmax's rescaling.  The longest walk, 8 tiles
//    at S = 512, becomes 3 steps, and an SM holds twelve warps instead of
//    four; a step is bound by instruction latency (one or three warps per
//    scheduler), not by the tensor cores.  Three is a measured choice: one
//    walker took 1.3x as long at the serving shape, two 1.04x (PERF.md).
//
// The entry points launch on the caller's stream and return
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // keys of a tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  float* lse;   // (b, h, s) row log-sum-exp for the backward, or null
  int64_t s, h, hkv;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  float sm_scale;
  int causal;
  int64_t window;
};

// Whether key tile [k_lo, k_lo + kBK) holds a key that some query of
// [q_lo, q_lo + kBQ) attends to (the TPU kernel's `live`).
__device__ __forceinline__ bool tile_live(const Params& p, int64_t q_lo,
                                          int64_t k_lo) {
  bool live = true;
  if (p.causal) live = k_lo <= q_lo + kBQ - 1;
  if (p.window) live = live && (k_lo + kBK - 1 > q_lo - p.window);
  return live;
}

// ---------------------------------------------------------------------------
// float32: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // 16 x 16: ty owns 4 rows, tx 1/16 of cols

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

// One block per (64-query tile, batch * head).  A 64x64 score tile is 16
// scores a thread, a 64xD output tile 4 x D/16 accumulators a thread; q
// (pre-scaled by sm_scale in f32), K, V and P are staged in shared memory.
template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_f32_kernel(Params p) {
  constexpr int C = D / 16;  // output columns of a thread
  extern __shared__ float smem_f32[];
  float* qs = smem_f32;                // kBQ x (D + 1), pre-scaled
  float* ks = qs + kBQ * (D + 1);      // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);      // kBK x D
  float* ps = vs + kBK * D;            // kBQ x (kBK + 1)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.h;
  const int64_t head = bh % p.h;
  const int64_t kv_head = head / (p.h / p.hkv);
  const int64_t q_lo = static_cast<int64_t>(blockIdx.x) * kBQ;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb
                    + head * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb
                    + kv_head * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb
                    + kv_head * p.v_sh;

  for (int i = tid; i < kBQ * D; i += kF32Threads) {
    const int r = i / D, c = i % D;
    const int64_t pos = q_lo + r;
    qs[r * (D + 1) + c] = pos < p.s ? qg[pos * p.q_ss + c] * p.sm_scale : 0.f;
  }

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  }

  const int64_t n_tiles = (p.s + kBK - 1) / kBK;
  for (int64_t kt = 0; kt < n_tiles; ++kt) {
    const int64_t k_lo = kt * kBK;
    if (!tile_live(p, q_lo, k_lo)) continue;  // uniform across the block

    __syncthreads();  // Q is in place; the previous K, V, P are consumed
    for (int i = tid; i < kBK * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const int64_t pos = k_lo + r;
      const bool in = pos < p.s;
      ks[r * (D + 1) + c] = in ? kg[pos * p.k_ss + c] : 0.f;
      vs[r * D + c] = in ? vg[pos * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q_lo + ty * 4 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k_lo + tx + 16 * j;
        bool ok = kpos < p.s;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window) ok = ok && kpos > qpos - p.window;
        if (!ok) sc[i][j] = kNegInf;
        row_max = fmaxf(row_max, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(row_max));
      const float m_safe = m_new > kNegInf / 2 ? m_new : 0.f;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = sc[i][j] > kNegInf / 2 ? expf(sc[i][j] - m_safe)
                                                : 0.f;
        ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = pr;
        row_sum += pr;
      }
      const float alpha = m[i] > kNegInf / 2 ? expf(m[i] - m_safe) : 0.f;
      l[i] = l[i] * alpha + group16_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < C; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qpos = q_lo + ty * 4 + i;
    if (qpos >= p.s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = p.out + ((b * p.s + qpos) * p.h + head) * D;
#pragma unroll
    for (int j = 0; j < C; ++j) row[tx + 16 * j] = acc[i][j] / denom;
    if (p.lse && tx == 0)
      p.lse[(b * p.h + head) * p.s + qpos] =
          (m[i] > kNegInf / 2 ? m[i] : 0.f) + logf(denom);
  }
}

template <int D>
int launch_f32(const Params& p, int64_t bh, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>();
  // The attribute belongs to the current device, so it is set on every
  // launch (a cheap call) rather than once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.s + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bh));
  flash_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpsPerWalker = 4;   // 4 x 16 = kBQ query rows
constexpr int kWalkerThreads = 32 * kWarpsPerWalker;
constexpr int kWalkers = 3;  // key-tile walkers (warpgroups) of a block

// Shared memory of the bf16 kernel: the Q tile, then for each walker a
// ring of two stages of (K tile, V tile).  Rows are D bf16 plus 16 bytes
// of padding.  After the walk the first ring is reused for the merge.
template <int D>
struct Bf16Smem {
  static constexpr int kRow = D * 2 + 16;          // bytes of a padded row
  static constexpr int kTile = kBQ * kRow;         // bytes of a 64-row tile
  static constexpr int kStages = 2;
  static __host__ __device__ constexpr size_t kv(int walker, int stage,
                                                 int which) {
    return static_cast<size_t>(kTile)
           * (1 + (walker * kStages + stage) * 2 + which);
  }
  static constexpr size_t kBytes =
      static_cast<size_t>(kTile) * (1 + kWalkers * kStages * 2);
};

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

// A barrier of one walker's 128 threads (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void walker_sync(int walker) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + walker), "n"(kWalkerThreads));
}

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

// p as hi = bf16(p) and lo = bf16(p - hi) for a pair of columns, each
// pair packed with the first (lower) column in the low half.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// One 64-row tile of a (B, S, heads, D) tensor into padded shared rows by
// the walker's 128 threads; rows at or past s are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride_s, int64_t lo,
                                          int64_t s, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  for (int i = tid; i < kBQ * kChunks; i += kWalkerThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int64_t pos = lo + r;
    const bool in = pos < s;
    cp_async16(dst + r * Bf16Smem<D>::kRow + c * 16,
               src + (in ? pos * stride_s : 0) + c * 8, in);
  }
}

// Grid (query tiles, B * H), kWalkers x 128 threads.  Walker w of a block
// walks the live key tiles first + w, first + w + kWalkers, ...; warp i of
// a walker owns query rows 16 i .. 16 i + 15 of the block's tile.  Thread
// (warp, lane) holds rows r0 = 16 i + lane / 4 and r0 + 8 and, of each
// 8-column slice of S or O, the columns 2 (lane % 4) and 2 (lane % 4) + 1.
template <int D>
__global__ void __launch_bounds__(kWalkerThreads * kWalkers)
    flash_bf16_kernel(Params p) {
  using L = Bf16Smem<D>;
  constexpr int kND = D / 8;    // 8-column slices of O
  constexpr int kKD = D / 16;   // 16-deep steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem[];

  const int walker = threadIdx.x / kWalkerThreads;
  const int wtid = threadIdx.x % kWalkerThreads;
  const int warp = wtid / 32, lane = wtid % 32;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.h;
  const int64_t head = bh % p.h;
  const int64_t kv_head = head / (p.h / p.hkv);
  // the diagonal's heaviest query tiles first
  const int64_t q_lo =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBQ;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q)
                            + b * p.q_sb + head * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k)
                            + b * p.k_sb + kv_head * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v)
                            + b * p.v_sb + kv_head * p.v_sh;

  // the live key tiles form one run [first, last]
  const int64_t n_tiles = (p.s + kBK - 1) / kBK;
  int64_t first = 0, last = n_tiles - 1;
  while (first < n_tiles && !tile_live(p, q_lo, first * kBK)) ++first;
  while (last >= first && !tile_live(p, q_lo, last * kBK)) --last;
  const int64_t mine = first + walker <= last
                           ? (last - first - walker) / kWalkers + 1 : 0;

  // Q (every thread) and this walker's first K, V tile
  {
    constexpr int kChunks = D / 8;
    for (int i = threadIdx.x; i < kBQ * kChunks;
         i += kWalkerThreads * kWalkers) {
      const int r = i / kChunks, c = i % kChunks;
      const int64_t pos = q_lo + r;
      const bool in = pos < p.s;
      cp_async16(smem + r * L::kRow + c * 16,
                 qg + (in ? pos * p.q_ss : 0) + c * 8, in);
    }
    cp_async_commit();
  }
  if (mine > 0) {
    const int64_t k_lo = (first + walker) * kBK;
    load_tile<D>(smem + L::kv(walker, 0, 0), kg, p.k_ss, k_lo, p.s, wtid);
    load_tile<D>(smem + L::kv(walker, 0, 1), vg, p.v_ss, k_lo, p.s, wtid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane / 4, t = lane % 4;
  const int64_t row0 = q_lo + warp * 16 + g;   // and row0 + 8
  float o[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k16): A from Q rows, B from K rows, B from V rows transposed
  const unsigned char* q_lane =
      smem + (warp * 16 + lane % 16) * L::kRow + (lane / 16) * 16;
  const int k_lane_off = (lane % 8 + (lane / 16) * 8) * L::kRow
                         + ((lane / 8) % 2) * 16;
  const int v_lane_off = (lane % 8 + ((lane / 8) % 2) * 8) * L::kRow
                         + (lane / 16) * 16;

  for (int64_t j = 0; j < mine; ++j) {
    const int stage = static_cast<int>(j % 2);
    const int64_t k_lo = (first + walker + j * kWalkers) * kBK;
    if (j + 1 < mine) {
      const int64_t next = k_lo + kWalkers * kBK;
      load_tile<D>(smem + L::kv(walker, 1 - stage, 0), kg, p.k_ss, next,
                   p.s, wtid);
      load_tile<D>(smem + L::kv(walker, 1 - stage, 1), vg, p.v_ss, next,
                   p.s, wtid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    walker_sync(walker);
    const unsigned char* ks = smem + L::kv(walker, stage, 0);
    const unsigned char* vs = smem + L::kv(walker, stage, 1);

    // S = Q K^T: 16 rows x 64 keys, eight 8-key slices
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    // (mma and ldmatrix are volatile asm and keep the order written: each
    // step loads its fragments first, then issues independent products)
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t a[4], bk[4][4];
      ldsm_x4(a, q_lane + kk * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldsm_x4(bk[np], ks + k_lane_off + np * 16 * L::kRow + kk * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        mma_bf16(sc[2 * np], a, bk[np][0], bk[np][1]);
        mma_bf16(sc[2 * np + 1], a, bk[np][2], bk[np][3]);
      }
    }

    // scale in f32, mask, online softmax on the registers
    const bool full = k_lo + kBK <= p.s
                      && (!p.causal || k_lo + kBK - 1 <= q_lo)
                      && (!p.window || k_lo > q_lo + kBQ - 1 - p.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * p.sm_scale;
        if (!full) {
          const int64_t qpos = row0 + (e / 2) * 8;
          const int64_t kpos = k_lo + n * 8 + 2 * t + (e % 2);
          bool ok = kpos < p.s;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window) ok = ok && kpos > qpos - p.window;
          if (!ok) x = kNegInf;
        }
        sc[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new > kNegInf / 2 ? m_new : 0.f;
      alpha[r] = m[r] > kNegInf / 2 ? __expf(m[r] - m_safe[r]) : 0.f;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        const float pr = x > kNegInf / 2 ? __expf(x - m_safe[e / 2]) : 0.f;
        sc[n][e] = pr;
        l[e / 2] += pr;
      }
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, with P = hi + lo from the registers as the A operand; the
    // hi products of a group of 8 columns slices go first, then the lo
    // ones, so no product waits on the one just before it
    constexpr int kGroup = kND < 8 ? kND : 8;   // O slices per V load group
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], hi[0], lo[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], hi[1], lo[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n0 = 0; n0 < kND; n0 += kGroup) {
        uint32_t bv[kGroup / 2][4];
#pragma unroll
        for (int dp = 0; dp < kGroup / 2; ++dp)
          ldsm_x4_trans(bv[dp], vs + v_lane_off + kk * 16 * L::kRow
                                    + (n0 / 2 + dp) * 32);
#pragma unroll
        for (int dp = 0; dp < kGroup / 2; ++dp) {
          mma_bf16(o[n0 + 2 * dp], hi, bv[dp][0], bv[dp][1]);
          mma_bf16(o[n0 + 2 * dp + 1], hi, bv[dp][2], bv[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < kGroup / 2; ++dp) {
          mma_bf16(o[n0 + 2 * dp], lo, bv[dp][0], bv[dp][1]);
          mma_bf16(o[n0 + 2 * dp + 1], lo, bv[dp][2], bv[dp][3]);
        }
      }
    }
    walker_sync(walker);  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  {
    // every walker but the first leaves (m, l, acc) in the first ring, in
    // its own fragment order; the first merges them into its registers
    float* mail = reinterpret_cast<float*>(smem + L::kv(0, 0, 0));
    constexpr int kRec = 4 * kND + 4;   // floats of one thread's record
    static_assert(kRec * kWalkerThreads * 4 * (kWalkers - 1)
                      <= 4 * L::kTile, "the merge must fit the first ring");
    __syncthreads();  // every walker is done with its ring
    if (walker > 0) {
      float* rec = mail + (walker - 1) * kRec * kWalkerThreads;
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rec[(n * 4 + e) * kWalkerThreads + wtid] = o[n][e];
      rec[(4 * kND + 0) * kWalkerThreads + wtid] = m[0];
      rec[(4 * kND + 1) * kWalkerThreads + wtid] = m[1];
      rec[(4 * kND + 2) * kWalkerThreads + wtid] = l[0];
      rec[(4 * kND + 3) * kWalkerThreads + wtid] = l[1];
    }
    __syncthreads();
    if (walker > 0) return;
#pragma unroll
    for (int w = 1; w < kWalkers; ++w) {
      const float* rec = mail + (w - 1) * kRec * kWalkerThreads;
      float a0[2], a1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = rec[(4 * kND + r) * kWalkerThreads + wtid];
        const float l1 = rec[(4 * kND + 2 + r) * kWalkerThreads + wtid];
        const float m_new = fmaxf(m[r], m1);
        const float ms = m_new > kNegInf / 2 ? m_new : 0.f;
        a0[r] = m[r] > kNegInf / 2 ? __expf(m[r] - ms) : 0.f;
        a1[r] = m1 > kNegInf / 2 ? __expf(m1 - ms) : 0.f;
        l[r] = l[r] * a0[r] + l1 * a1[r];
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = o[n][e] * a0[e / 2]
                    + rec[(n * 4 + e) * kWalkerThreads + wtid] * a1[e / 2];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qpos = row0 + r * 8;
    if (qpos >= p.s) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* row = p.out + ((b * p.s + qpos) * p.h + head) * D;
#pragma unroll
    for (int n = 0; n < kND; ++n)
      *reinterpret_cast<float2*>(row + n * 8 + 2 * t) =
          make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
    if (p.lse && t == 0)
      p.lse[(b * p.h + head) * p.s + qpos] =
          (m[r] > kNegInf / 2 ? m[r] : 0.f) + logf(denom);
  }
}

template <int D>
int launch_bf16(const Params& p, int64_t bh, cudaStream_t stream) {
  const size_t smem = Bf16Smem<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.s + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bh));
  flash_bf16_kernel<D><<<grid, kWalkerThreads * kWalkers, smem, stream>>>(p);
  return cudaGetLastError();
}

int dispatch(const Params& p, int64_t bh, int64_t d, int is_bf16,
             cudaStream_t s) {
  if (!is_bf16) {
    switch (d) {
      case 16: return launch_f32<16>(p, bh, s);
      case 32: return launch_f32<32>(p, bh, s);
      case 64: return launch_f32<64>(p, bh, s);
      case 128: return launch_f32<128>(p, bh, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (d) {
    case 16: return launch_bf16<16>(p, bh, s);
    case 32: return launch_bf16<32>(p, bh, s);
    case 64: return launch_bf16<64>(p, bh, s);
    case 128: return launch_bf16<128>(p, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// backward: FlashAttention-2's, as f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------
//
// The reference trains attention through its plain-JAX chunked softmax,
// differentiated by XLA; no Pallas kernel has a backward.  Here the
// backward of K6 is three kernels that recompute P from the forward's lse
// instead of storing it:
//
//  * bwd_delta_kernel: D_i = sum_d dO_id O_id, one warp a row;
//  * bwd_dkdv_kernel: one block per (batch, KV head, 64-key tile) loops
//    over the live 64-query tiles of every query head of its group and
//    keeps dK and dV for its keys in registers:
//      P = exp(S * scale - lse), dV += P^T dO, dS = P (dO V^T - D),
//      dK += dS^T Q (times scale at the end);
//  * bwd_dq_kernel: one block per (batch, query head, 64-query tile)
//    loops over the live key tiles: dQ += dS K (times scale).
//
// No atomics: every output element is summed by one thread in a fixed
// order, so a rerun gives the same bits.  Tiles wholly outside the causal
// or window band are skipped as the forward skips them.
//
// Numerics: bf16 inputs are widened exactly to f32 in shared memory, and
// every product and sum is f32, so the only bf16 rounding is the final
// store of dq, dk and dv.  The exponentials are expf (not __expf): the
// f32 case is held to 1e-5 of each output's largest magnitude.
//
// Bound on this card: at the training shape (B = 8, S = 512, H = 16,
// Hkv = 8, D = 128, bf16, causal) the backward does 2.5x the forward's
// 8.6 GFLOP; at the bf16 tensor-core rate that is 22 us, against 46 us
// to move q, k, v, o, dO, lse, dq, dk and dv.  This design recomputes S
// and dP^T twice (once per kernel) on the CUDA cores at the f32 rate, so
// it is bound by its arithmetic far above either figure; moving the five
// products onto the tensor cores (mma.sync or wgmma, as the forward) is
// the next step.

constexpr int kBwdThreads = 256;  // 16 x 16, as the f32 forward

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* o;      // (b, s, h, d) f32, contiguous
  const float* dout;   // (b, s, h, d) f32, contiguous
  const float* lse;    // (b, h, s)
  float* delta;        // (b, h, s), written by bwd_delta_kernel
  void* dq;            // (b, s, h, d) of the input type, contiguous
  void* dk;            // (b, s, hkv, d)
  void* dv;            // (b, s, hkv, d)
  int64_t s, h, hkv;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  float sm_scale;
  int causal;
  int64_t window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool bwd_tile_live(const BwdParams& p,
                                              int64_t q_lo, int64_t k_lo) {
  bool live = true;
  if (p.causal) live = k_lo <= q_lo + kBQ - 1;
  if (p.window) live = live && (k_lo + kBK - 1 > q_lo - p.window);
  return live;
}

__device__ __forceinline__ bool bwd_pair_ok(const BwdParams& p, int64_t qpos,
                                            int64_t kpos) {
  bool ok = qpos < p.s && kpos < p.s;
  if (p.causal) ok = ok && qpos >= kpos;
  if (p.window) ok = ok && kpos > qpos - p.window;
  return ok;
}

// A 64-row tile of a (B, S, heads, D) tensor of type T, rows [lo, lo + 64)
// from base (batch and head applied), widened into f32 rows of D + 1.
template <typename T, int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* base,
                                              int64_t stride_s, int64_t lo,
                                              int64_t s) {
  for (int i = threadIdx.x; i < 64 * D; i += kBwdThreads) {
    const int r = i / D, c = i % D;
    const int64_t pos = lo + r;
    dst[r * (D + 1) + c] = pos < s ? to_f32(base[pos * stride_s + c]) : 0.f;
  }
}

// D_i = dO_i . O_i for every (b, i, head) row, one warp a row.
__global__ void __launch_bounds__(kBwdThreads)
    bwd_delta_kernel(BwdParams p, int64_t rows, int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBwdThreads / 32)
                      + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const float* o = p.o + row * d;
  const float* g = p.dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(o[c], g[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t b = row / (p.s * p.h);
    const int64_t i = (row / p.h) % p.s;
    const int64_t head = row % p.h;
    p.delta[(b * p.h + head) * p.s + i] = acc;
  }
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  // four 64 x (D + 1) tiles, two 64 x 65 score tiles, lse and D of 64 rows
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * (64 + 1) + 2 * 64);
}

// Grid (key tiles, B * Hkv).  Thread (ty, tx) owns keys 4 ty .. 4 ty + 3
// of the tile and, of their dK and dV rows, the columns tx + 16 j.  Scores
// are kept transposed (keys x queries) so that each thread's P^T and dS^T
// rows are the keys it accumulates.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) bwd_dkdv_kernel(BwdParams p) {
  constexpr int C = D / 16;
  extern __shared__ float smem_bwd[];
  float* ks = smem_bwd;                 // 64 x (D + 1)
  float* vs = ks + 64 * (D + 1);        // 64 x (D + 1)
  float* qs = vs + 64 * (D + 1);        // 64 x (D + 1)
  float* dos = qs + 64 * (D + 1);       // 64 x (D + 1)
  float* pt = dos + 64 * (D + 1);       // P^T, 64 keys x 65
  float* dst = pt + 64 * 65;            // dS^T, 64 keys x 65
  float* lse_s = dst + 64 * 65;         // 64
  float* del_s = lse_s + 64;            // 64

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t bk = blockIdx.y;
  const int64_t b = bk / p.hkv;
  const int64_t kv_head = bk % p.hkv;
  const int64_t group = p.h / p.hkv;
  const int64_t k_lo = static_cast<int64_t>(blockIdx.x) * kBK;

  load_rows_f32<T, D>(ks, static_cast<const T*>(p.k) + b * p.k_sb
                              + kv_head * p.k_sh, p.k_ss, k_lo, p.s);
  load_rows_f32<T, D>(vs, static_cast<const T*>(p.v) + b * p.v_sb
                              + kv_head * p.v_sh, p.v_ss, k_lo, p.s);

  float dk[4][C], dv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int64_t n_qt = (p.s + kBQ - 1) / kBQ;
  for (int64_t g = 0; g < group; ++g) {
    const int64_t head = kv_head * group + g;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + head * p.q_sh;
    const float* dog = p.dout + (b * p.s * p.h + head) * D;
    const float* lg = p.lse + (b * p.h + head) * p.s;
    const float* dg = p.delta + (b * p.h + head) * p.s;
    for (int64_t qt = 0; qt < n_qt; ++qt) {
      const int64_t q_lo = qt * kBQ;
      if (!bwd_tile_live(p, q_lo, k_lo)) continue;  // uniform in the block
      __syncthreads();  // the previous tile's Q, dO, P^T, dS^T are consumed
      load_rows_f32<T, D>(qs, qg, p.q_ss, q_lo, p.s);
      load_rows_f32<float, D>(dos, dog, p.h * D, q_lo, p.s);
      if (tid < 64) {
        const int64_t pos = q_lo + tid;
        lse_s[tid] = pos < p.s ? lg[pos] : 0.f;
        del_s[tid] = pos < p.s ? dg[pos] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: keys 4 ty + i, queries tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < D; ++c) {
        float kv_[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv_[i] = ks[(ty * 4 + i) * (D + 1) + c];
          vv[i] = vs[(ty * 4 + i) * (D + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 16 * j) * (D + 1) + c];
          dov[j] = dos[(tx + 16 * j) * (D + 1) + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(kv_[i], qv[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t kpos = k_lo + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j;
          const float pr = bwd_pair_ok(p, q_lo + qi, kpos)
                               ? expf(sc[i][j] * p.sm_scale - lse_s[qi])
                               : 0.f;
          pt[(ty * 4 + i) * 65 + qi] = pr;
          dst[(ty * 4 + i) * 65 + qi] = pr * (dp[i][j] - del_s[qi]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
      for (int qi = 0; qi < kBQ; ++qi) {
        float pv[4], sv[4], dov[C], qv[C];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt[(ty * 4 + i) * 65 + qi];
          sv[i] = dst[(ty * 4 + i) * 65 + qi];
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          dov[j] = dos[qi * (D + 1) + tx + 16 * j];
          qv[j] = qs[qi * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) {
            dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
            dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t kpos = k_lo + ty * 4 + i;
    if (kpos >= p.s) continue;
    T* dkr = static_cast<T*>(p.dk) + ((b * p.s + kpos) * p.hkv + kv_head) * D;
    T* dvr = static_cast<T*>(p.dv) + ((b * p.s + kpos) * p.hkv + kv_head) * D;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      store(dkr + tx + 16 * j, dk[i][j] * p.sm_scale);
      store(dvr + tx + 16 * j, dv[i][j]);
    }
  }
}

// Grid (query tiles, B * H).  Thread (ty, tx) owns queries 4 ty .. 4 ty + 3
// and, of their dQ rows, the columns tx + 16 j.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) bwd_dq_kernel(BwdParams p) {
  constexpr int C = D / 16;
  extern __shared__ float smem_bwd[];
  float* qs = smem_bwd;                 // 64 x (D + 1)
  float* dos = qs + 64 * (D + 1);       // 64 x (D + 1)
  float* ks = dos + 64 * (D + 1);       // 64 x (D + 1)
  float* vs = ks + 64 * (D + 1);        // 64 x (D + 1)
  float* dss = vs + 64 * (D + 1);       // dS, 64 queries x 65
  float* lse_s = dss + 2 * 64 * 65;     // 64 (one score tile left unused)
  float* del_s = lse_s + 64;            // 64

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.h;
  const int64_t head = bh % p.h;
  const int64_t kv_head = head / (p.h / p.hkv);
  const int64_t q_lo = static_cast<int64_t>(blockIdx.x) * kBQ;

  load_rows_f32<T, D>(qs, static_cast<const T*>(p.q) + b * p.q_sb
                              + head * p.q_sh, p.q_ss, q_lo, p.s);
  load_rows_f32<float, D>(dos, p.dout + (b * p.s * p.h + head) * D,
                          p.h * D, q_lo, p.s);
  if (tid < 64) {
    const int64_t pos = q_lo + tid;
    lse_s[tid] = pos < p.s ? p.lse[(b * p.h + head) * p.s + pos] : 0.f;
    del_s[tid] = pos < p.s ? p.delta[(b * p.h + head) * p.s + pos] : 0.f;
  }
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kv_head * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kv_head * p.v_sh;

  float dq[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) dq[i][j] = 0.f;

  const int64_t n_kt = (p.s + kBK - 1) / kBK;
  for (int64_t kt = 0; kt < n_kt; ++kt) {
    const int64_t k_lo = kt * kBK;
    if (!bwd_tile_live(p, q_lo, k_lo)) continue;  // uniform in the block
    __syncthreads();  // Q, dO are in place; the previous K, V, dS consumed
    load_rows_f32<T, D>(ks, kg, p.k_ss, k_lo, p.s);
    load_rows_f32<T, D>(vs, vg, p.v_ss, k_lo, p.s);
    __syncthreads();

    // S and dP: queries 4 ty + i, keys tx + 16 j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qv[4], dov[4], kv_[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * (D + 1) + c];
        dov[i] = dos[(ty * 4 + i) * (D + 1) + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv_[j] = ks[(tx + 16 * j) * (D + 1) + c];
        vv[j] = vs[(tx + 16 * j) * (D + 1) + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv_[j], sc[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = tx + 16 * j;
        const float pr = bwd_pair_ok(p, q_lo + qi, k_lo + ki)
                             ? expf(sc[i][j] * p.sm_scale - lse_s[qi])
                             : 0.f;
        dss[qi * 65 + ki] = pr * (dp[i][j] - del_s[qi]);
      }
    }
    __syncthreads();

    for (int ki = 0; ki < kBK; ++ki) {
      float sv[4], kv_[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(ty * 4 + i) * 65 + ki];
#pragma unroll
      for (int j = 0; j < C; ++j) kv_[j] = ks[ki * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) dq[i][j] = fmaf(sv[i], kv_[j], dq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qpos = q_lo + ty * 4 + i;
    if (qpos >= p.s) continue;
    T* row = static_cast<T*>(p.dq) + ((b * p.s + qpos) * p.h + head) * D;
#pragma unroll
    for (int j = 0; j < C; ++j) store(row + tx + 16 * j, dq[i][j] * p.sm_scale);
  }
}

template <typename T, int D>
int launch_bwd(const BwdParams& p, int64_t b, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t rows = b * p.s * p.h;
  const int64_t warps = kBwdThreads / 32;
  bwd_delta_kernel<<<static_cast<unsigned>((rows + warps - 1) / warps),
                     kBwdThreads, 0, stream>>>(p, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned n_tiles = static_cast<unsigned>((p.s + 63) / 64);
  bwd_dkdv_kernel<T, D><<<dim3(n_tiles, static_cast<unsigned>(b * p.hkv)),
                          kBwdThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D><<<dim3(n_tiles, static_cast<unsigned>(b * p.h)),
                        kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const BwdParams& p, int64_t b, int64_t d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_bwd<T, 16>(p, b, s);
    case 32: return launch_bwd<T, 32>(p, b, s);
    case 64: return launch_bwd<T, 64>(p, b, s);
    case 128: return launch_bwd<T, 128>(p, b, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (b, s, h, d), k/v (b, s, hkv, d) of float32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), each with the given batch/sequence/head strides in
// elements and a contiguous last dim; out (b, s, h, d) contiguous f32;
// lse, when not null, (b, h, s) contiguous f32: each row's log-sum-exp of
// its scaled scores, m + log(l), which the backward reads.
// d in {16, 32, 64, 128}, h % hkv == 0.  window 0 means full attention.
// bf16 bases must be 16-byte aligned and their strides multiples of 8.
int fa_forward(const void* q, const void* k, const void* v, float* out,
               int64_t b, int64_t s, int64_t h, int64_t hkv, int64_t d,
               int64_t q_sb, int64_t q_ss, int64_t q_sh,
               int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh,
               float sm_scale, int causal, int64_t window, int is_bf16,
               float* lse, void* stream) {
  if (hkv <= 0 || h % hkv != 0 || window < 0) return cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return cudaSuccess;
  const Params p{q, k, v, out, lse, s, h, hkv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 sm_scale, causal, window};
  return dispatch(p, b * h, d, is_bf16, static_cast<cudaStream_t>(stream));
}

// The backward of fa_forward: q, k, v as fa_forward takes them; o and dout
// (b, s, h, d) contiguous f32 (the forward's output and its gradient); lse
// (b, h, s) from fa_forward; delta (b, h, s) f32 scratch; dq (b, s, h, d)
// and dk, dv (b, s, hkv, d) contiguous, of the input type.  Launches three
// kernels on the stream.
int fa_backward(const void* q, const void* k, const void* v, const float* o,
                const float* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv,
                int64_t b, int64_t s, int64_t h, int64_t hkv, int64_t d,
                int64_t q_sb, int64_t q_ss, int64_t q_sh,
                int64_t k_sb, int64_t k_ss, int64_t k_sh,
                int64_t v_sb, int64_t v_ss, int64_t v_sh,
                float sm_scale, int causal, int64_t window, int is_bf16,
                void* stream) {
  if (hkv <= 0 || h % hkv != 0 || window < 0) return cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return cudaSuccess;
  const BwdParams p{q, k, v, o, dout, lse, delta, dq, dk, dv, s, h, hkv,
                    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                    sm_scale, causal, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bwd<__nv_bfloat16>(p, b, d, st)
                 : dispatch_bwd<float>(p, b, d, st);
}

}  // extern "C"
