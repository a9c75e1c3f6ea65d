// Chunked WKV6 (RWKV-6 "Finch") recurrence for Hopper (sm_90a), plain C
// interface.
//
// K7 wkv6_forward replaces the Pallas TPU kernel
// repro/kernels/rwkv6_scan/kernel.py::wkv6_pallas (_wkv6_kernel).  Per
// (batch, head), with the state S (D x D) indexed S[d_k, d_v]:
//
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// evaluated chunk by chunk in the stable log-decay form of the TPU kernel:
// inside a chunk la = cumsum(log max(w, 1e-30)) per channel, la_prev = la -
// log w (la of the row before), and
//
//   o_t   = (r_t exp(la_prev_t)) S                                  [state]
//         + sum_{j<t} (sum_d r_td k_jd exp(la_prev_td - la_jd)) v_j [intra]
//         + (r_t . (u k_t)) v_t                                     [bonus]
//   S_out = exp(la_last) S (rows) + (k exp(la_last - la))^T V
//
// Every exponent below is a difference of such monotone sums and is <= 0,
// so no exp is ever of a positive number, even with w clamped at 1e-30.
//
// Bound on an H100 SXM (data-sheet rates): at the serving shape (B = 1,
// H = 32, T = 512, D = 64, chunk 64; bf16 r/k/v, f32 w) the kernel must
// move 15.2 MB (4.5 us at 3.35 TB/s), and the recurrence needs 0.34 GFLOP
// (per head and token 2 D^2 for r S and 3 D^2 for w * S + k^T v: 5.1 us at
// the 67 TFLOP/s f32 rate), so it is bound by its operations.  The TPU
// carries S across a sequential grid axis in VMEM scratch, and this kernel's
// first design did the same in one block per (batch, head): 32 blocks on 132
// SMs, each walking its 8 chunks in order, f32 FMAs on the CUDA cores and
// one accurate expf per (t, j < t, d).  This design:
//
//  * A head's chunks are split over the n_blocks <= kMaxBlocks blocks of a
//    thread-block cluster, grid (n_blocks, B * H), n_blocks chosen from the
//    clusters the card holds at once (cluster_blocks): block i owns a
//    contiguous range of chunks (more than one when T has more chunks
//    than the cluster has blocks), so the serving shape runs 32 x 8 = 256
//    blocks, two to an SM (about 112 KB of shared memory each at D = 64,
//    r/k/v staged in their own type).  Three passes in one launch:
//    1. From S = 0, each block sums its range's state contribution dS =
//       sum_c (k_c exp(la_last_c + L_c - la_c))^T V_c, with L_c the summed
//       log decay of the range's chunks after c, walking the range from its
//       end so that its first chunk's tiles stay resident for pass 3; and
//       its decay A, the range's summed la_last.
//    2. After a cluster barrier, block i reads blocks 0 .. i - 1's dS and A
//       through distributed shared memory (all of a float4's remote reads
//       in flight together) and folds them in rank order from s0: S_in =
//       exp(A_j) S + dS_j, one D x D step per earlier block, the same
//       recurrence as the first design's chunk loop.  The last block writes
//       the final state exp(A) S_in + dS.  A second cluster barrier ends
//       the remote reads.
//    3. Each block runs its chunks from S_in: state, intra and bonus parts
//       of the output, and the state update between its own chunks.
//  * The intra-chunk scores run on the lower-triangular 4 x 4 tiles of the
//    (t, j) plane, one a thread below the diagonal, two lanes (each half of
//    d) a tile on it.  With E_J = la at the last row of sub-chunk J (kSub
//    rows, a tile's), a tile below the diagonal factors exp(la_prev_t -
//    la_j) = exp(la_prev_t - E_{I-1}) exp(E_{I-1} - E_J) exp(E_J - la_j):
//    three factors, each <= 1, so its scores are a dot product of r~ = r
//    exp(la_prev - E_{I-1}) and k~ = k exp(E_J - la), one exp each per
//    (row, d), times a per-channel exp.  Only the diagonal tiles keep one
//    exp per (t, j < t, d).  The state term's r exp(la_prev) and the
//    update's k exp(la_last - la) are r~ and k~ times one more factor <= 1.
//    About 30 K exps a chunk of 64 where the first design took about 147
//    K, all __expf of a number <= 0.  (A reference point at the start of a
//    key sub-chunk would need exp of a positive number, which overflows at
//    w = 1e-30.)
//  * The three (C, D) x (D, D) products (dS and the update k~^T V, r~ S,
//    scores V) run on the tensor cores: mma.sync.m16n8k16 with each f32
//    operand split into bf16 hi + lo (hi hi + lo hi + hi lo into one f32
//    sum, about 2^-16 of each product; a bf16 v enters exactly), fragments
//    read from shared memory.  A chunk's tiles are padded to 16, 32 or 64
//    rows of zeros for the 16-row steps.
//  * What holds it back (PERF.md): 32 clusters of 8 blocks at two blocks
//    an SM, but an H100 co-schedules only 30, so the serving shape runs in
//    two waves (with fewer blocks a block would take two chunks, which is
//    slower); a block's passes are bound by latency (barriers, global and
//    remote loads, the scores' loops), not by the card's rates.
//  * Layout: r/k/v/w are (B, H, T, D) views read through their batch, head
//    and time strides (the last dim contiguous), so the model's (B, T, H, D)
//    projections need no transpose copy; the output is written through its
//    own strides.  r/k/v are float32 or bf16 (a template on the element
//    type), w, u, s0 and both outputs float32.  s0 may be null (zeros).
//  * The ragged end is masked here: rows t >= T load as w = 1, r = k = v = 0
//    (the reference wrapper's padding tokens, which leave S untouched) and
//    are not written.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxChunk = 64;
constexpr int kMaxBlocks = 8;  // blocks (one cluster) per (batch, head)
constexpr int kSub = 4;        // rows of a sub-chunk: a score tile

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  float* out;
  float* s_out;
  int64_t h, t;
  int64_t r_sb, r_sh, r_st;
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t w_sb, w_sh, w_st;
  int64_t o_sb, o_sh, o_st;
  int chunk;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// The rows of a chunk's tiles: the chunk rounded up to 16, 32 or 64, so the
// tensor-core products see whole 16-row steps (the pad rows are zeros).
__host__ __device__ constexpr int padded_rows(int c) {
  return c <= 16 ? 16 : (c <= 32 ? 32 : 64);
}

// Byte offsets of the shared memory of a chunk of c rows.
template <typename T, int D>
struct Layout {
  static constexpr int LD = D + 1;                         // f32 tiles
  static constexpr int LE = D + (sizeof(T) == 2 ? 2 : 1);  // r, k
  static constexpr int LV = D + (sizeof(T) == 2 ? 8 : 4);  // v
  static constexpr int SP = D + 4;                         // S and dS
  static constexpr int kSegs = kThreads / D;               // cumsum segments
  size_t S, U, la, rh, kh, raw, tot, rd, dl, atot, dec, bytes;
  __host__ __device__ explicit Layout(int c) {
    const int cp = padded_rows(c);
    const size_t tile = round16(sizeof(float) * cp * LD);
    const size_t ds = static_cast<size_t>(D) * SP;
    const size_t sc = static_cast<size_t>(cp) * (cp + 1);
    S = 0;                                         // D x SP: S
    U = S + round16(sizeof(float) * ds);           // dS, then the scores
    la = U + round16(sizeof(float) * (ds > sc ? ds : sc));  // cumsum log w
    rh = la + tile;                                // r~, then r exp(la_prev)
    kh = rh + tile;                                // k~, then the update's k
    raw = kh + tile;                               // r, k (LE), v (LV)
    tot = raw + 2 * round16(sizeof(T) * cp * LE) + round16(sizeof(T) * cp * LV);
    rd = tot + sizeof(float) * kSegs * D;          // cp: r . (u k)
    dl = rd + sizeof(float) * cp;                  // D: exp(la_last)
    atot = dl + sizeof(float) * D;                 // D: the range's decay
    dec = atot + sizeof(float) * D;                // earlier blocks' exp(A)
    bytes = dec + sizeof(float) * (kMaxBlocks - 1) * D;
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// (x, y) as hi = bf16(x, y) and lo = bf16 of what hi leaves out, each pair
// packed with x in the low half: hi + lo keeps about 16 bits of each
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One warp's share of OUT (M x N) += A (M x K) B (K x N) on the tensor
// cores, M and N multiples of 16 and 8 with M / 16 dividing 8, over the
// 16-deep K steps [ks0, ks1) (K steps past ks1 hold zeros).  The warp owns
// output tiles (mt, nt + j * n_step), j < 4 (those with nt + j * n_step <
// N / 8); acc[j] holds tile j's fragment.  a(m, k) and b(k, n) are float;
// A is split into bf16 hi + lo unless kExactA, and so is B unless kExactB
// (the values are bf16 already): hi hi (+ lo hi) (+ hi lo) into one f32
// sum, about 2^-16 of each product.
template <bool kExactB, bool kExactA = false, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], int mt, int nt,
                                         int n_step, int n_tiles, int ks0,
                                         int ks1, FA a, FB b) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int m = 16 * mt + g;
  for (int ks = ks0; ks < ks1; ++ks) {
    const int k = 16 * ks + t2;
    uint32_t ah[4], al[4];
    split2(a(m, k), a(m, k + 1), ah[0], al[0]);
    split2(a(m + 8, k), a(m + 8, k + 1), ah[1], al[1]);
    split2(a(m, k + 8), a(m, k + 9), ah[2], al[2]);
    split2(a(m + 8, k + 8), a(m + 8, k + 9), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n8 = nt + j * n_step;
      if (n8 >= n_tiles) break;
      const int n = 8 * n8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      split2(b(k, n), b(k + 1, n), bh0, bl0);
      split2(b(k + 8, n), b(k + 9, n), bh1, bl1);
      mma_bf16(acc[j], ah, bh0, bh1);
      if (!kExactA) mma_bf16(acc[j], al, bh0, bh1);
      if (!kExactB) mma_bf16(acc[j], ah, bl0, bl1);
    }
  }
}

// The output tiles of warp w in an M x N product with 8 warps: m tile
// w % (M / 16), n tiles w / (M / 16) + j * (8 / (M / 16)); with fewer than
// 8 tiles the warps past them own none (n_tiles = 0).
struct WarpTiles {
  int mt, nt, n_step, n_tiles;
  __device__ WarpTiles(int M, int N, int warp) {
    const int mts = M / 16, nts = N / 8;
    mt = warp % mts;
    nt = warp / mts;
    n_step = 8 / mts;
    n_tiles = mts * nts > warp ? nts : 0;
  }
};

// Grid (n_blocks, B * H) in clusters of (n_blocks, 1): see the note at the
// top.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) wkv6_kernel(Params p) {
  using Lay = Layout<T, D>;
  constexpr int LD = Lay::LD, LE = Lay::LE, LV = Lay::LV, SP = Lay::SP;
  constexpr int kSegs = Lay::kSegs;
  constexpr bool kExactV = sizeof(T) == 2;  // bf16 v is exact in bf16
  const int C = p.chunk;
  const int CP = padded_rows(C);
  const Lay lay(C);
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem + lay.S);
  float* U = reinterpret_cast<float*>(smem + lay.U);
  float* la = reinterpret_cast<float*>(smem + lay.la);
  float* rh = reinterpret_cast<float*>(smem + lay.rh);
  float* kh = reinterpret_cast<float*>(smem + lay.kh);
  T* rr = reinterpret_cast<T*>(smem + lay.raw);
  T* kr = reinterpret_cast<T*>(smem + lay.raw + round16(sizeof(T) * CP * LE));
  T* vr = reinterpret_cast<T*>(smem + lay.raw
                               + 2 * round16(sizeof(T) * CP * LE));
  float* tot = reinterpret_cast<float*>(smem + lay.tot);
  float* rd = reinterpret_cast<float*>(smem + lay.rd);
  float* dl = reinterpret_cast<float*>(smem + lay.dl);
  float* atot = reinterpret_cast<float*>(smem + lay.atot);
  float* decay = reinterpret_cast<float*>(smem + lay.dec);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32;
  const int rank = blockIdx.x, n_blocks = gridDim.x;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.h;
  const int64_t head = bh % p.h;

  const T* rg = static_cast<const T*>(p.r) + b * p.r_sb + head * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + head * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + head * p.v_sh;
  const float* wg = p.w + b * p.w_sb + head * p.w_sh;
  const float* ug = p.u + head * D;
  float* og = p.out + b * p.o_sb + head * p.o_sh;

  // this block's chunks [first, first + mine)
  const int64_t n_chunks = (p.t + C - 1) / C;
  const int64_t base = n_chunks / n_blocks, extra = n_chunks % n_blocks;
  const int64_t first = rank * base + (rank < extra ? rank : extra);
  const int64_t mine = base + (rank < extra ? 1 : 0);

  // chunk c's tiles, the pad rows as zeros.  w goes straight to la by
  // 4-byte cp.async (rows past T as 1, so their log is 0; the log is taken
  // in cumsum); every global load of k and v (or of r) of a thread is
  // issued before its first shared store, so they are in flight together.
  constexpr int kLoads = kMaxChunk * D / kThreads;
  auto load_kvw = [&](int64_t c) {
    const int64_t t0 = c * C;
    const T zero = static_cast<T>(0.f);
    T kv[kLoads], vv[kLoads];
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int i = tid + n * kThreads, tt = i / D, d = i % D;
      const int64_t pos = t0 + tt;
      const bool in = tt < C && pos < p.t;
      kv[n] = in ? kg[pos * p.k_st + d] : zero;
      vv[n] = in ? vg[pos * p.v_st + d] : zero;
      if (in) {
        cp_async4(la + tt * LD + d, wg + pos * p.w_st + d);
      } else if (tt < CP) {
        la[tt * LD + d] = tt < C ? 1.f : 0.f;
      }
    }
    cp_async_commit();
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int i = tid + n * kThreads, tt = i / D, d = i % D;
      if (tt >= CP) continue;
      kr[tt * LE + d] = kv[n];
      vr[tt * LV + d] = vv[n];
    }
    cp_async_wait_all();
  };
  auto load_r = [&](int64_t c) {
    const int64_t t0 = c * C;
    const T zero = static_cast<T>(0.f);
    T rv[kLoads];
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int i = tid + n * kThreads, tt = i / D, d = i % D;
      const int64_t pos = t0 + tt;
      rv[n] = tt < C && pos < p.t ? rg[pos * p.r_st + d] : zero;
    }
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int i = tid + n * kThreads, tt = i / D, d = i % D;
      if (tt < CP) rr[tt * LE + d] = rv[n];
    }
  };
  // la = inclusive cumsum of log max(w, 1e-30) down each channel: kSegs
  // segments of rows a channel, then each segment adds the totals of those
  // before it
  auto cumsum = [&]() {
    const int d = tid % D, seg = tid / D;
    const int rows = (C + kSegs - 1) / kSegs;
    const int lo = seg * rows, hi = min(C, lo + rows);
    float run = 0.f;
    for (int tt = lo; tt < hi; ++tt) {
      run += logf(fmaxf(la[tt * LD + d], 1e-30f));
      la[tt * LD + d] = run;
    }
    tot[seg * D + d] = run;
    __syncthreads();
    float off = 0.f;
    for (int s = 0; s < seg; ++s) off += tot[s * D + d];
    for (int tt = lo; tt < hi; ++tt) la[tt * LD + d] += off;
    __syncthreads();
  };
  const float* la_last = la + (C - 1) * LD;

  // OUT[d][e] = init(d, e) + sum_t kd[t][d] v[t][e] on the tensor cores,
  // kd from kh; OUT has pitch SP
  auto state_product = [&](float* out, bool add_u, const float* scale_rows) {
    const WarpTiles wt(D, D, warp);
    float acc[4][4];
    const int lane = tid % 32, g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n8 = wt.nt + j * wt.n_step;
        const int row = 16 * wt.mt + g + 8 * (e / 2);
        const int col = 8 * n8 + t2 + e % 2;
        float v0 = 0.f;
        if (n8 < wt.n_tiles) {
          v0 = out[row * SP + col];
          if (scale_rows) v0 *= scale_rows[row];
          else if (!add_u) v0 = 0.f;
        }
        acc[j][e] = v0;
      }
    warp_mma<kExactV>(acc, wt.mt, wt.nt, wt.n_step, wt.n_tiles, 0, CP / 16,
                      [&](int m, int k) { return kh[k * LD + m]; },
                      [&](int k, int n) { return to_f32(vr[k * LV + n]); });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n8 = wt.nt + j * wt.n_step;
      if (n8 >= wt.n_tiles) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(16 * wt.mt + g + 8 * (e / 2)) * SP + 8 * n8 + t2 + e % 2] =
            acc[j][e];
    }
  };

  // ---- pass 1: the range's dS (in U) and decay A (atot), from its end
  for (int i = tid; i < D * SP; i += kThreads) U[i] = 0.f;
  if (tid < D) atot[tid] = 0.f;
  for (int64_t c = first + mine - 1; c >= first; --c) {
    __syncthreads();  // the previous chunk's tiles and atot are consumed
    load_kvw(c);
    __syncthreads();
    cumsum();
    for (int i = tid; i < CP * D; i += kThreads) {
      const int tt = i / D, d = i % D;
      kh[tt * LD + d] = tt < C ? to_f32(kr[tt * LE + d]) * __expf(
          la_last[d] + atot[d] - la[tt * LD + d]) : 0.f;
    }
    __syncthreads();
    state_product(U, true, nullptr);
    __syncthreads();  // every thread has read atot
    if (tid < D) atot[tid] += la_last[tid];
  }

  // ---- pass 2: S_in from s0 and the earlier blocks' (A, dS), in rank order
  cluster.sync();
  {
    // the earlier blocks' decays exp(A_j) first; then, a float4 of S at a
    // time, every earlier block's float4 of dS is read (all remote reads in
    // flight together) and folded in rank order.  A warp's reads of one
    // block are 512 contiguous bytes of a row pair.
    for (int i = tid; i < rank * D; i += kThreads)
      decay[i] = __expf(cluster.map_shared_rank(atot, i / D)[i % D]);
    __syncthreads();
    constexpr int kN4 = D * D / 4;  // float4s of S
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* s0 = p.s0 ? reinterpret_cast<const float4*>(
                                  p.s0 + bh * D * D) : nullptr;
    float4* s_out = reinterpret_cast<float4*>(p.s_out + bh * D * D);
    for (int i4 = tid; i4 < kN4; i4 += kThreads) {
      const int d = 4 * i4 / D, at = d * SP + 4 * i4 % D;  // shared offset
      float4 ds[kMaxBlocks - 1];
#pragma unroll
      for (int j = 0; j < kMaxBlocks - 1; ++j)
        ds[j] = j < rank ? *reinterpret_cast<const float4*>(
                               cluster.map_shared_rank(U, j) + at) : zero;
      float4 s = s0 ? s0[i4] : zero;
#pragma unroll
      for (int j = 0; j < kMaxBlocks - 1; ++j) {
        if (j >= rank) break;
        const float a = decay[j * D + d];
        s = make_float4(fmaf(a, s.x, ds[j].x), fmaf(a, s.y, ds[j].y),
                        fmaf(a, s.z, ds[j].z), fmaf(a, s.w, ds[j].w));
      }
      *reinterpret_cast<float4*>(S + at) = s;
      if (rank == n_blocks - 1) {
        const float a = __expf(atot[d]);
        const float4 u = *reinterpret_cast<const float4*>(U + at);
        s_out[i4] = make_float4(fmaf(a, s.x, u.x), fmaf(a, s.y, u.y),
                                fmaf(a, s.z, u.z), fmaf(a, s.w, u.w));
      }
    }
  }
  cluster.sync();  // every remote read of U is done before U is reused

  // ---- pass 3: the outputs of this block's chunks from S_in
  float* A = U;  // CP x (CP + 1) scores
  const int LA = CP + 1;
  // the 4 x 4 tiles (ta, tb) of the (t, j) plane: threads below n_below own
  // the tiles below the diagonal (tb < ta); warp kDiagWarp owns the
  // diagonal ones, two lanes a tile (l and l + 16), each half of d
  constexpr int kDiagWarp = 4;
  const int n_tiles = (C + kSub - 1) / kSub;
  const int n_below = n_tiles * (n_tiles - 1) / 2;  // <= 32 * kDiagWarp
  int ta = 1, tb = 0;
  if (tid < n_below) {
    while (ta * (ta + 1) / 2 <= tid) ++ta;
    tb = tid - ta * (ta - 1) / 2;
  } else {
    ta = tb = tid % 16;
  }

  for (int64_t c = first; c < first + mine; ++c) {
    const int64_t t0 = c * C;
    const bool update = c + 1 < first + mine;  // S feeds another chunk here
    __syncthreads();  // S is in place; the previous chunk's tiles consumed
    // pass 1 ended on chunk `first`: its k, v and la are still in place
    load_r(c);
    if (c != first) load_kvw(c);
    __syncthreads();
    if (c != first) cumsum();

    // r~ = r exp(la_prev - E_{I-1}), k~ = k exp(E_J - la), with E_J = la at
    // the last row of sub-chunk J and E_{-1} = 0; the pad rows are zeros
    for (int i = tid; i < CP * D; i += kThreads) {
      const int tt = i / D, d = i % D;
      float rv = 0.f, kv = 0.f;
      if (tt < C) {
        const int sub = tt / kSub;
        const float e_prev = sub ? la[(sub * kSub - 1) * LD + d] : 0.f;
        const float e_end = la[min(sub * kSub + kSub - 1, C - 1) * LD + d];
        const float lp = tt ? la[(tt - 1) * LD + d] : 0.f;
        rv = to_f32(rr[tt * LE + d]) * __expf(lp - e_prev);
        kv = to_f32(kr[tt * LE + d]) * __expf(e_end - la[tt * LD + d]);
      }
      rh[tt * LD + d] = rv;
      kh[tt * LD + d] = kv;
    }
    for (int i = tid; i < CP * LA; i += kThreads) A[i] = 0.f;
    __syncthreads();

    if (tid < n_below) {
      // a tile below the diagonal: r~ . (k~ g), g = exp(E_{ta-1} - E_tb)
      // <= 1.  Rows and columns past C are clamped to C - 1 (not stored).
      float acc[kSub][kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
      int row[kSub], col[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        row[i] = min(kSub * ta + i, C - 1);
        col[i] = min(kSub * tb + i, C - 1);
      }
      const float* e_prev = la + (kSub * ta - 1) * LD;
      const float* e_key = la + (kSub * tb + kSub - 1) * LD;
      for (int d = 0; d < D; ++d) {
        const float g = __expf(e_prev[d] - e_key[d]);
        float rv[kSub], kv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          rv[i] = rh[row[i] * LD + d];
          kv[i] = kh[col[i] * LD + d] * g;
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j)
            acc[i][j] = fmaf(rv[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int rw = kSub * ta + i, cl = kSub * tb + j;
          if (rw < C) A[rw * LA + cl] = acc[i][j];
        }
    } else if (warp == kDiagWarp) {
      // a diagonal tile: one exp per (t, j < t, d), the exponent clamped
      // at 0 (a row clamped at C - 1 can meet a later column); lanes l and
      // l + 16 take the two halves of d and add
      const int lane = tid % 32, d0 = (lane / 16) * (D / 2);
      const bool has = ta < n_tiles;
      float acc[kSub][kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
      int row[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) row[i] = min(kSub * ta + i, C - 1);
      for (int d = d0; has && d < d0 + D / 2; ++d) {
        float rv[kSub], pv[kSub], kv[kSub], lv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          rv[i] = to_f32(rr[row[i] * LE + d]);
          pv[i] = row[i] ? la[(row[i] - 1) * LD + d] : 0.f;
          kv[i] = to_f32(kr[row[i] * LE + d]);
          lv[i] = la[row[i] * LD + d];
        }
#pragma unroll
        for (int i = 1; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < i; ++j)
            acc[i][j] = fmaf(rv[i] * kv[j],
                             __expf(fminf(pv[i] - lv[j], 0.f)), acc[i][j]);
      }
#pragma unroll
      for (int i = 1; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
      if (has && lane < 16) {
#pragma unroll
        for (int i = 1; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < i; ++j) {
            const int rw = kSub * ta + i;
            if (rw < C) A[rw * LA + kSub * ta + j] = acc[i][j];
          }
      }
    } else if (tid >= kThreads - C) {  // the current-token bonus
      const int tt = tid - (kThreads - C);
      float s = 0.f;
      for (int d = 0; d < D; ++d)
        s = fmaf(to_f32(rr[tt * LE + d]) * ug[d], to_f32(kr[tt * LE + d]), s);
      rd[tt] = s;
    }
    __syncthreads();

    // r exp(la_prev) = r~ exp(E_{I-1}); k exp(la_last - la) = k~
    // exp(la_last - E_J): both factors <= 1
    for (int i = tid; i < C * D; i += kThreads) {
      const int tt = i / D, d = i % D;
      const int sub = tt / kSub;
      if (sub) rh[tt * LD + d] *= __expf(la[(sub * kSub - 1) * LD + d]);
      if (update)
        kh[tt * LD + d] *= __expf(
            la_last[d] - la[min(sub * kSub + kSub - 1, C - 1) * LD + d]);
    }
    if (tid < D) dl[tid] = __expf(la_last[tid]);
    __syncthreads();

    {  // out = r exp(la_prev) S + A V (causal: key steps up to the row's)
      const WarpTiles wt(CP, D, warp);
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      warp_mma<false>(acc, wt.mt, wt.nt, wt.n_step, wt.n_tiles, 0, D / 16,
                      [&](int m, int k) { return rh[m * LD + k]; },
                      [&](int k, int n) { return S[k * SP + n]; });
      warp_mma<kExactV>(acc, wt.mt, wt.nt, wt.n_step, wt.n_tiles, 0,
                        wt.mt + 1,
                        [&](int m, int k) { return A[m * LA + k]; },
                        [&](int k, int n) { return to_f32(vr[k * LV + n]); });
      const int lane = tid % 32, g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n8 = wt.nt + j * wt.n_step;
        if (n8 >= wt.n_tiles) break;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int tt = 16 * wt.mt + g + 8 * h2;
          if (tt >= C || t0 + tt >= p.t) continue;
          const int e = 8 * n8 + t2;
          float* orow = og + (t0 + tt) * p.o_st;
          orow[e] = fmaf(rd[tt], to_f32(vr[tt * LV + e]), acc[j][2 * h2]);
          orow[e + 1] = fmaf(rd[tt], to_f32(vr[tt * LV + e + 1]),
                             acc[j][2 * h2 + 1]);
        }
      }
    }
    if (!update) continue;
    __syncthreads();  // every thread has read S
    state_product(S, false, dl);  // S = exp(la_last) S + kd^T V
  }
}

// A launch of grid (n, bh) in clusters of (n, 1).
template <typename T, int D>
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, unsigned n,
                                  int64_t bh, size_t smem,
                                  cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, static_cast<unsigned>(bh));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The blocks of a cluster: the n <= min(kMaxBlocks, chunks) that minimises
// the chunks of the busiest block times the waves of clusters, with the
// clusters the card holds at once from cudaOccupancyMaxActiveClusters
// (asked once per device, padded chunk rows and n); ties go to the larger
// n.  On an H100 that is 8 at the serving shape (8 chunks: 30 clusters of
// 8 fit, so two waves, but fewer blocks would take two chunks each) and 7
// at 32 chunks (32 clusters of 7 fit: one wave); PERF.md has the times.
template <typename T, int D>
cudaError_t cluster_blocks(int64_t chunks, int64_t bh, int chunk,
                           size_t smem, unsigned* n_out) {
  static int active[16][3][kMaxBlocks + 1];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int rows = padded_rows(chunk) / 32;  // 0, 1, 2
  const int64_t most = chunks < kMaxBlocks ? chunks : kMaxBlocks;
  unsigned best = 1;
  int64_t best_cost = -1;
  for (int64_t n = most; n >= 1; --n) {
    int& a = active[dev % 16][rows][n];
    if (a == 0) {
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg = cluster_config<T, D>(
          attr, static_cast<unsigned>(n), 1024, smem, nullptr);
      int got = 0;
      err = cudaOccupancyMaxActiveClusters(&got, wkv6_kernel<T, D>, &cfg);
      if (err != cudaSuccess) return err;
      a = got > 0 ? got : 1;
    }
    const int64_t cost = ((chunks + n - 1) / n) * ((bh + a - 1) / a);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = static_cast<unsigned>(n);
    }
  }
  *n_out = best;
  return cudaSuccess;
}

template <typename T, int D>
int launch(const Params& p, int64_t bh, cudaStream_t stream) {
  // The attribute belongs to the current device, so it is set on every
  // launch (a cheap call) rather than once per process.
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<T, D>(kMaxChunk).bytes));
  if (err != cudaSuccess) return err;
  const size_t smem = Layout<T, D>(p.chunk).bytes;
  const int64_t chunks = (p.t + p.chunk - 1) / p.chunk;
  unsigned n_blocks = 1;
  if (chunks > 1) {
    err = cluster_blocks<T, D>(chunks, bh, p.chunk, smem, &n_blocks);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config<T, D>(attr, n_blocks, bh, smem, stream);
  err = cudaLaunchKernelEx(&cfg, wkv6_kernel<T, D>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(const Params& p, int64_t bh, int64_t d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(p, bh, s);
    case 32: return launch<T, 32>(p, bh, s);
    case 64: return launch<T, 64>(p, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K7's backward, wkv6_backward.  It replaces no TPU kernel: the reference
// trains through XLA's gradient of the pure-jnp wkv6_chunked
// (repro/models/ssm.py), and no pallas_call has a backward.  It exists
// because the port's rwkv6 training runs K7 on the card, and autograd
// cannot differentiate a hand kernel.  Per (batch, head), with dO the
// output's gradient, S_c chunk c's incoming state and dS_c the gradient of
// its outgoing state (lp = la_prev, lam = la of the chunk's last row, kd =
// k e^(lam - la), M_tj = sum_d r_td k_jd e^(lp_td - la_jd) and dM_tj = dO_t
// . v_j for j < t, rd_t = r_t . (u k_t), drd_t = dO_t . v_t):
//
//   dv      = M^T dO + rd dO + kd dS_c
//   dr      = e^lp (dO S_c^T) + (dM * decay) k + drd u k
//   dk      = (dM * decay)^T r + e^(lam - la) (V dS_c^T) + drd u r
//   du      = sum over chunks of sum_t drd_t r_t k_t
//   S_{c+1} = diag(e^lam_c) S_c + kd_c^T V_c              (from s0)
//   dS_{c-1} = diag(e^lam_c) dS_c + (r e^lp)_c^T dO_c      (from ds_final)
//
// and the decay's gradient without another pass over the (t, j) plane:
// d lp = r (dr - drd u k), d la = -k (dk - drd u r), d lam = e^lam
// rowsum(S_c dS_c) + sum_j kd_j (V dS_c^T)_j, d log w_s = sum_{t >= s} d
// la_t + sum_{t > s} d lp_t + d lam (a reverse cumsum down each channel),
// dw = d log w / w above the floor 1e-30, half of it at the floor (the
// gradient of jnp.maximum), none below.  ref.py's wkv6_chunked_bwd is the
// same function in plain torch (the tests' wkv_bwd_split.py follows this
// kernel's schedule).
//
// Bound on an H100 SXM at the training shape (B = 8, H = 32, T = 512, D =
// 64, bf16 r/k/v): the function reads r, k, v, w, dO and writes dr, dk,
// dv, dw (205.5 MB, 0.061 ms at 3.35 TB/s) and does 5.45 GFLOP, twice the
// forward's, 0.081 ms at the 67 TFLOP/s f32 rate: it is bound by its
// operations.  A chunk's gradients depend on the rest of the sequence only
// through S_c and dS_c, which are folds of per-chunk D x D terms, so the
// kernel runs chunk-parallel, in three launches, to fill the card:
//
//  1. wkv6_bwd_local_kernel, grid (chunks, B * H), 62 KB, three blocks an
//     SM: a chunk's two local sums on the tensor cores, U_c = kd^T V and
//     W_c = (r e^lp)^T dO, its e^lam and its share of du, into a float32
//     scratch buffer.
//  2. wkv6_bwd_fold_kernel, one thread a float4 of a head's D x D: the
//     folds in chunk order, in place, U_c -> S_c forward from s0 and W_c
//     -> dS_c backward from ds_final (ending in ds0), one FMA a chunk, and
//     du summed over the chunks.  The only serial part.
//  3. wkv6_bwd_grad_kernel, grid (B * H, chunks), 112 KB at D = 64 for
//     bf16, two blocks an SM (float32 r/k/v: 136 KB, one): everything a
//     chunk's rows need, given S_c and dS_c.  Its tiles arrive by 16-byte
//     cp.async in three groups (w; r and k; v, dO and dS_c), each awaited
//     just before its first use.  The (t, j) plane is cut into 16-row
//     sub-chunks: a block below the diagonal factors e^(lp_t - la_j) =
//     e^(lp_t - E_{I-1}) e^(E_{I-1} - E_J) e^(E_J - la_j), with E_J the la
//     of sub-chunk J's last row, three factors each <= 1 (r~ = r e^(lp -
//     E_{I-1}), a table g_IJ and k~ = k e^(E_J - la)), so its products run
//     on the tensor cores; in the diagonal blocks M takes one exp per (t,
//     j < t, d), and dr's and dk's shares take running products of w_m =
//     e^(la_m - la_{m-1}) instead (15 exps a (sub-chunk, channel), not
//     120; the products telescope to the same la differences).  Every
//     exponent is <= 0, even at w = 1e-30.  The plane holds M, then dM
//     (its blocks on and below the diagonal); one D x D tile holds dS_c,
//     dk's diagonal share, then S_c, then a copy of w for dw.  The ten
//     (16 rows x D) x (D x D) or plane products are mma.sync.m16n8k16 with
//     each float32 operand split into bf16 hi + lo (hi hi + lo hi + hi lo
//     into one f32 sum, about 2^-16 of each product; bf16 r, k, v enter
//     exactly), as the forward's.  dr, dk and dv are written from
//     registers, d log w by a reverse scan down each channel in segments.
//
// The training shape runs 256 x 8 = 2,048 blocks in launches 1 and 3.
// Every sum has a fixed order and nothing is atomic, so reruns and
// CUDA-graph replays give the same bits.  What holds it back (PERF.md,
// section 6): launch 3 is latency-bound at two blocks an SM, in lockstep,
// with 18 barriers a block; clock64 stamps at its barriers, in a probe
// copy of this source, put a block's time in its first tiles' wait, the
// tables, M, dk's products (split operands loaded from shared memory), and
// dr's diagonal and epilogue.
// ---------------------------------------------------------------------------

constexpr int kPart = 16;                     // rows of a sub-chunk
constexpr int kHalfPart = kPart / 2;
constexpr int kMaxParts = kMaxChunk / kPart;  // sub-chunks of a chunk
constexpr float kWFloor = 1e-30f;

struct BwdParams {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  const float* dout;
  const float* ds_final;
  void* dr;
  void* dk;
  void* dv;
  float* dw;
  float* du;       // (b * h, d): per (batch, head)
  float* ds0;
  float* scratch;  // bwd_scratch_floats(b * h, chunks, d)
  int64_t bh, h, t;
  int64_t r_sb, r_sh, r_st;
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t w_sb, w_sh, w_st;
  int64_t o_sb, o_sh, o_st;   // dout
  int64_t g_sb, g_sh, g_st;   // dr, dk, dv and dw
  int chunk;
};

// The scratch buffer: U_c then S_c, W_c then dS_c (bh, chunks, d, d), and
// e^lam_c and chunk c's share of du (bh, chunks, d).
struct BwdScratch {
  float* s;
  float* ds;
  float* decay;
  float* du;
};

__host__ __device__ inline BwdScratch bwd_scratch(float* base, int64_t bh,
                                                  int64_t nc, int d) {
  const int64_t sq = bh * nc * d * d, vec = bh * nc * d;
  return {base, base + sq, base + 2 * sq, base + 2 * sq + vec};
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// f(j, e, row, col) over the warp's accumulator elements acc[j][e]
template <typename F>
__device__ __forceinline__ void for_acc(const WarpTiles& wt, int n_tiles,
                                        F f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n8 = wt.nt + j * wt.n_step;
    if (n8 >= n_tiles) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(j, e, 16 * wt.mt + g + 8 * (e / 2), 8 * n8 + t2 + e % 2);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// la (rows x D, pitch LD) = the inclusive cumsum of log max(la, 1e-30)
// down each channel (la holds w), in kThreads / D segments of rows; tot
// holds kThreads floats
template <int D, int LD>
__device__ __forceinline__ void cumsum_log_rows(float* la, float* tot,
                                                int rows) {
  constexpr int kSegs = kThreads / D;
  const int d = threadIdx.x % D, seg = threadIdx.x / D;
  constexpr int kPer = (kMaxChunk + kSegs - 1) / kSegs;
  const int per = (rows + kSegs - 1) / kSegs;
  const int lo = seg * per, hi = min(rows, lo + per);
  float lg[kPer];  // every log of the segment in flight at once
#pragma unroll
  for (int n = 0; n < kPer; ++n)
    lg[n] = lo + n < hi ? logf(fmaxf(la[(lo + n) * LD + d], kWFloor)) : 0.f;
  float run = 0.f;
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    run += lg[n];
    lg[n] = run;
  }
  tot[seg * D + d] = run;
  __syncthreads();
  float off = 0.f;
  for (int s = 0; s < seg; ++s) off += tot[s * D + d];
#pragma unroll
  for (int n = 0; n < kPer; ++n)
    if (lo + n < hi) la[(lo + n) * LD + d] = lg[n] + off;
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// The (B, H, T, D) operands of one (batch, head) and the chunk's rows.
template <typename T>
struct BwdRows {
  const T* r;
  const T* k;
  const T* v;
  const float* w;
  const float* dout;
  int64_t t0, g0, bh, c;
  __device__ BwdRows(const BwdParams& p, int64_t bh_, int64_t c_) {
    bh = bh_;
    c = c_;
    const int64_t b = bh / p.h, head = bh % p.h;
    r = static_cast<const T*>(p.r) + b * p.r_sb + head * p.r_sh;
    k = static_cast<const T*>(p.k) + b * p.k_sb + head * p.k_sh;
    v = static_cast<const T*>(p.v) + b * p.v_sb + head * p.v_sh;
    w = p.w + b * p.w_sb + head * p.w_sh;
    dout = p.dout + b * p.o_sb + head * p.o_sh;
    t0 = c * p.chunk;
    g0 = b * p.g_sb + head * p.g_sh;
  }
};

// A chunk's rows [0, CP) of a (T, D) operand, loaded all at once (every
// global load of the thread is in flight before its first use): put(t, d,
// value) for each, the rows past the chunk or T as `pad`.
template <int D, typename S, typename F>
__device__ __forceinline__ void load_rows(int cp, int c, int64_t t0,
                                          int64_t t_end, const S* src,
                                          int64_t stride, S pad, F put) {
  constexpr int kIt = kMaxChunk * D / kThreads;
  S vals[kIt];
#pragma unroll
  for (int n = 0; n < kIt; ++n) {
    const int i = threadIdx.x + n * kThreads, t = i / D, d = i % D;
    const int64_t pos = t0 + t;
    vals[n] = t < c && pos < t_end ? src[pos * stride + d] : pad;
  }
#pragma unroll
  for (int n = 0; n < kIt; ++n) {
    const int i = threadIdx.x + n * kThreads, t = i / D, d = i % D;
    if (t < cp) put(t, d, vals[n]);
  }
}

// A chunk's rows [0, CP) of a (T, D) operand into dst (pitch `pitch`, rows
// 16-byte aligned) by 16-byte cp.async copies, all in flight together
// (the caller commits and waits); the rows past the chunk or T are
// stored as `pad`.  Source rows that are not 16-byte aligned (an odd
// view) go through registers instead, with the same values.
template <int D, typename S>
__device__ __forceinline__ void stage_rows(S* dst, int pitch, int cp, int c,
                                           int64_t t0, int64_t t_end,
                                           const S* src, int64_t stride,
                                           S pad) {
  constexpr int kV = 16 / static_cast<int>(sizeof(S));  // elements a copy
  constexpr int kQ = D / kV;                             // copies a row
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0
                       && (stride * static_cast<int64_t>(sizeof(S))) % 16 == 0;
  if (!aligned) {
    load_rows<D>(cp, c, t0, t_end, src, stride, pad,
                 [&](int t, int d, S x) { dst[t * pitch + d] = x; });
    return;
  }
  for (int i = threadIdx.x; i < cp * kQ; i += kThreads) {
    const int t = i / kQ, q = i % kQ;
    const int64_t pos = t0 + t;
    S* to = dst + t * pitch + q * kV;
    if (t < c && pos < t_end) {
      cp_async16(to, src + pos * stride + q * kV);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e) to[e] = pad;
    }
  }
}

// Launch 1's shared memory (bytes): la (then kd in place), r e^lp and dO
// as float32 (cp x (D + 4)), v in its own type, the cumsum's segment
// totals and drd.
template <typename T, int D>
struct LocalLayout {
  static constexpr int LD = D + 4;  // rows 16-byte aligned, for cp.async
  static constexpr int LV = D + (sizeof(T) == 2 ? 8 : 4);
  size_t la, rq, dout, tot, drd, lam, v, bytes;
  __host__ __device__ explicit LocalLayout(int c) {
    const int cp = padded_rows(c);
    const size_t tile = round16(sizeof(float) * cp * LD);
    la = 0;
    rq = la + tile;
    dout = rq + tile;
    tot = dout + tile;
    drd = tot + sizeof(float) * kThreads;
    lam = drd + sizeof(float) * kMaxChunk;
    v = lam + sizeof(float) * D;
    bytes = v + round16(sizeof(T) * cp * LV);
  }
};

// Launch 1, grid (chunks, B * H): U_c = kd^T V, W_c = (r e^lp)^T dO,
// e^lam and chunk c's share of du into the scratch buffer.  About 62 KB of
// shared memory at D = 64 (bf16): three blocks an SM (two for float32
// r/k/v, whose register copies need more than a third of the file).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)
    wkv6_bwd_local_kernel(BwdParams p) {
  using L = LocalLayout<T, D>;
  constexpr int LD = L::LD, LV = L::LV, kSegs = kThreads / D;
  constexpr bool kExactV = sizeof(T) == 2;
  const int C = p.chunk, CP = padded_rows(C);
  const L lay(C);
  extern __shared__ __align__(16) unsigned char smem[];
  float* LA = reinterpret_cast<float*>(smem + lay.la);
  float* KD = LA;  // kd in place of la, once r e^lp is taken
  float* RQ = reinterpret_cast<float*>(smem + lay.rq);
  float* DO = reinterpret_cast<float*>(smem + lay.dout);
  float* TOT = reinterpret_cast<float*>(smem + lay.tot);
  float* DRD = reinterpret_cast<float*>(smem + lay.drd);
  float* LAM = reinterpret_cast<float*>(smem + lay.lam);
  T* V = reinterpret_cast<T*>(smem + lay.v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t nc = gridDim.x;
  const BwdRows<T> in(p, blockIdx.y, blockIdx.x);
  const BwdScratch sc = bwd_scratch(p.scratch, p.bh, nc, D);
  const int64_t slot = in.bh * nc + in.c;

  // w, v and dO by cp.async (the rows past the chunk or T as identity
  // tokens, w = 1, v = dO = 0), r and k into registers meanwhile: one
  // round trip to device memory
  stage_rows<D>(LA, LD, CP, C, in.t0, p.t, in.w, p.w_st, 1.f);
  stage_rows<D>(V, LV, CP, C, in.t0, p.t, in.v, p.v_st, static_cast<T>(0.f));
  stage_rows<D>(DO, LD, CP, C, in.t0, p.t, in.dout, p.o_st, 0.f);
  cp_async_commit();
  constexpr int kIt = kMaxChunk * D / kThreads;
  T kv[kIt], rv[kIt];
#pragma unroll
  for (int n = 0; n < kIt; ++n) {
    const int i = tid + n * kThreads, t = i / D, d = i % D;
    const int64_t pos = in.t0 + t;
    const bool ok = t < C && pos < p.t;
    kv[n] = ok ? in.k[pos * p.k_st + d] : static_cast<T>(0.f);
    rv[n] = ok ? in.r[pos * p.r_st + d] : static_cast<T>(0.f);
  }
  cp_async_wait_all();
  __syncthreads();
  cumsum_log_rows<D, LD>(LA, TOT, CP);
  for (int t = warp; t < CP; t += kThreads / 32) {  // drd_t = dO_t . v_t
    float s = 0.f;
    for (int e = lane; e < D; e += 32)
      s = fmaf(DO[t * LD + e], to_f32(V[t * LV + e]), s);
    s = warp_sum(s);
    if (lane == 0) DRD[t] = s;
  }
  if (tid < D) LAM[tid] = LA[(CP - 1) * LD + tid];
  // r e^lp (lp = la of the row before); then, after a barrier, kd = k
  // e^(lam - la) in place of la
#pragma unroll
  for (int n = 0; n < kIt; ++n) {
    const int i = tid + n * kThreads, t = i / D, d = i % D;
    if (t < CP)
      RQ[t * LD + d] = to_f32(rv[n]) * __expf(t ? LA[(t - 1) * LD + d] : 0.f);
  }
  __syncthreads();
  // du's terms drd_t r_t k_t: channel tid % D, the thread's rows, then the
  // segments in order
  float du = 0.f;
#pragma unroll
  for (int n = 0; n < kIt; ++n) {
    const int i = tid + n * kThreads, t = i / D, d = i % D;
    if (t < CP) {
      const float k_f = to_f32(kv[n]);
      KD[t * LD + d] = k_f * __expf(LAM[d] - LA[t * LD + d]);
      du = fmaf(DRD[t] * to_f32(rv[n]), k_f, du);
    }
  }
  TOT[tid] = du;  // (segment, channel)
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int seg = 0; seg < kSegs; ++seg) s += TOT[seg * D + tid];
    sc.du[slot * D + tid] = s;
    sc.decay[slot * D + tid] = __expf(LAM[tid]);
  }
  // U (rows d_k, columns d_v) and W
  const WarpTiles wt(D, D, warp);
  float acc[4][4];
  const int lane_g = lane / 4, lane_t2 = 2 * (lane % 4);
  auto put = [&](float* out) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n8 = wt.nt + j * wt.n_step;
      if (n8 >= wt.n_tiles) break;
      const int row = 16 * wt.mt + lane_g, col = 8 * n8 + lane_t2;
      *reinterpret_cast<float2*>(out + row * D + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + (row + 8) * D + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
  };
  zero(acc);
  warp_mma<kExactV>(
      acc, wt.mt, wt.nt, wt.n_step, wt.n_tiles, 0, CP / 16,
      [&](int m, int k) { return KD[k * LD + m]; },
      [&](int k, int n) { return to_f32(V[k * LV + n]); });
  put(sc.s + slot * D * D);
  zero(acc);
  warp_mma<false>(
      acc, wt.mt, wt.nt, wt.n_step, wt.n_tiles, 0, CP / 16,
      [&](int m, int k) { return RQ[k * LD + m]; },
      [&](int k, int n) { return DO[k * LD + n]; });
  put(sc.ds + slot * D * D);
}

// Launch 2: blockIdx.y 0 folds U_c into S_c forward from s0, 1 folds W_c
// into dS_c backward from ds_final and writes ds0, 2 sums du over the
// chunks; one thread a float4 of a head's D x D (a channel for du).
template <int D>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_fold_kernel(BwdParams p, int64_t nc) {
  constexpr int kN4 = D * D / 4;
  const BwdScratch sc = bwd_scratch(p.scratch, p.bh, nc, D);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int role = blockIdx.y;
  if (role == 2) {
    if (i >= p.bh * D) return;
    const int64_t bh = i / D;
    const int d = static_cast<int>(i % D);
    float s = 0.f;
    for (int64_t c = 0; c < nc; ++c) s += sc.du[(bh * nc + c) * D + d];
    p.du[i] = s;
    return;
  }
  if (i >= p.bh * kN4) return;
  const int64_t bh = i / kN4;
  const int i4 = static_cast<int>(i % kN4), d = 4 * i4 / D;
  float4* slots = reinterpret_cast<float4*>(role == 0 ? sc.s : sc.ds)
                  + bh * nc * kN4 + i4;
  const float* decay = sc.decay + bh * nc * D + d;
  const float* init = role == 0 ? p.s0 : p.ds_final;
  float4 s = init ? reinterpret_cast<const float4*>(init)[bh * kN4 + i4]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  // kBatch chunks' loads in flight at once, then their steps in order
  constexpr int kBatch = 8;
  for (int64_t n0 = 0; n0 < nc; n0 += kBatch) {
    float4 x[kBatch];
    float a[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int64_t n = n0 + j;
      const int64_t c = role == 0 ? n : nc - 1 - n;
      if (n < nc) {
        x[j] = slots[c * kN4];
        a[j] = decay[c * D];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int64_t n = n0 + j;
      if (n >= nc) break;
      const int64_t c = role == 0 ? n : nc - 1 - n;
      slots[c * kN4] = s;
      s = make_float4(fmaf(a[j], s.x, x[j].x), fmaf(a[j], s.y, x[j].y),
                      fmaf(a[j], s.z, x[j].z), fmaf(a[j], s.w, x[j].w));
    }
  }
  if (role == 1) reinterpret_cast<float4*>(p.ds0)[bh * kN4 + i4] = s;
}

// Launch 3's shared memory (bytes): r, k, v in their own type, dO, la and
// k~ as float32 (cp x (D + 4)), the plane's blocks on and below the
// diagonal (kPart x (kPart + 1) each), the D x D tile (D x (D + 4), or cp
// rows when more), and the tables.
template <typename T, int D>
struct GradLayout {
  static constexpr int LD = D + 4;  // rows 16-byte aligned, for cp.async
  static constexpr int LE = D + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int LV = LE;
  static constexpr int SP = D + 4;
  static constexpr int LB = kPart + 1;
  static constexpr int kBlock = kPart * LB;  // floats of a plane block
  size_t r, k, v, dout, la, kt, plane, x, g, el, ee, rd, drd, kxs, ssum,
      tot, dlam, bytes;
  __host__ __device__ explicit GradLayout(int c) {
    const int cp = padded_rows(c), parts = cp / kPart;
    const size_t tile = round16(sizeof(float) * cp * LD);
    r = 0;
    k = r + round16(sizeof(T) * cp * LE);
    v = k + round16(sizeof(T) * cp * LE);
    dout = v + round16(sizeof(T) * cp * LV);
    la = dout + tile;
    kt = la + tile;
    plane = kt + tile;
    x = plane + round16(sizeof(float) * parts * (parts + 1) / 2 * kBlock);
    const size_t xs = static_cast<size_t>(D) * SP;
    const size_t ws = static_cast<size_t>(cp) * LD;
    g = x + round16(sizeof(float) * (xs > ws ? xs : ws));
    el = g + sizeof(float) * kMaxParts * (kMaxParts - 1) / 2 * D;
    ee = el + sizeof(float) * kMaxParts * D;
    rd = ee + sizeof(float) * kMaxParts * D;
    drd = rd + sizeof(float) * kMaxChunk;
    kxs = drd + sizeof(float) * kMaxChunk;
    ssum = kxs + sizeof(float) * kMaxParts * D;
    tot = ssum + sizeof(float) * D;
    dlam = tot + sizeof(float) * kThreads;
    bytes = dlam + sizeof(float) * D;
  }
};

// Launch 3, grid (B * H, chunks): chunk c's dr, dk, dv and dw from S_c and
// dS_c (see the note above).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    wkv6_bwd_grad_kernel(BwdParams p, int64_t nc) {
  using L = GradLayout<T, D>;
  constexpr int LD = L::LD, LE = L::LE, LV = L::LV, SP = L::SP, LB = L::LB;
  constexpr int kBlock = L::kBlock, kSegs = kThreads / D;
  constexpr bool kExact = sizeof(T) == 2;
  const int C = p.chunk, CP = padded_rows(C), parts = CP / kPart;
  const L lay(C);
  extern __shared__ __align__(16) unsigned char smem[];
  T* R = reinterpret_cast<T*>(smem + lay.r);
  T* K = reinterpret_cast<T*>(smem + lay.k);
  T* V = reinterpret_cast<T*>(smem + lay.v);
  float* DO = reinterpret_cast<float*>(smem + lay.dout);
  float* LA = reinterpret_cast<float*>(smem + lay.la);
  float* KT = reinterpret_cast<float*>(smem + lay.kt);
  float* PL = reinterpret_cast<float*>(smem + lay.plane);
  float* X = reinterpret_cast<float*>(smem + lay.x);
  float* G = reinterpret_cast<float*>(smem + lay.g);     // [I(I-1)/2 + J][D]
  float* EL = reinterpret_cast<float*>(smem + lay.el);   // [J][D] e^(lam-E_J)
  float* EE = reinterpret_cast<float*>(smem + lay.ee);   // [I][D] e^E_{I-1}
  float* RD = reinterpret_cast<float*>(smem + lay.rd);
  float* DRD = reinterpret_cast<float*>(smem + lay.drd);
  float* KXS = reinterpret_cast<float*>(smem + lay.kxs);  // [J][D]
  float* SSUM = reinterpret_cast<float*>(smem + lay.ssum);
  float* TOT = reinterpret_cast<float*>(smem + lay.tot);
  float* DLAM = reinterpret_cast<float*>(smem + lay.dlam);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const BwdScratch sc = bwd_scratch(p.scratch, p.bh, nc, D);
  const T zero_t = static_cast<T>(0.f);
  const BwdRows<T> in(p, blockIdx.x, blockIdx.y);
  const int64_t slot = in.bh * nc + in.c;
  const float* ug = p.u + (in.bh % p.h) * D;
  T* dr = static_cast<T*>(p.dr) + in.g0;
  T* dk = static_cast<T*>(p.dk) + in.g0;
  T* dv = static_cast<T*>(p.dv) + in.g0;

  // the plane's element (t, j), block (t / kPart, j / kPart) on or below
  // the diagonal
  auto pl = [&](int t, int j) -> float& {
    const int bi = t / kPart;
    return PL[(bi * (bi + 1) / 2 + j / kPart) * kBlock + (t % kPart) * LB
              + j % kPart];
  };
  auto e_row = [&](int q) { return LA + (kPart * q + kPart - 1) * LD; };
  // r~ = r e^(lp - E_{I-1}) for a row t of sub-chunk I >= 1
  auto rt = [&](int t, int d) {
    const float* e_prev = LA + ((t / kPart) * kPart - 1) * LD;
    return to_f32(R[t * LE + d]) * __expf(LA[(t - 1) * LD + d] - e_prev[d]);
  };
  auto valid = [&](int row) { return row < C && in.t0 + row < p.t; };
  // the diagonal block's share of dk (is_dk) or dr, into out (CP x LD), a
  // thread a (sub-chunk, channel).  Inside a sub-chunk e^(lp_t - la_j) =
  // prod_{m = j + 1}^{t - 1} w_m with w_m = e^(la_m - la_(m-1)): running
  // products of 15 exps a thread, where a pair's own exp would take 120
  // (the products telescope to the same la differences).
  auto diag_pass = [&](bool is_dk, float* out) {
    const int q = tid / D, c = tid % D;
    if (q >= parts) return;
    const int t0r = kPart * q;
    float om[kPart], xv[kPart];
#pragma unroll
    for (int m = 0; m < kPart; ++m) {
      om[m] = m ? __expf(LA[(t0r + m) * LD + c] - LA[(t0r + m - 1) * LD + c])
                : 1.f;
      xv[m] = to_f32(is_dk ? R[(t0r + m) * LE + c] : K[(t0r + m) * LE + c]);
    }
    const float* blk = &pl(t0r, t0r);
    if (is_dk) {  // dk_j = sum_{t > j} dM_tj r_t e^(lp_t - la_j)
#pragma unroll
      for (int jj = 0; jj < kPart; ++jj) {
        float f = 1.f, acc_d = 0.f;
#pragma unroll
        for (int tt = jj + 1; tt < kPart; ++tt) {
          acc_d = fmaf(blk[tt * LB + jj] * xv[tt], f, acc_d);
          f *= om[tt];
        }
        out[(t0r + jj) * LD + c] = acc_d;
      }
    } else {  // dr_t = sum_{j < t} dM_tj k_j e^(lp_t - la_j)
#pragma unroll
      for (int tt = 0; tt < kPart; ++tt) {
        float f = 1.f, acc_d = 0.f;
#pragma unroll
        for (int jj = tt - 1; jj >= 0; --jj) {
          acc_d = fmaf(blk[tt * LB + jj] * xv[jj], f, acc_d);
          f *= om[jj];
        }
        out[(t0r + tt) * LD + c] = acc_d;
      }
    }
  };
  const float* s_c = sc.s + slot * D * D;  // S_c
  constexpr int kSq4 = D * D / 4 / kThreads > 0 ? D * D / 4 / kThreads : 1;

  // ---- the chunk's tiles (the rows past the chunk or T as identity
  // tokens) and dS_c by cp.async in three groups: w; r and k; v, dO and
  // dS_c, each awaited just before its first use; S_c (read after dk) is
  // prefetched into L2 meanwhile
  stage_rows<D>(LA, LD, CP, C, in.t0, p.t, in.w, p.w_st, 1.f);
  cp_async_commit();
  stage_rows<D>(R, LE, CP, C, in.t0, p.t, in.r, p.r_st, zero_t);
  stage_rows<D>(K, LE, CP, C, in.t0, p.t, in.k, p.k_st, zero_t);
  cp_async_commit();
  stage_rows<D>(V, LV, CP, C, in.t0, p.t, in.v, p.v_st, zero_t);
  stage_rows<D>(DO, LD, CP, C, in.t0, p.t, in.dout, p.o_st, 0.f);
  {
    const float* ds = sc.ds + slot * D * D;
    for (int i = tid; i < D * D / 4; i += kThreads)
      cp_async16(X + (4 * i / D) * SP + 4 * i % D, ds + 4 * i);
    const char* s_next = reinterpret_cast<const char*>(s_c);
    for (int i = tid; i < D * D * 4 / 128; i += kThreads)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(s_next + 128 * i));
  }
  cp_async_commit();
  asm volatile("cp.async.wait_group 2;\n" ::);  // w
  __syncthreads();
  cumsum_log_rows<D, LD>(LA, TOT, CP);
  const float* lam = LA + (CP - 1) * LD;

  // ---- the tables, k~ and rd
  for (int i = tid; i < parts * D; i += kThreads) {
    const int q = i / D, d = i % D;
    const float prev = q ? e_row(q - 1)[d] : 0.f;
    EE[q * D + d] = __expf(prev);
    EL[q * D + d] = __expf(lam[d] - e_row(q)[d]);
    for (int j = 0; j < q; ++j)
      G[(q * (q - 1) / 2 + j) * D + d] = __expf(prev - e_row(j)[d]);
  }
  asm volatile("cp.async.wait_group 1;\n" ::);  // r and k
  __syncthreads();
  constexpr int kIt = kMaxChunk * D / kThreads;
#pragma unroll
  for (int n = 0; n < kIt; ++n) {
    const int i = tid + n * kThreads, t = i / D, d = i % D;
    if (t < CP)
      KT[t * LD + d] = to_f32(K[t * LE + d])
                       * __expf(e_row(t / kPart)[d] - LA[t * LD + d]);
  }
  for (int t = warp; t < CP; t += kThreads / 32) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s = fmaf(to_f32(R[t * LE + d]) * ug[d], to_f32(K[t * LE + d]), s);
    s = warp_sum(s);
    if (lane == 0) RD[t] = s;
  }
  __syncthreads();

  // ---- M: below the diagonal blocks on the tensor cores, r~ (k~ g)
  {
    const WarpTiles wt(CP, CP, warp);
    const int bi = wt.mt, lim = min(wt.n_tiles, 2 * bi);
    if (bi > 0 && lim > 0) {
      float acc[4][4];
      zero(acc);
      const float* gi = G + (bi * (bi - 1) / 2) * D;
      warp_mma<false>(
          acc, wt.mt, wt.nt, wt.n_step, lim, 0, D / 16,
          [&](int m, int k) { return rt(m, k); },
          [&](int k, int n) {
            return KT[n * LD + k] * gi[(n / kPart) * D + k];
          });
      for_acc(wt, lim, [&](int j, int e, int row, int col) {
        pl(row, col) = acc[j][e];
      });
    }
  }
  // the diagonal blocks: zeros on and above the diagonal; below it, the
  // pairs with t in the block's last 8 rows and j in its first 8 on the
  // tensor cores, e^(lp_t - la_j) = e^(lp_t - E8) e^(E8 - la_j) with E8
  // the la of the block's row 7 (both factors <= 1; warps 0 and 4, idle in
  // the products above), and the pairs within either 8 rows with one exp
  // per (t, j < t, d).  For those a thread takes rows pp and 7 - pp of an
  // 8-row half (7 pairs between them, sharing the loads of k_j and la_j)
  // over every kSlices-th channel; the kSlices threads of a row pair are
  // adjacent lanes and add their sums by shuffles, in a fixed order.
  for (int i = tid; i < parts * kPart * kPart; i += kThreads) {
    const int q = i / (kPart * kPart), tt = (i / kPart) % kPart;
    const int jj = i % kPart;
    if (jj >= tt) pl(kPart * q + tt, kPart * q + jj) = 0.f;
  }
  for (int q = warp % 4 == 0 ? warp / 4 : parts; q < parts; q += 2) {
    float acc[4][4];
    zero(acc);
    const float* e8 = LA + (kPart * q + kHalfPart - 1) * LD;
    warp_mma<false>(
        acc, q, 2 * q, 1, 2 * q + 1, 0, D / 16,
        [&](int m, int k) {
          return m % kPart < kHalfPart ? 0.f
              : to_f32(R[m * LE + k]) * __expf(LA[(m - 1) * LD + k] - e8[k]);
        },
        [&](int k, int n) {
          return to_f32(K[n * LE + k]) * __expf(e8[k] - LA[n * LD + k]);
        });
    const int row = kPart * q + kHalfPart + lane / 4;
    const int col = kPart * q + 2 * (lane % 4);
    pl(row, col) = acc[0][2];
    pl(row, col + 1) = acc[0][3];
  }
  {
    constexpr int kSlices = 8, kQuarter = kHalfPart / 2;
    const int sl = tid % kSlices, item = tid / kSlices;
    const int q = item / kHalfPart, pp = item % kQuarter;
    const int base = kPart * q + kHalfPart * ((item / kQuarter) % 2);
    const int t1 = base + pp, t2 = base + kHalfPart - 1 - pp;
    float a1[kQuarter - 1], a2[kHalfPart - 1];
#pragma unroll
    for (int jj = 0; jj < kHalfPart - 1; ++jj) {
      if (jj < kQuarter - 1) a1[jj] = 0.f;
      a2[jj] = 0.f;
    }
    if (q < parts) {
      for (int n = 0; n < D / kSlices; ++n) {
        const int d = n * kSlices + sl;
        const float r1 = to_f32(R[t1 * LE + d]), r2 = to_f32(R[t2 * LE + d]);
        const float p1 = pp ? LA[(t1 - 1) * LD + d] : 0.f;
        const float p2 = LA[(t2 - 1) * LD + d];
#pragma unroll
        for (int jj = 0; jj < kHalfPart - 1; ++jj) {
          if (jj >= kHalfPart - 1 - pp) break;
          const int j = base + jj;
          const float kv = to_f32(K[j * LE + d]), la = LA[j * LD + d];
          a2[jj] = fmaf(r2 * kv, __expf(p2 - la), a2[jj]);
          if (jj < kQuarter - 1 && jj < pp)
            a1[jj] = fmaf(r1 * kv, __expf(p1 - la), a1[jj]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kHalfPart - 1; ++jj) {
#pragma unroll
      for (int off = 1; off < kSlices; off *= 2) {
        if (jj < kQuarter - 1)
          a1[jj] += __shfl_xor_sync(0xffffffffu, a1[jj], off);
        a2[jj] += __shfl_xor_sync(0xffffffffu, a2[jj], off);
      }
    }
    if (q < parts && sl == 0) {
#pragma unroll
      for (int jj = 0; jj < kHalfPart - 1; ++jj) {
        if (jj < kQuarter - 1 && jj < pp) pl(t1, base + jj) = a1[jj];
        if (jj < kHalfPart - 1 - pp) pl(t2, base + jj) = a2[jj];
      }
    }
  }
  __syncthreads();

  cp_async_wait_all();  // the third group: v, dO and dS_c
  __syncthreads();

  // ---- dv = M^T dO + kd dS_c + rd dO, kd = k~ e^(lam - E_J)
  const WarpTiles ot(CP, D, warp);  // the (row, channel) outputs
  const int bo = ot.mt;             // their sub-chunk
  {
    float acc[4][4];
    zero(acc);
    warp_mma<false>(
        acc, ot.mt, ot.nt, ot.n_step, ot.n_tiles, bo, parts,
        [&](int m, int k) { return pl(k, m); },
        [&](int k, int n) { return DO[k * LD + n]; });
    warp_mma<false>(
        acc, ot.mt, ot.nt, ot.n_step, ot.n_tiles, 0, D / 16,
        [&](int m, int k) { return KT[m * LD + k] * EL[bo * D + k]; },
        [&](int k, int n) { return X[k * SP + n]; });
    for_acc(ot, ot.n_tiles, [&](int j, int e, int row, int col) {
      if (valid(row))
        store(dv + (in.t0 + row) * p.g_st + col,
              fmaf(RD[row], DO[row * LD + col], acc[j][e]));
    });
  }
  __syncthreads();  // every read of M is done

  // ---- dM = dO V^T below the diagonal (zeros on and above it), drd on it
  {
    const WarpTiles wt(CP, CP, warp);
    const int lim = min(wt.n_tiles, 2 * wt.mt + 2);
    float acc[4][4];
    zero(acc);
    warp_mma<kExact>(
        acc, wt.mt, wt.nt, wt.n_step, lim, 0, D / 16,
        [&](int m, int k) { return DO[m * LD + k]; },
        [&](int k, int n) { return to_f32(V[n * LV + k]); });
    for_acc(wt, lim, [&](int j, int e, int row, int col) {
      pl(row, col) = col < row ? acc[j][e] : 0.f;
      if (col == row) DRD[row] = acc[j][e];
    });
  }
  __syncthreads();

  // ---- dk = e^(E_J - la) (e^(lam - E_J) V dS_c^T + sum_{I > J} g_IJ dM^T
  // r~) + the diagonal block + drd u r; d la = -k (dk - drd u r) and the
  // column sums of kx = kd (V dS_c^T)
  float dla[4][4];
  {
    float acc[4][4];
    zero(acc);
    warp_mma<false, kExact>(
        acc, ot.mt, ot.nt, ot.n_step, ot.n_tiles, 0, D / 16,
        [&](int m, int k) { return to_f32(V[m * LV + k]); },
        [&](int k, int n) { return X[n * SP + k]; });
    // kx's column sums over the m tile's rows, by shuffles over the lanes
    // of a column (g)
    const float* ej = e_row(bo);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n8 = ot.nt + j * ot.n_step;
      if (n8 >= ot.n_tiles) break;
      float cs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * bo + lane / 4 + 8 * (e / 2);
        const int col = 8 * n8 + 2 * (lane % 4) + e % 2;
        acc[j][e] *= EL[bo * D + col];
        cs[e % 2] = fmaf(to_f32(K[row * LE + col])
                             * __expf(ej[col] - LA[row * LD + col]),
                         acc[j][e], cs[e % 2]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 4);
        cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 8);
        cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 16);
      }
      if (lane < 4) {
        KXS[bo * D + 8 * n8 + 2 * lane] = cs[0];
        KXS[bo * D + 8 * n8 + 2 * lane + 1] = cs[1];
      }
    }
    const float* gj = G + bo * D;  // g_IJ at [(I (I - 1) / 2 + J) D]
    warp_mma<false>(
        acc, ot.mt, ot.nt, ot.n_step, ot.n_tiles, bo + 1, parts,
        [&](int m, int k) { return pl(k, m); },
        [&](int k, int n) {
          const int bi = k / kPart;
          return rt(k, n) * gj[(bi * (bi - 1) / 2) * D + n];
        });
    for_acc(ot, ot.n_tiles, [&](int j, int e, int row, int col) {
      acc[j][e] *= __expf(ej[col] - LA[row * LD + col]);
    });
    __syncthreads();  // every product is done
    // rowsum(S_c dS_c) while dS_c is in X: a row's float4s are adjacent
    // lanes of one or two warps; then X takes dk's diagonal
    {
      constexpr int kW = D / 4 < 32 ? D / 4 : 32;  // lanes a row
#pragma unroll
      for (int n = 0; n < kSq4; ++n) {
        const int i = tid + n * kThreads;
        const int d = 4 * i / D, e = 4 * i % D;
        float prod = 0.f;
        if (i < D * D / 4) {
          const float4 sv = reinterpret_cast<const float4*>(s_c)[i];
          const float4 ds = *reinterpret_cast<const float4*>(X + d * SP + e);
          prod = sv.x * ds.x + sv.y * ds.y + sv.z * ds.z + sv.w * ds.w;
        }
#pragma unroll
        for (int off = kW / 2; off > 0; off /= 2)
          prod += __shfl_xor_sync(0xffffffffu, prod, off);
        if (i < D * D / 4 && lane % kW == 0) SSUM[d] = prod;
      }
    }
    __syncthreads();
    diag_pass(true, X);
    __syncthreads();
    for_acc(ot, ot.n_tiles, [&](int j, int e, int row, int col) {
      const float s = acc[j][e] + X[row * LD + col];
      dla[j][e] = -to_f32(K[row * LE + col]) * s;
      if (valid(row))
        store(dk + (in.t0 + row) * p.g_st + col,
              fmaf(DRD[row] * ug[col], to_f32(R[row * LE + col]), s));
    });
  }
  __syncthreads();  // every read of X is done

  // ---- S_c into X
#pragma unroll
  for (int n = 0; n < kSq4; ++n) {
    const int i = tid + n * kThreads;
    if (i < D * D / 4)
      *reinterpret_cast<float4*>(X + (4 * i / D) * SP + 4 * i % D) =
          reinterpret_cast<const float4*>(s_c)[i];
  }
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int q = 0; q < parts; ++q) s += KXS[q * D + tid];
    DLAM[tid] = fmaf(__expf(lam[tid]), SSUM[tid], s);
  }

  // ---- dr = e^(lp - E_{I-1}) (e^E_{I-1} dO S_c^T + sum_{J < I} dM (k~
  // g_IJ)) + the diagonal block + drd u k; d lp = r (dr - drd u k)
  float acc[4][4];
  zero(acc);
  warp_mma<false>(
      acc, ot.mt, ot.nt, ot.n_step, ot.n_tiles, 0, D / 16,
      [&](int m, int k) { return DO[m * LD + k]; },
      [&](int k, int n) { return X[n * SP + k]; });
  for_acc(ot, ot.n_tiles, [&](int j, int e, int row, int col) {
    acc[j][e] *= EE[bo * D + col];
  });
  {
    const float* gi = G + (bo * (bo - 1) / 2) * D;
    warp_mma<false>(
        acc, ot.mt, ot.nt, ot.n_step, ot.n_tiles, 0, bo,
        [&](int m, int k) { return pl(m, k); },
        [&](int k, int n) {
          return KT[k * LD + n] * gi[(k / kPart) * D + n];
        });
  }
  for_acc(ot, ot.n_tiles, [&](int j, int e, int row, int col) {
    acc[j][e] *= __expf((row ? LA[(row - 1) * LD + col] : 0.f)
                        - (bo ? e_row(bo - 1)[col] : 0.f));
  });
  __syncthreads();  // every product is done: DO, KT and S_c are free
  // w again, for dw, copied into X while dr finishes; dr's diagonal into
  // KT, then d lp in its place (each element read and written by its
  // owner); d la into DO
  float* WS = X;
  float* QA = DO;  // d la
  float* QB = KT;  // dr's diagonal, then d lp
  stage_rows<D>(WS, LD, CP, C, in.t0, p.t, in.w, p.w_st, 1.f);
  cp_async_commit();
  for_acc(ot, ot.n_tiles, [&](int j, int e, int row, int col) {
    QA[row * LD + col] = dla[j][e];
  });
  diag_pass(false, QB);
  __syncthreads();
  for_acc(ot, ot.n_tiles, [&](int j, int e, int row, int col) {
    const float s = acc[j][e] + QB[row * LD + col];
    QB[row * LD + col] = to_f32(R[row * LE + col]) * s;
    if (valid(row))
      store(dr + (in.t0 + row) * p.g_st + col,
            fmaf(DRD[row] * ug[col], to_f32(K[row * LE + col]), s));
  });
  cp_async_wait_all();
  __syncthreads();

  // ---- d log w_s = d la_s + sum_{t > s} (d la_t + d lp_t) + d lam, by a
  // reverse scan down each channel in kSegs segments; then dw
  {
    const int d = tid % D, seg = tid / D;
    const int per = (CP + kSegs - 1) / kSegs;
    const int lo = seg * per, hi = min(CP, lo + per);
    float sum = 0.f;
    for (int t = lo; t < hi; ++t) sum += QA[t * LD + d] + QB[t * LD + d];
    TOT[seg * D + d] = sum;
    __syncthreads();
    float run = DLAM[d];
    for (int s = kSegs - 1; s > seg; --s) run += TOT[s * D + d];
    constexpr int kPer = (kMaxChunk + kSegs - 1) / kSegs;
#pragma unroll
    for (int n = kPer - 1; n >= 0; --n) {
      const int t = lo + n;
      if (t >= hi) continue;
      const float a = QA[t * LD + d];
      const float gw = run + a;
      run += a + QB[t * LD + d];
      if (valid(t)) {
        const float wv = WS[t * LD + d];
        p.dw[in.g0 + (in.t0 + t) * p.g_st + d] =
            wv > kWFloor ? gw / wv : (wv == kWFloor ? 0.5f * gw / wv : 0.f);
      }
    }
  }
}

// The blocks of the last backward call's three launches (local sums,
// folds, gradients), as launched; wkv6_bwd_last_blocks reads them.
int64_t g_bwd_blocks[3] = {0, 0, 0};

int64_t blocks_of(const dim3& g) {
  return static_cast<int64_t>(g.x) * g.y * g.z;
}

// The three launches of one backward call, on the caller's stream.
template <typename T, int D>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const int64_t nc = (p.t + p.chunk - 1) / p.chunk;
  if (nc > 65535) return cudaErrorInvalidValue;  // launch 3's grid.y
  const size_t local = LocalLayout<T, D>(p.chunk).bytes;
  const size_t grad = GradLayout<T, D>(p.chunk).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_local_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(LocalLayout<T, D>(kMaxChunk).bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      wkv6_bwd_grad_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(GradLayout<T, D>(kMaxChunk).bytes));
  if (err != cudaSuccess) return err;
  if (nc == 0) {  // no chunk: ds0 is ds_final, du is zero
    g_bwd_blocks[0] = g_bwd_blocks[1] = g_bwd_blocks[2] = 0;
    const size_t sq = sizeof(float) * p.bh * D * D;
    err = p.ds_final ? cudaMemcpyAsync(p.ds0, p.ds_final, sq,
                                       cudaMemcpyDeviceToDevice, stream)
                     : cudaMemsetAsync(p.ds0, 0, sq, stream);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(p.du, 0, sizeof(float) * p.bh * D, stream);
  }
  if (p.bh > 65535) return cudaErrorInvalidValue;  // launch 1's grid.y
  const int64_t folds = (p.bh * D * D / 4 + kThreads - 1) / kThreads;
  const dim3 local_grid(static_cast<unsigned>(nc),
                        static_cast<unsigned>(p.bh));
  const dim3 fold_grid(static_cast<unsigned>(folds), 3);
  const dim3 grad_grid(static_cast<unsigned>(p.bh),
                       static_cast<unsigned>(nc));
  g_bwd_blocks[0] = blocks_of(local_grid);
  g_bwd_blocks[1] = blocks_of(fold_grid);
  g_bwd_blocks[2] = blocks_of(grad_grid);
  wkv6_bwd_local_kernel<T, D><<<local_grid, kThreads, local, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_fold_kernel<D><<<fold_grid, kThreads, 0, stream>>>(p, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_grad_kernel<T, D><<<grad_grid, kThreads, grad, stream>>>(p, nc);
  return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const BwdParams& p, int64_t d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_bwd<T, 16>(p, s);
    case 32: return launch_bwd<T, 32>(p, s);
    case 64: return launch_bwd<T, 64>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r/k/v (b, h, t, d) of float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) and w
// (b, h, t, d) float32, each with the given batch/head/time strides in
// elements and a contiguous last dim; u (h, d) and s0 (b, h, d, d) float32
// contiguous, s0 may be null (a zero state); out (b, h, t, d) float32
// written through its strides; s_out (b, h, d, d) float32 contiguous.
// d in {16, 32, 64}, 1 <= chunk <= 64.
int wkv6_forward(const void* r, const void* k, const void* v, const float* w,
                 const float* u, const float* s0, float* out, float* s_out,
                 int64_t b, int64_t h, int64_t t, int64_t d, int64_t chunk,
                 int64_t r_sb, int64_t r_sh, int64_t r_st,
                 int64_t k_sb, int64_t k_sh, int64_t k_st,
                 int64_t v_sb, int64_t v_sh, int64_t v_st,
                 int64_t w_sb, int64_t w_sh, int64_t w_st,
                 int64_t o_sb, int64_t o_sh, int64_t o_st,
                 int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || t < 0) return cudaErrorInvalidValue;
  if (b == 0 || h == 0) return cudaSuccess;
  const Params p{r, k, v, w, u, s0, out, s_out, h, t,
                 r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                 w_sb, w_sh, w_st, o_sb, o_sh, o_st, static_cast<int>(chunk)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(p, b * h, d, st)
                 : dispatch_d<float>(p, b * h, d, st);
}

// K7's backward.  r/k/v/w as wkv6_forward takes them, dout (b, h, t, d)
// float32 through its strides, ds_final (b, h, d, d) float32 contiguous or
// null (zero); dr/dk/dv (r's type) and dw (float32) written through the
// strides g_* (the same for all four); du_part (b, h, d) and ds0 (b, h,
// d, d) float32 contiguous; scratch a float32 buffer of b * h * ceil(t /
// chunk) * (2 d^2 + 2 d) floats.  d in {16, 32, 64}, 1 <= chunk <= 64.
// Three launches on the caller's stream (a copy and a memset when t = 0).
int wkv6_backward(const void* r, const void* k, const void* v,
                  const float* w, const float* u, const float* s0,
                  const float* dout, const float* ds_final, void* dr,
                  void* dk, void* dv, float* dw, float* du_part, float* ds0,
                  float* scratch, int64_t b, int64_t h, int64_t t, int64_t d,
                  int64_t chunk,
                  int64_t r_sb, int64_t r_sh, int64_t r_st,
                  int64_t k_sb, int64_t k_sh, int64_t k_st,
                  int64_t v_sb, int64_t v_sh, int64_t v_st,
                  int64_t w_sb, int64_t w_sh, int64_t w_st,
                  int64_t o_sb, int64_t o_sh, int64_t o_st,
                  int64_t g_sb, int64_t g_sh, int64_t g_st,
                  int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || t < 0) return cudaErrorInvalidValue;
  if (b == 0 || h == 0) return cudaSuccess;
  const BwdParams p{r, k, v, w, u, s0, dout, ds_final, dr, dk, dv, dw,
                    du_part, ds0, scratch, b * h, h, t,
                    r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                    w_sb, w_sh, w_st, o_sb, o_sh, o_st, g_sb, g_sh, g_st,
                    static_cast<int>(chunk)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bwd<__nv_bfloat16>(p, d, st)
                 : dispatch_bwd<float>(p, d, st);
}

// The blocks that the last wkv6_backward call of this process launched,
// into out[0..2]: its local sums, its folds, its gradients (0 each when t
// = 0).
void wkv6_bwd_last_blocks(int64_t* out) {
  for (int i = 0; i < 3; ++i) out[i] = g_bwd_blocks[i];
}

}  // extern "C"
