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
// A is split into bf16 hi + lo, and so is B unless kExactB (B's values are
// bf16 already): hi hi + lo hi (+ hi lo) into one f32 sum, about 2^-16 of
// each product.
template <bool kExactB, typename FA, typename FB>
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
      mma_bf16(acc[j], al, bh0, bh1);
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
// (repro/models/ssm.py).  Per (batch, head), with dO the output's gradient
// and dS the carried state gradient (from ds_final, zero when null), a
// reverse sweep over the chunks computes, per chunk (lp = la_prev, lam =
// la of its last row, S its incoming state, kd = k e^(lam - la), M_tj =
// sum_d r_td k_jd e^(lp_td - la_jd) and dM_tj = dO_t . v_j for j < t, rd_t
// = r_t . (u k_t), drd_t = dO_t . v_t):
//
//   dv    = M^T dO + rd dO + kd dS^T
//   dr    = e^lp (dO S^T) + (dM * decay) k + drd u k
//   dk    = (dM * decay)^T r + e^(lam - la) (V dS^T) + drd u r
//   du   += sum_t drd_t r_t k_t
//   dS_in = e^lam dS + (r e^lp)^T dO
//
// and the decay's gradient without another pass over the (t, j) plane:
// d lp = r (dr - drd u k), d la = -k (dk - drd u r), d lam = e^lam
// rowsum(S dS) + sum_j kd_j (V dS^T)_j, d log w_s = sum_{t >= s} d la_t +
// sum_{t > s} d lp_t + d lam (a reverse cumsum down each channel), dw = d
// log w / w above the floor 1e-30, half of it at the floor (the gradient
// of jnp.maximum), none below.  ref.py's wkv6_chunked_bwd is the same
// algorithm in plain torch.
//
// Design (a first, simple one): one block of 256 threads per (batch,
// head).  A forward pass from s0 writes each chunk's incoming state S to a
// scratch buffer (nc x D x D float32 a head; the forward kernel's serving
// call and bits stay as they are), then the reverse sweep runs with dS in
// shared memory.  Every chunk is padded to 64 rows of identity tokens (w =
// 1, r = k = v = dO = 0), so the (t, j) plane is always 64 x 64 and cut
// into 4 x 4 blocks of 16-row sub-chunks.  A block below the diagonal
// factors its decays as the forward kernel does, e^(lp_t - la_j) =
// e^(lp_t - E_{I-1}) e^(E_{I-1} - E_J) e^(E_J - la_j) with E_J the la of
// sub-chunk J's last row, three factors <= 1: r~ = r e^(lp - E_{I-1}) and
// k~ = k e^(E_J - la) are kept as tiles and the middle factor in a table;
// the diagonal blocks take one exp per (t, j < t, d).  Every exponent is
// <= 0.  The products are f32 FMAs on the CUDA cores (no tensor cores, no
// cluster split yet), each thread holding a 4 x (D / 16) register tile of
// the (row, channel) outputs; every sum has a fixed order and nothing is
// atomic, so reruns give the same bits, and du is written per (batch,
// head) for the wrapper to sum over the batch in order.
//
// Bound on an H100 SXM at the training shape (B = 8, H = 32, T = 512, D =
// 64, bf16 r/k/v): the function reads r, k, v, w, dO and writes dr, dk,
// dv, dw (PERF.md has the bytes and operations, chip_smoke.py computes
// them); the design above is bound by shared-memory traffic and latency
// (256 blocks of one 190 KB block an SM: two waves on 132 SMs), not by the
// card's rates.
// ---------------------------------------------------------------------------

constexpr int kRows = kMaxChunk;        // a chunk's rows, padded
constexpr int kPart = 16;               // rows of a sub-chunk
constexpr int kParts = kRows / kPart;   // sub-chunks of a chunk
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
  float* du;      // (b * h, d): per (batch, head)
  float* ds0;
  float* states;  // (b * h, chunks, d, d) scratch
  int64_t h, t;
  int64_t r_sb, r_sh, r_st;
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t w_sb, w_sh, w_st;
  int64_t o_sb, o_sh, o_st;   // dout
  int64_t g_sb, g_sh, g_st;   // dr, dk, dv and dw
  int chunk;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Float offsets of the backward's shared memory.
template <int D>
struct BwdLayout {
  static constexpr int LD = D + 1;       // pitch of a (row, channel) tile
  static constexpr int LP = kRows + 1;   // pitch of a (t, j) plane
  static constexpr int kTile = kRows * LD;
  static constexpr int R = 0, K = R + kTile, V = K + kTile, DO = V + kTile;
  static constexpr int LA = DO + kTile;  // log w, then its cumsum
  static constexpr int RT = LA + kTile;  // r~, then d la
  static constexpr int KT = RT + kTile;  // k~, then d lp
  static constexpr int PM = KT + kTile;  // M, then k * (dk's state part)
  static constexpr int PDM = PM + kRows * LP;          // dM
  static constexpr int S = PDM + kRows * LP;           // D x LD
  static constexpr int DS = S + D * LD;                // D x LD
  static constexpr int G = DS + D * LD;                // [I][J][D], J < I
  static constexpr int EE = G + kParts * kParts * D;   // [I][D]: e^E_{I-1}
  static constexpr int EL = EE + kParts * D;           // [J][D]: e^(lam-E_J)
  static constexpr int RD = EL + kParts * D;           // kRows
  static constexpr int DRD = RD + kRows;               // kRows
  static constexpr int kFloats = DRD + kRows;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) wkv6_bwd_kernel(BwdParams p) {
  using L = BwdLayout<D>;
  constexpr int LD = L::LD, LP = L::LP, ND = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* R = sm + L::R;
  float* K = sm + L::K;
  float* V = sm + L::V;
  float* DO = sm + L::DO;
  float* LA = sm + L::LA;
  float* RT = sm + L::RT;
  float* KT = sm + L::KT;
  float* PM = sm + L::PM;
  float* PDM = sm + L::PDM;
  float* S = sm + L::S;
  float* DS = sm + L::DS;
  float* G = sm + L::G;
  float* EE = sm + L::EE;
  float* EL = sm + L::EL;
  float* RD = sm + L::RD;
  float* DRD = sm + L::DRD;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.h, head = bh % p.h;
  const int C = p.chunk;
  const int64_t nc = (p.t + C - 1) / C;
  const T* rg = static_cast<const T*>(p.r) + b * p.r_sb + head * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + head * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + head * p.v_sh;
  const float* wg = p.w + b * p.w_sb + head * p.w_sh;
  const float* dog = p.dout + b * p.o_sb + head * p.o_sh;
  const float* ug = p.u + head * D;
  const int64_t g0 = b * p.g_sb + head * p.g_sh;
  float* states = p.states + bh * nc * D * D;

  // chunk c's rows of a (B, H, T, D) input as a 64-row f32 tile, the rows
  // past the chunk or past T as zeros
  auto load = [&](float* dst, auto src, int64_t st, int64_t c) {
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const int64_t pos = c * C + t;
      dst[t * LD + d] = t < C && pos < p.t ? to_f32(src[pos * st + d]) : 0.f;
    }
  };
  // LA = cumsum of log max(w, 1e-30) down each channel (the rows past the
  // chunk or T are w = 1, log 0)
  auto load_la = [&](int64_t c) {
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const int64_t pos = c * C + t;
      LA[t * LD + d] = t < C && pos < p.t
          ? logf(fmaxf(wg[pos * p.w_st + d], kWFloor)) : 0.f;
    }
    __syncthreads();
    if (tid < D) {
      float run = 0.f;
      for (int t = 0; t < kRows; ++t) {
        run += LA[t * LD + tid];
        LA[t * LD + tid] = run;
      }
    }
    __syncthreads();
  };
  const float* lam = LA + (kRows - 1) * LD;

  // ---- forward: each chunk's incoming state to the scratch buffer
  for (int i = tid; i < D * D; i += kThreads)
    S[(i / D) * LD + i % D] = p.s0 ? p.s0[bh * D * D + i] : 0.f;
  for (int64_t c = 0; c < nc; ++c) {
    __syncthreads();
    for (int i = tid; i < D * D; i += kThreads)
      states[c * D * D + i] = S[(i / D) * LD + i % D];
    if (c + 1 == nc) break;
    load(K, kg, p.k_st, c);
    load(V, vg, p.v_st, c);
    load_la(c);
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int t = i / D, d = i % D;
      KT[t * LD + d] = K[t * LD + d] * __expf(lam[d] - LA[t * LD + d]);
    }
    __syncthreads();
    float acc[ND][ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const float dl = __expf(lam[ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        acc[i][j] = dl * S[(ty + 16 * i) * LD + tx + 16 * j];
    }
    for (int t = 0; t < kRows; ++t) {
      float kd[ND], vv[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        kd[i] = KT[t * LD + ty + 16 * i];
        vv[i] = V[t * LD + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(kd[i], vv[j], acc[i][j]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j)
        S[(ty + 16 * i) * LD + tx + 16 * j] = acc[i][j];
  }

  // ---- the reverse sweep
  for (int i = tid; i < D * D; i += kThreads)
    DS[(i / D) * LD + i % D] = p.ds_final ? p.ds_final[bh * D * D + i] : 0.f;
  float du_acc = 0.f;  // threads < D: channel tid
  for (int64_t c = nc - 1; c >= 0; --c) {
    __syncthreads();
    load(R, rg, p.r_st, c);
    load(K, kg, p.k_st, c);
    load(V, vg, p.v_st, c);
    load(DO, dog, p.o_st, c);
    for (int i = tid; i < D * D; i += kThreads)
      S[(i / D) * LD + i % D] = states[c * D * D + i];
    load_la(c);

    // the tables of the factored decays, r~ and k~, rd
    if (tid < D) {
      const int d = tid;
      float e[kParts];
#pragma unroll
      for (int q = 0; q < kParts; ++q) e[q] = LA[(kPart * q + kPart - 1) * LD + d];
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        const float prev = q ? e[q > 0 ? q - 1 : 0] : 0.f;
        EE[q * D + d] = __expf(prev);
        EL[q * D + d] = __expf(lam[d] - e[q]);
#pragma unroll
        for (int j = 0; j < q; ++j)
          G[(q * kParts + j) * D + d] = __expf(prev - e[j]);
      }
    } else if (tid >= kThreads - kRows) {
      const int t = tid - (kThreads - kRows);
      float s = 0.f;
      for (int d = 0; d < D; ++d)
        s = fmaf(R[t * LD + d] * ug[d], K[t * LD + d], s);
      RD[t] = s;
    }
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int t = i / D, d = i % D, q = t / kPart;
      const float lp = t ? LA[(t - 1) * LD + d] : 0.f;
      const float e_prev = q ? LA[(kPart * q - 1) * LD + d] : 0.f;
      const float e_end = LA[(kPart * q + kPart - 1) * LD + d];
      RT[t * LD + d] = R[t * LD + d] * __expf(lp - e_prev);
      KT[t * LD + d] = K[t * LD + d] * __expf(e_end - LA[t * LD + d]);
    }
    __syncthreads();

    // the (t, j) plane: dM and drd from dO V^T, and M; thread (ty, tx)
    // holds (t, j) = (ty + 16 i, tx + 16 jj), so block (i, jj) of the plane
    {
      float gacc[kParts][kParts], macc[kParts][kParts];
#pragma unroll
      for (int i = 0; i < kParts; ++i)
#pragma unroll
        for (int j = 0; j < kParts; ++j) gacc[i][j] = macc[i][j] = 0.f;
      for (int e = 0; e < D; ++e) {
        float dov[kParts], vv[kParts];
#pragma unroll
        for (int i = 0; i < kParts; ++i) {
          dov[i] = DO[(ty + 16 * i) * LD + e];
          vv[i] = V[(tx + 16 * i) * LD + e];
        }
#pragma unroll
        for (int i = 0; i < kParts; ++i)
#pragma unroll
          for (int j = 0; j < kParts; ++j)
            gacc[i][j] = fmaf(dov[i], vv[j], gacc[i][j]);
      }
      for (int d = 0; d < D; ++d) {
        float rt[kParts], kt[kParts];
#pragma unroll
        for (int i = 0; i < kParts; ++i) {
          rt[i] = RT[(ty + 16 * i) * LD + d];
          kt[i] = KT[(tx + 16 * i) * LD + d];
        }
#pragma unroll
        for (int i = 1; i < kParts; ++i)
#pragma unroll
          for (int j = 0; j < i; ++j)
            macc[i][j] = fmaf(rt[i], kt[j] * G[(i * kParts + j) * D + d],
                              macc[i][j]);
        if (ty > tx) {
#pragma unroll
          for (int i = 0; i < kParts; ++i) {
            const int t = ty + 16 * i, j = tx + 16 * i;
            macc[i][i] = fmaf(R[t * LD + d] * K[j * LD + d],
                              __expf(LA[(t - 1) * LD + d] - LA[j * LD + d]),
                              macc[i][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kParts; ++i)
#pragma unroll
        for (int j = 0; j < kParts; ++j) {
          const int t = ty + 16 * i, jj = tx + 16 * j;
          PDM[t * LP + jj] = jj < t ? gacc[i][j] : 0.f;
          PM[t * LP + jj] = jj < t ? macc[i][j] : 0.f;
          if (jj == t) DRD[t] = gacc[i][j];
        }
    }
    __syncthreads();

    // (row, channel) outputs: thread (ty, tx) holds rows ty + 16 i (of
    // sub-chunk i) and channels tx + 16 jj
    float dv[kParts][ND], drn[kParts][ND], dkn[kParts][ND], kx[kParts][ND];
#pragma unroll
    for (int i = 0; i < kParts; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j) dv[i][j] = drn[i][j] = dkn[i][j] = 0.f;
    // dv = M^T dO + kd dS^T
    for (int s = 0; s < kRows; ++s) {
      float pm[kParts], dov[ND];
#pragma unroll
      for (int i = 0; i < kParts; ++i) pm[i] = PM[s * LP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < ND; ++j) dov[j] = DO[s * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kParts; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) dv[i][j] = fmaf(pm[i], dov[j], dv[i][j]);
    }
    for (int d = 0; d < D; ++d) {
      float kd[kParts], ds[ND];
#pragma unroll
      for (int i = 0; i < kParts; ++i)
        kd[i] = KT[(ty + 16 * i) * LD + d] * EL[i * D + d];
#pragma unroll
      for (int j = 0; j < ND; ++j) ds[j] = DS[d * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kParts; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) dv[i][j] = fmaf(kd[i], ds[j], dv[i][j]);
    }
    // state parts: Y = dO S^T into drn, X = V dS^T into dkn
    for (int e = 0; e < D; ++e) {
      float dov[kParts], vv[kParts], sv[ND], dsv[ND];
#pragma unroll
      for (int i = 0; i < kParts; ++i) {
        dov[i] = DO[(ty + 16 * i) * LD + e];
        vv[i] = V[(ty + 16 * i) * LD + e];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        sv[j] = S[(tx + 16 * j) * LD + e];
        dsv[j] = DS[(tx + 16 * j) * LD + e];
      }
#pragma unroll
      for (int i = 0; i < kParts; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          drn[i][j] = fmaf(dov[i], sv[j], drn[i][j]);
          dkn[i][j] = fmaf(vv[i], dsv[j], dkn[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kParts; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int t = ty + 16 * i, d = tx + 16 * j;
        const float la = LA[t * LD + d];
        drn[i][j] *= __expf((t ? LA[(t - 1) * LD + d] : 0.f));
        dkn[i][j] *= __expf(lam[d] - la);
        kx[i][j] = K[t * LD + d] * dkn[i][j];
      }
    // the intra-chunk parts through the plane's blocks: below the diagonal
    // by the factored decays, on it one exp per (t, j < t, d)
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = tx + 16 * j;
        const float lp = t ? LA[(t - 1) * LD + d] : 0.f;
        const float lt = LA[t * LD + d];
        // dr: rows of sub-chunk i against the columns of sub-chunks q < i
        float acc = 0.f;
        for (int q = 0; q < i; ++q) {
          float part = 0.f;
          for (int jr = kPart * q; jr < kPart * q + kPart; ++jr)
            part = fmaf(PDM[t * LP + jr], KT[jr * LD + d], part);
          acc = fmaf(G[(i * kParts + q) * D + d], part, acc);
        }
        if (i) acc *= __expf(lp - LA[(kPart * i - 1) * LD + d]);
        for (int jr = kPart * i; jr < t; ++jr)
          acc = fmaf(PDM[t * LP + jr] * K[jr * LD + d],
                     __expf(lp - LA[jr * LD + d]), acc);
        drn[i][j] += acc;
        // dk: column t (as j) of sub-chunk i against the rows of q > i
        acc = 0.f;
        for (int q = i + 1; q < kParts; ++q) {
          float part = 0.f;
          for (int tr = kPart * q; tr < kPart * q + kPart; ++tr)
            part = fmaf(PDM[tr * LP + t], RT[tr * LD + d], part);
          acc = fmaf(G[(q * kParts + i) * D + d], part, acc);
        }
        acc *= __expf(LA[(kPart * i + kPart - 1) * LD + d] - lt);
        for (int tr = t + 1; tr < kPart * i + kPart; ++tr)
          acc = fmaf(PDM[tr * LP + t] * R[tr * LD + d],
                     __expf(LA[(tr - 1) * LD + d] - lt), acc);
        dkn[i][j] += acc;
      }
    }
    // the outputs of the chunk's rows, with the bonus terms
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      const int t = ty + 16 * i;
      const int64_t pos = c * C + t;
      const bool out = t < C && pos < p.t;
      const int64_t at = g0 + pos * p.g_st;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = tx + 16 * j;
        const float rv = R[t * LD + d], kv = K[t * LD + d];
        const float bon = DRD[t] * ug[d];
        if (out) {
          store(static_cast<T*>(p.dr) + at + d, fmaf(bon, kv, drn[i][j]));
          store(static_cast<T*>(p.dk) + at + d, fmaf(bon, rv, dkn[i][j]));
          store(static_cast<T*>(p.dv) + at + d,
                fmaf(RD[t], DO[t * LD + d], dv[i][j]));
        }
      }
    }
    // dS_in = e^lam dS + (r e^lp)^T dO, r e^lp = r~ e^E_{I-1} (after the
    // stores, so that dv's registers are free)
    float dsn[ND][ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const float dl = __expf(lam[ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        dsn[i][j] = dl * DS[(ty + 16 * i) * LD + tx + 16 * j];
    }
    for (int t = 0; t < kRows; ++t) {
      float rq[ND], dov[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = ty + 16 * i;
        rq[i] = RT[t * LD + d] * EE[(t / kPart) * D + d];
        dov[i] = DO[t * LD + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) dsn[i][j] = fmaf(rq[i], dov[j], dsn[i][j]);
    }
    // du and d lam's first term, channel tid
    float dlam = 0.f;
    if (tid < D) {
      const int d = tid;
      for (int t = 0; t < kRows; ++t)
        du_acc = fmaf(DRD[t] * R[t * LD + d], K[t * LD + d], du_acc);
      for (int e = 0; e < D; ++e)
        dlam = fmaf(S[d * LD + e], DS[d * LD + e], dlam);
      dlam *= __expf(lam[d]);
    }
    __syncthreads();  // every read of the tiles, the planes and dS is done
    float* Q = RT;   // d la
    float* P = KT;   // d lp
    float* KX = PM;  // k * (dk's state part), pitch LD
#pragma unroll
    for (int i = 0; i < kParts; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int at = (ty + 16 * i) * LD + tx + 16 * j;
        P[at] = R[at] * drn[i][j];
        Q[at] = -K[at] * dkn[i][j];
        KX[at] = kx[i][j];
      }
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j)
        DS[(ty + 16 * i) * LD + tx + 16 * j] = dsn[i][j];
    __syncthreads();
    // d log w by a reverse cumsum down channel tid, then dw
    if (tid < D) {
      const int d = tid;
      for (int t = 0; t < kRows; ++t) dlam += KX[t * LD + d];
      float aq = 0.f, ap = 0.f;
      for (int t = kRows - 1; t >= 0; --t) {
        aq += Q[t * LD + d];
        const float g = dlam + aq + ap;
        ap += P[t * LD + d];
        const int64_t pos = c * C + t;
        if (t < C && pos < p.t) {
          const float wv = wg[pos * p.w_st + d];
          p.dw[g0 + pos * p.g_st + d] =
              wv > kWFloor ? g / wv : (wv == kWFloor ? 0.5f * g / wv : 0.f);
        }
      }
    }
  }
  __syncthreads();
  if (tid < D) p.du[bh * D + tid] = du_acc;
  for (int i = tid; i < D * D; i += kThreads)
    p.ds0[bh * D * D + i] = DS[(i / D) * LD + i % D];
}

template <typename T, int D>
int launch_bwd(const BwdParams& p, int64_t bh, cudaStream_t stream) {
  constexpr size_t smem = BwdLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<T, D><<<static_cast<unsigned>(bh), kThreads, smem,
                          stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const BwdParams& p, int64_t bh, int64_t d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_bwd<T, 16>(p, bh, s);
    case 32: return launch_bwd<T, 32>(p, bh, s);
    case 64: return launch_bwd<T, 64>(p, bh, s);
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
// d, d) float32 contiguous; states a float32 scratch of b * h *
// ceil(t / chunk) * d * d.  d in {16, 32, 64}, 1 <= chunk <= 64.
int wkv6_backward(const void* r, const void* k, const void* v,
                  const float* w, const float* u, const float* s0,
                  const float* dout, const float* ds_final, void* dr,
                  void* dk, void* dv, float* dw, float* du_part, float* ds0,
                  float* states, int64_t b, int64_t h, int64_t t, int64_t d,
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
                    du_part, ds0, states, h, t,
                    r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                    w_sb, w_sh, w_st, o_sb, o_sh, o_st, g_sb, g_sh, g_st,
                    static_cast<int>(chunk)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bwd<__nv_bfloat16>(p, b * h, d, st)
                 : dispatch_bwd<float>(p, b * h, d, st);
}

}  // extern "C"
