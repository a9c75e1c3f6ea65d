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
// log w, and
//
//   o_t   = (r_t exp(la_prev_t)) S                                  [state]
//         + sum_{j<t} (sum_d r_td k_jd exp(la_prev_td - la_jd)) v_j [intra]
//         + (r_t . (u k_t)) v_t                                     [bonus]
//   S_out = exp(la_last) S (rows) + (k exp(la_last - la))^T V
//
// What it computes is the TPU kernel's; the schedule is not carried over.
// The TPU carries S across a sequential grid axis in VMEM scratch.  Blocks
// on the card run in no order, so one CUDA block owns one (batch, head) and
// loops over the chunks itself, with S (D x D f32, 16 KB at D = 64) in
// shared memory for the whole sequence and each chunk's r, k, v, log w and
// la tiles staged there in f32 (117 KB at D = 64 and a chunk of 64: the
// block opts in to more than the 48 KB default).
//
//  * la is a per-channel prefix sum, one thread per channel.
//  * The intra-chunk scores are computed only for j < t: the (t, j) plane is
//    cut into 4 x 4 tiles and only the tiles on or below the diagonal are
//    handed out, one per thread (136 of 256 threads at a chunk of 64), so
//    the masked half costs no exp.  Inside a diagonal tile the exponent is
//    clamped at 0 and the masked scores are then set to 0 by a select, so no
//    exp is ever of a positive number (exp of the masked half can overflow
//    to inf, and inf x 0 is NaN).  Threads without a tile compute the bonus.
//  * The output (t, e) and the state update (d, e) are 4 x D/16 register
//    tiles a thread, f32 FMAs on the CUDA cores from shared memory.
//  * Layout: r/k/v/w are (B, H, T, D) views read through their batch, head
//    and time strides (the last dim contiguous), so the model's (B, T, H, D)
//    projections need no transpose copy; the output is written through its
//    own strides.  r/k/v are float32 or bf16 (a template on the element
//    type), w, u, s0 and both outputs float32.  s0 may be null (zeros).
//  * The ragged end is masked here: rows t >= T load as w = 1, r = k = v = 0
//    (the reference wrapper's padding tokens, which leave S untouched) and
//    are not written.
//
// Bound on an H100 SXM (data-sheet rates): at the serving shape (B = 1,
// H = 32, T = 512, D = 64, chunk 64; bf16 r/k/v, f32 w) the kernel must
// move 15.2 MB (4.5 us at 3.35 TB/s), and the recurrence needs 0.34 GFLOP
// (per head and token 2 D^2 for r S and 3 D^2 for w * S + k^T v: 5.0 us at
// the 67 TFLOP/s f32 rate), so it is bound by its operations.  The chunked
// form does about 0.51 GFLOP: the pairwise decays and their exps are its
// own extra work.  This first version is far from the bound: its 32
// blocks (one per head) use 32 of 132 SMs with 8 warps each, every chunk
// passes six barrier-separated phases, and the intra-chunk term costs about
// 37 M exps.  Tensor cores for the three (C, D) x (D, D)
// products and splitting a head's columns or chunks over more SMs are later
// work.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxChunk = 64;

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

template <int D>
constexpr size_t smem_bytes(int c) {
  // S (D x D); r, k, v, la_prev, la (c x (D + 1)); A (c x (c + 1));
  // the bonus (c); exp(la_last) (D)
  return sizeof(float) * (static_cast<size_t>(D) * D + 5 * c * (D + 1) +
                          c * (c + 1) + c + D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) wkv6_kernel(Params p) {
  constexpr int LD = D + 1;  // padded row of a (c x D) tile
  constexpr int R = D / 16;  // state rows and output columns of a thread
  const int C = p.chunk;
  extern __shared__ float smem[];
  float* S = smem;               // D x D
  float* rs = S + D * D;         // r, then r * exp(la_prev)
  float* ks = rs + C * LD;       // k, then k * exp(la_last - la)
  float* vs = ks + C * LD;       // v
  float* lp = vs + C * LD;       // log w, then la_prev = la - log w
  float* la = lp + C * LD;       // inclusive cumsum of log w
  float* A = la + C * LD;        // C x (C + 1) intra-chunk scores
  float* rd = A + C * (C + 1);   // C: r . (u * k)
  float* dl = rd + C;            // D: exp(la_last)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.h;
  const int64_t head = bh % p.h;

  const T* rg = static_cast<const T*>(p.r) + b * p.r_sb + head * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + head * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + head * p.v_sh;
  const float* wg = p.w + b * p.w_sb + head * p.w_sh;
  const float* ug = p.u + head * D;
  float* og = p.out + b * p.o_sb + head * p.o_sh;

  for (int i = tid; i < D * D; i += kThreads)
    S[i] = p.s0 ? p.s0[bh * D * D + i] : 0.f;
  for (int i = tid; i < C * (C + 1); i += kThreads) A[i] = 0.f;

  // this thread's tile (ta, tb), tb <= ta, of the lower-triangular (t, j)
  // plane of 4 x 4 tiles; threads past n_live have none
  const int n_tiles = (C + 3) / 4;
  const int n_live = n_tiles * (n_tiles + 1) / 2;
  int ta = 0;
  while ((ta + 1) * (ta + 2) / 2 <= tid) ++ta;
  const int tb = tid - ta * (ta + 1) / 2;

  const int64_t n_chunks = (p.t + C - 1) / C;
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t t0 = c * C;
    __syncthreads();  // S is in place; the previous chunk's tiles are consumed
    for (int i = tid; i < C * D; i += kThreads) {
      const int tt = i / D, d = i % D;
      const int64_t pos = t0 + tt;
      const bool in = pos < p.t;
      rs[tt * LD + d] = in ? to_f32(rg[pos * p.r_st + d]) : 0.f;
      ks[tt * LD + d] = in ? to_f32(kg[pos * p.k_st + d]) : 0.f;
      vs[tt * LD + d] = in ? to_f32(vg[pos * p.v_st + d]) : 0.f;
      lp[tt * LD + d] = in ? logf(fmaxf(wg[pos * p.w_st + d], 1e-30f)) : 0.f;
    }
    __syncthreads();

    if (tid < D) {  // la = cumsum(log w); la_prev = la - log w
      float run = 0.f;
      for (int tt = 0; tt < C; ++tt) {
        const float lw = lp[tt * LD + tid];
        run += lw;
        la[tt * LD + tid] = run;
        lp[tt * LD + tid] = run - lw;
      }
    }
    __syncthreads();

    if (tid < n_live) {  // intra-chunk scores of one tile, j < t only
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float rv[4], pv[4], kv[4], lv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = min(4 * ta + i, C - 1);
          rv[i] = rs[row * LD + d];
          pv[i] = lp[row * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = min(4 * tb + j, C - 1);
          kv[j] = ks[col * LD + d];
          lv[j] = la[col * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(rv[i] * kv[j], expf(fminf(pv[i] - lv[j], 0.f)),
                             acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = 4 * ta + i, col = 4 * tb + j;
          if (row < C && col < C) A[row * (C + 1) + col] = col < row ? acc[i][j]
                                                                     : 0.f;
        }
    } else if (tid >= kThreads - C) {  // the current-token bonus
      const int tt = tid - (kThreads - C);
      float s = 0.f;
      for (int d = 0; d < D; ++d)
        s = fmaf(rs[tt * LD + d] * ug[d], ks[tt * LD + d], s);
      rd[tt] = s;
    }
    __syncthreads();

    for (int i = tid; i < C * D; i += kThreads) {
      const int tt = i / D, d = i % D;
      rs[tt * LD + d] *= expf(lp[tt * LD + d]);
      ks[tt * LD + d] *= expf(la[(C - 1) * LD + d] - la[tt * LD + d]);
    }
    if (tid < D) dl[tid] = expf(la[(C - 1) * LD + tid]);
    __syncthreads();

    {  // out rows 4 ty + i, columns tx + 16 jj
      float acc[4][R];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < R; ++jj) acc[i][jj] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], sv[R];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = rs[min(4 * ty + i, C - 1) * LD + d];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) sv[jj] = S[d * D + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < R; ++jj)
            acc[i][jj] = fmaf(qv[i], sv[jj], acc[i][jj]);
      }
      const int j_end = min(4 * ty + 4, C);
      for (int j = 0; j < j_end; ++j) {
        float av[4], vv[R];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = A[min(4 * ty + i, C - 1) * (C + 1) + j];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) vv[jj] = vs[j * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < R; ++jj)
            acc[i][jj] = fmaf(av[i], vv[jj], acc[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tt = 4 * ty + i;
        if (tt >= C || t0 + tt >= p.t) continue;
        float* row = og + (t0 + tt) * p.o_st;
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const int e = tx + 16 * jj;
          row[e] = fmaf(rd[tt], vs[tt * LD + e], acc[i][jj]);
        }
      }
    }
    __syncthreads();  // every thread has read S

    {  // S rows R ty + ii, columns tx + 16 jj
      float sacc[R][R];
#pragma unroll
      for (int ii = 0; ii < R; ++ii)
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const int d = R * ty + ii;
          sacc[ii][jj] = dl[d] * S[d * D + tx + 16 * jj];
        }
      for (int tt = 0; tt < C; ++tt) {
        float kv[R], vv[R];
#pragma unroll
        for (int ii = 0; ii < R; ++ii) kv[ii] = ks[tt * LD + R * ty + ii];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) vv[jj] = vs[tt * LD + tx + 16 * jj];
#pragma unroll
        for (int ii = 0; ii < R; ++ii)
#pragma unroll
          for (int jj = 0; jj < R; ++jj)
            sacc[ii][jj] = fmaf(kv[ii], vv[jj], sacc[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < R; ++ii)
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
          S[(R * ty + ii) * D + tx + 16 * jj] = sacc[ii][jj];
    }
  }
  __syncthreads();
  for (int i = tid; i < D * D; i += kThreads) p.s_out[bh * D * D + i] = S[i];
}

template <typename T, int D>
int launch(const Params& p, int64_t bh, cudaStream_t stream) {
  // The attribute belongs to the current device, so it is set on every
  // launch (a cheap call) rather than once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D>(kMaxChunk)));
  if (err != cudaSuccess) return err;
  wkv6_kernel<T, D><<<static_cast<unsigned>(bh), kThreads,
                      smem_bytes<D>(p.chunk), stream>>>(p);
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

}  // extern "C"
