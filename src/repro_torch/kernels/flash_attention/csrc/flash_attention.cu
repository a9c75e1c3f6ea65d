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
//  * Key tiles wholly outside the causal / window band are skipped (the
//    TPU kernel's `live` test), so causal attention does about half the
//    work and a window only its diagonal band.
//  * GQA: the block reads kv head h / G directly instead of a repeated
//    copy of K and V (the reference's ops.py materialises jnp.repeat).
//  * Layout: q (B, S, H, D) and k/v (B, S, Hkv, D) are read through their
//    batch, sequence and head strides (the last dim contiguous), so no
//    transpose copy is made.  The ragged end of the sequence is masked
//    here, with no padding to a tile multiple.
//  * Inputs are float32 or bf16 (a template on the element type); q is
//    scaled by sm_scale in f32, scores, softmax and PV run in f32, the
//    output is f32 (B, S, H, D).  The caller casts back to its dtype.
//  * Guards as in the TPU kernel: masked scores are -1e30, a running max
//    that is still -1e30 is treated as 0 in the exponent and masked
//    probabilities are exactly 0, so an all-masked row gives acc = l = 0,
//    and the output is acc / max(l, 1e-30): no NaN.
//
// Bound on this card: at the serving shape (B = 1, S = 512, H = 16,
// Hkv = 8, D = 128, bf16, causal) the kernel must move q, k, v and the f32
// output, 8.4 MB (2.5 us at 3.35 TB/s), and do 1.07 GFLOP of QK^T and PV
// (1.1 us at the bf16 tensor-core rate, 16 us at the 67 TFLOP/s f32
// rate this kernel computes at).  It is bound by its arithmetic: this
// first version runs it as f32 FMAs on the CUDA cores from shared memory
// (a 64x64 score tile is 16 scores a thread, a 64xD output tile 4 x D/16
// accumulators a thread), which keeps f32 inputs exact; wgmma and TMA for
// bf16 are later work.  Device memory is read once per key tile per
// query tile; each tile is staged through shared memory as f32.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // keys of a tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 1/16 of cols
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* out;
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
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int C = D / 16;  // output columns of a thread
  extern __shared__ float smem[];
  float* qs = smem;                    // kBQ x (D + 1), pre-scaled
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

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + head * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kv_head * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kv_head * p.v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int64_t pos = q_lo + r;
    qs[r * (D + 1) + c] =
        pos < p.s ? to_f32(qg[pos * p.q_ss + c]) * p.sm_scale : 0.f;
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
    bool live = true;
    if (p.causal) live = k_lo <= q_lo + kBQ - 1;
    if (p.window) live = live && (k_lo + kBK - 1 > q_lo - p.window);
    if (!live) continue;  // uniform across the block

    __syncthreads();  // Q is in place; the previous K, V, P are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int64_t pos = k_lo + r;
      const bool in = pos < p.s;
      ks[r * (D + 1) + c] = in ? to_f32(kg[pos * p.k_ss + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vg[pos * p.v_ss + c]) : 0.f;
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
  }
}

template <typename T, int D>
int launch(const Params& p, int64_t bh, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  // The attribute belongs to the current device, so it is set on every
  // launch (a cheap call) rather than once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.s + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bh));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(const Params& p, int64_t bh, int64_t d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(p, bh, s);
    case 32: return launch<T, 32>(p, bh, s);
    case 64: return launch<T, 64>(p, bh, s);
    case 128: return launch<T, 128>(p, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (b, s, h, d), k/v (b, s, hkv, d) of float32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), each with the given batch/sequence/head strides in
// elements and a contiguous last dim; out (b, s, h, d) contiguous f32.
// d in {16, 32, 64, 128}, h % hkv == 0.  window 0 means full attention.
int fa_forward(const void* q, const void* k, const void* v, float* out,
               int64_t b, int64_t s, int64_t h, int64_t hkv, int64_t d,
               int64_t q_sb, int64_t q_ss, int64_t q_sh,
               int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh,
               float sm_scale, int causal, int64_t window, int is_bf16,
               void* stream) {
  if (hkv <= 0 || h % hkv != 0 || window < 0) return cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return cudaSuccess;
  const Params p{q, k, v, out, s, h, hkv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 sm_scale, causal, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(p, b * h, d, st)
                 : dispatch_d<float>(p, b * h, d, st);
}

}  // extern "C"
