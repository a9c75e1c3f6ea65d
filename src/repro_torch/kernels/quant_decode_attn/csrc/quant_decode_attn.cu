// Single-token decode attention over an int8 KV cache for Hopper (sm_90a),
// plain C interface.
//
// K5 qda_forward replaces the Pallas TPU kernel
// repro/kernels/quant_decode_attn/kernel.py::quant_decode_attn_pallas
// (_decode_attn_kernel): the G = H / Hkv query heads of one kv head attend
// over int8 K/V codes with one f32 scale per (position, kv head), masked
// at or past the cache's fill `length`, with an online softmax over
// blocks of 256 positions; f32 out.  The TPU walks the sequence blocks on
// a sequential grid axis with (m, l, acc) in VMEM scratch; here one CUDA
// block owns one (batch, kv head) and loops over the sequence blocks
// itself, with m and l in registers and acc split over its threads.
//
//  * Codes are dequantized (code * scale) in registers: no dequantized
//    cache is ever written.
//  * `length` is read from a device int32 array (one entry per batch
//    row), so a decode step needs no host sync.  Blocks at or past
//    min(length, S) are never read: they hold only masked positions,
//    which add exactly nothing to m, l and acc in the TPU kernel too.
//  * Each block of 256 positions is staged through shared memory with
//    4-byte loads (neighbouring threads on neighbouring words).  Scores:
//    one thread per position, q broadcast from shared memory, K rows
//    padded by 4 bytes so the 256 threads hit distinct banks.  PV: thread
//    t owns column t % D for positions t / D, t / D + 256 / D, ...; the
//    partial sums meet in shared memory at the end.
//  * Guards as in the TPU kernel: masked scores are -inf, the running max
//    is taken as 0 in the exponent while it is still -inf, and the output
//    is acc / max(l, 1e-30), so length 0 gives 0 and never NaN.
//
// Bound on this card: decode is memory-bound.  At B = 1, Hkv = 8, G = 2,
// D = 128 and a full cache of S = 2048 the kernel must read 4.2 MB of
// codes and 0.13 MB of scales (1.3 us at 3.35 TB/s) for 8.4 MFLOP.  The
// design reads each code once and writes nothing but the (G, D) outputs.
// With one block per (batch, kv head) a batch-1 step fills only Hkv of
// the 132 SMs, so one SM's load rate, not the card's, sets the time;
// splitting the sequence over blocks (flash decoding) is later work.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBS = 256;       // positions of a sequence block
constexpr int kThreads = 256;  // one thread per position for the scores
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int G, int D>
struct Smem {
  static constexpr int kRow = D + 4;  // bytes of a padded K row
  static constexpr size_t k_codes = 0;
  static constexpr size_t v_codes = k_codes + kBS * kRow;
  static constexpr size_t k_scale = v_codes + kBS * D;       // floats from here
  static constexpr size_t v_scale = k_scale + kBS * sizeof(float);
  static constexpr size_t q = v_scale + kBS * sizeof(float);
  static constexpr size_t p = q + G * D * sizeof(float);     // G x kBS
  static constexpr size_t red_max = p + G * kBS * sizeof(float);
  static constexpr size_t red_sum = red_max + kWarps * G * sizeof(float);
  static constexpr size_t denom = red_sum + kWarps * G * sizeof(float);
  static constexpr size_t bytes = denom + G * sizeof(float);
};

template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads) quant_decode_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_codes,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_codes,
    const float* __restrict__ v_scale, const int32_t* __restrict__ length,
    float* __restrict__ out, int64_t hkv, int64_t s, float sm_scale) {
  using L = Smem<G, D>;
  constexpr int R = kThreads / D;  // position lanes of the PV loop
  constexpr int W = D / 4;         // 4-byte words of a code row
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* kc = reinterpret_cast<int8_t*>(smem + L::k_codes);
  int8_t* vc = reinterpret_cast<int8_t*>(smem + L::v_codes);
  float* ksc = reinterpret_cast<float*>(smem + L::k_scale);
  float* vsc = reinterpret_cast<float*>(smem + L::v_scale);
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* ps = reinterpret_cast<float*>(smem + L::p);
  float* red_max = reinterpret_cast<float*>(smem + L::red_max);
  float* red_sum = reinterpret_cast<float*>(smem + L::red_sum);
  float* denom = reinterpret_cast<float*>(smem + L::denom);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int64_t bh = blockIdx.x;
  const int64_t fill = length[bh / hkv];
  const int64_t n = fill < 0 ? 0 : (fill < s ? fill : s);
  const int8_t* kg = k_codes + bh * s * D;
  const int8_t* vg = v_codes + bh * s * D;

  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = to_f32(q[bh * G * D + i]);

  float m[G], l[G], acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  const int col = tid % D;
  const int lane_pos = tid / D;

  for (int64_t base = 0; base < n; base += kBS) {
    const int cnt = static_cast<int>(n - base < kBS ? n - base : kBS);
    __syncthreads();  // q is in place; the previous block is consumed
    for (int i = tid; i < cnt * W; i += kThreads) {
      const int row = i / W, w = i % W;
      const int64_t off = (base + row) * D + 4 * w;
      *reinterpret_cast<int32_t*>(kc + row * L::kRow + 4 * w) =
          *reinterpret_cast<const int32_t*>(kg + off);
      *reinterpret_cast<int32_t*>(vc + row * D + 4 * w) =
          *reinterpret_cast<const int32_t*>(vg + off);
    }
    for (int i = tid; i < cnt; i += kThreads) {
      ksc[i] = k_scale[bh * s + base + i];
      vsc[i] = v_scale[bh * s + base + i];
    }
    __syncthreads();

    float sc[G];
    if (tid < cnt) {
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      const float scale = ksc[tid];
      const int8_t* row = kc + tid * L::kRow;
#pragma unroll 4
      for (int w = 0; w < W; ++w) {
        const char4 c4 = *reinterpret_cast<const char4*>(row + 4 * w);
        const float k0 = static_cast<float>(c4.x) * scale;
        const float k1 = static_cast<float>(c4.y) * scale;
        const float k2 = static_cast<float>(c4.z) * scale;
        const float k3 = static_cast<float>(c4.w) * scale;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float* qg = qs + g * D + 4 * w;
          dot[g] = fmaf(qg[0], k0, dot[g]);
          dot[g] = fmaf(qg[1], k1, dot[g]);
          dot[g] = fmaf(qg[2], k2, dot[g]);
          dot[g] = fmaf(qg[3], k3, dot[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = dot[g] * sm_scale;
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = -INFINITY;
    }

#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float wm = warp_max(sc[g]);
      if (lane == 0) red_max[warp * G + g] = wm;
    }
    __syncthreads();
    float alpha[G], pr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float bm = red_max[g];
      for (int w = 1; w < kWarps; ++w) bm = fmaxf(bm, red_max[w * G + g]);
      const float m_new = fmaxf(m[g], bm);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      pr[g] = tid < cnt ? expf(sc[g] - m_safe) : 0.f;
      ps[g * kBS + tid] = pr[g];
      alpha[g] = isfinite(m[g]) ? expf(m[g] - m_safe) : 0.f;
      m[g] = m_new;
      const float ws = warp_sum(pr[g]);
      if (lane == 0) red_sum[warp * G + g] = ws;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float bs = 0.f;
      for (int w = 0; w < kWarps; ++w) bs += red_sum[w * G + g];
      l[g] = l[g] * alpha[g] + bs;
      acc[g] *= alpha[g];
    }
    for (int j = lane_pos; j < cnt; j += R) {
      const float v = static_cast<float>(vc[j * D + col]) * vsc[j];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(ps[g * kBS + j], v, acc[g]);
    }
  }

  __syncthreads();  // the last block's P is consumed: reuse it for partials
#pragma unroll
  for (int g = 0; g < G; ++g) ps[(lane_pos * G + g) * D + col] = acc[g];
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) denom[g] = fmaxf(l[g], 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < R; ++r) sum += ps[r * G * D + i];
    out[bh * G * D + i] = sum / denom[i / D];
  }
}

template <typename T, int G, int D>
int launch(const void* q, const int8_t* kc, const float* ks,
           const int8_t* vc, const float* vs, const int32_t* length,
           float* out, int64_t bh, int64_t hkv, int64_t s, float sm_scale,
           cudaStream_t stream) {
  static_assert(kThreads % D == 0, "D must divide the block");
  static_assert(kThreads / D * G * D <= G * kBS, "partials must fit in P");
  constexpr size_t smem = Smem<G, D>::bytes;
  // The attribute belongs to the current device, so it is set on every
  // launch (a cheap call) rather than once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      quant_decode_kernel<T, G, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  quant_decode_kernel<T, G, D><<<static_cast<unsigned>(bh), kThreads, smem,
                                 stream>>>(
      static_cast<const T*>(q), kc, ks, vc, vs, length, out, hkv, s,
      sm_scale);
  return cudaGetLastError();
}

template <typename T, int G>
int dispatch_d(int64_t d, const void* q, const int8_t* kc, const float* ks,
               const int8_t* vc, const float* vs, const int32_t* length,
               float* out, int64_t bh, int64_t hkv, int64_t s,
               float sm_scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, G, 16>(q, kc, ks, vc, vs, length, out, bh, hkv, s, sm_scale, st);
    case 32: return launch<T, G, 32>(q, kc, ks, vc, vs, length, out, bh, hkv, s, sm_scale, st);
    case 64: return launch<T, G, 64>(q, kc, ks, vc, vs, length, out, bh, hkv, s, sm_scale, st);
    case 128: return launch<T, G, 128>(q, kc, ks, vc, vs, length, out, bh, hkv, s, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_g(int64_t g, int64_t d, const void* q, const int8_t* kc,
               const float* ks, const int8_t* vc, const float* vs,
               const int32_t* length, float* out, int64_t bh, int64_t hkv,
               int64_t s, float sm_scale, cudaStream_t st) {
  switch (g) {
    case 1: return dispatch_d<T, 1>(d, q, kc, ks, vc, vs, length, out, bh, hkv, s, sm_scale, st);
    case 2: return dispatch_d<T, 2>(d, q, kc, ks, vc, vs, length, out, bh, hkv, s, sm_scale, st);
    case 4: return dispatch_d<T, 4>(d, q, kc, ks, vc, vs, length, out, bh, hkv, s, sm_scale, st);
    case 8: return dispatch_d<T, 8>(d, q, kc, ks, vc, vs, length, out, bh, hkv, s, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (b * hkv, g, d) float32 (q_is_bf16 = 0) or bf16 (1); k/v codes
// (b * hkv, s, d) int8 and scales (b * hkv, s) f32, all contiguous;
// length (b,) int32 on the device; out (b * hkv, g, d) f32.
// g in {1, 2, 4, 8}, d in {16, 32, 64, 128}.
int qda_forward(const void* q, const int8_t* k_codes, const float* k_scale,
                const int8_t* v_codes, const float* v_scale,
                const int32_t* length, float* out, int64_t b, int64_t hkv,
                int64_t g, int64_t s, int64_t d, float sm_scale,
                int q_is_bf16, void* stream) {
  if (b == 0 || hkv == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t bh = b * hkv;
  return q_is_bf16
             ? dispatch_g<__nv_bfloat16>(g, d, q, k_codes, k_scale, v_codes,
                                         v_scale, length, out, bh, hkv, s,
                                         sm_scale, st)
             : dispatch_g<float>(g, d, q, k_codes, k_scale, v_codes, v_scale,
                                 length, out, bh, hkv, s, sm_scale, st);
}

}  // extern "C"
