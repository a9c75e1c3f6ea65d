// Single-token decode attention over an int8 KV cache for Hopper (sm_90a),
// plain C interface.
//
// K5 qda_forward replaces the Pallas TPU kernel
// repro/kernels/quant_decode_attn/kernel.py::quant_decode_attn_pallas
// (_decode_attn_kernel): the G = H / Hkv query heads of one kv head attend
// over int8 K/V codes with one f32 scale per (position, kv head), masked
// at or past the cache's fill `length`, with an online softmax over
// blocks of positions; f32 out.  The TPU walks the sequence blocks on a
// sequential grid axis with (m, l, acc) in VMEM scratch.  Here the
// sequence is split over the blocks of a thread-block cluster (flash
// decoding), in one launch, grid (B * Hkv, n_splits, G / Gs):
//
//  * A block takes Gs query heads of its kv head: all G of them for G in
//    {1, 2, 3, 4, 6, 8} (one template instance each), sub-groups of
//    Gs = 8 for a G that is a multiple of 8 (16, or granite's 48 heads on
//    one kv head), one sub-group a grid row z.  The sub-groups of a kv
//    head read the same codes: a query head's registers (acc[Gs][8]) and
//    shared memory (partials of Gs x D) stay those of G = 8, and the
//    re-reads go to the cache a single kv head keeps small.
//
//  * n_splits = min(8, ceil(S / 128)) comes from the cache's capacity S,
//    which the host knows, never from `length`, which stays on the
//    device: a decode step needs no host sync and captures as one CUDA
//    graph whose replays follow `length`.
//  * The cache is cut into 128-position chunks; block r of a (batch, kv
//    head) takes chunks r, r + n_splits, ... below min(length, S), all G
//    query heads together, with its own online softmax (m, l, acc).  A
//    block with no chunk below the fill holds the empty partial
//    (-inf, 0, 0).
//  * The n_splits blocks of a (batch, kv head) form one cluster.  Each
//    leaves its partial in its own shared memory; after a cluster barrier
//    block 0 reads them all through distributed shared memory, merges
//    them with the online softmax's own rescaling and writes
//    acc / max(l, 1e-30).  No partial goes through device memory, and
//    there is no second launch: on the card both a second merge kernel
//    and a merge by the last block to arrive (on a device counter) were
//    slower at the serving lengths, where a launch and a round trip
//    through device memory cost more than the work.
//  * Codes arrive in 16-byte cp.async copies into shared rows padded by
//    16 bytes, in a ring of two chunks (the next chunk's copy overlaps this
//    one's math; V's copy overlaps the scores), and are dequantized
//    (code * scale) in registers: no dequantized cache is ever written.
//    Scores: one thread per position; PV: a thread owns 8 columns of a
//    row lane, and the row lanes' sums meet in shared memory.
//  * Guards as in the TPU kernel: the output is acc / max(l, 1e-30) and an
//    empty partial weighs 0 in the merge, so length 0 gives 0, never NaN.
//
// Bound on this card: decode is memory-bound.  At B = 1, Hkv = 8, G = 2,
// D = 128 and a full cache of S = 2048 the kernel must read 4.2 MB of
// codes and 0.13 MB of scales (1.3 us at 3.35 TB/s) for 8.4 MFLOP.  With
// one block per (batch, kv head) a batch-1 step would fill 8 of the 132
// SMs and one SM's load rate would set the time; split, the same step
// runs 64 blocks with two 33 KB chunks each in flight.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kSplit = 128;     // positions of a chunk
constexpr int kMaxSplits = 8;   // blocks (one cluster) per (batch, kv head)
constexpr int kThreads = 128;   // one thread per position for the scores
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

// byte k of w as a signed int8 code, in f32
__device__ __forceinline__ float code(uint32_t w, int k) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * k)) >> 24);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int G, int D>
struct Smem {
  static constexpr int kRow = D + 16;        // bytes of a padded code row
  static constexpr int kLanes = kThreads / (D / 8);  // PV row lanes
  // a stage of the ring: K codes, V codes, K scales, V scales
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + kSplit * kRow;
  static constexpr size_t kKs = kV + kSplit * kRow;
  static constexpr size_t kVs = kKs + kSplit * sizeof(float);
  static constexpr size_t kStage = kVs + kSplit * sizeof(float);
  static constexpr size_t q = 2 * kStage;                      // floats on
  static constexpr size_t p = q + G * D * sizeof(float);        // G x kSplit
  static constexpr size_t red_max = p + G * kSplit * sizeof(float);
  static constexpr size_t red_sum = red_max + kWarps * G * sizeof(float);
  static constexpr size_t part = red_sum + kWarps * G * sizeof(float);
  static constexpr size_t rec = part + kLanes * G * D * sizeof(float);
  static constexpr size_t bytes = rec + G * (D + 2) * sizeof(float);
};

// Grid (B * Hkv, n_splits) in clusters of (1, n_splits): see the note at
// the top.  The block's partial, m[G], l[G], acc[G][D], ends in `rec`.
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads) qda_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_codes,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_codes,
    const float* __restrict__ v_scale, const int32_t* __restrict__ length,
    float* __restrict__ out, int64_t hkv, int64_t g_all, int64_t s,
    float sm_scale) {
  using L = Smem<G, D>;
  constexpr int kChunks = D / 16;      // 16-byte chunks of a code row
  constexpr int kCols = D / 8;         // 8-column slices of a PV row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* ps = reinterpret_cast<float*>(smem + L::p);
  float* red_max = reinterpret_cast<float*>(smem + L::red_max);
  float* red_sum = reinterpret_cast<float*>(smem + L::red_sum);
  float* part = reinterpret_cast<float*>(smem + L::part);
  float* rec = reinterpret_cast<float*>(smem + L::rec);
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int64_t bh = blockIdx.x;
  const int rank = blockIdx.y;          // the block's rank in its cluster
  // the first of this block's G query heads among the kv head's g_all
  const int64_t head0 = bh * g_all + static_cast<int64_t>(blockIdx.z) * G;
  const int blocks = gridDim.y;
  const int64_t fill = length[bh / hkv];
  const int64_t n = fill < 0 ? 0 : (fill < s ? fill : s);
  const int64_t n_chunks = (n + kSplit - 1) / kSplit;
  const int mine = rank < n_chunks
                       ? static_cast<int>((n_chunks - 1 - rank) / blocks) + 1
                       : 0;
  const int8_t* kg = k_codes + bh * s * D;
  const int8_t* vg = v_codes + bh * s * D;
  const float* ksg = k_scale + bh * s;
  const float* vsg = v_scale + bh * s;

  // chunk j of this block into stage j % 2: K and its scales, then V and
  // its scales, as two commit groups
  auto issue = [&](int j) {
    const int64_t lo = (rank + static_cast<int64_t>(j) * blocks) * kSplit;
    const int cnt = static_cast<int>(n - lo < kSplit ? n - lo : kSplit);
    unsigned char* st = smem + (j % 2) * L::kStage;
    for (int i = tid; i < cnt * kChunks; i += kThreads)
      cp_async16(st + L::kK + (i / kChunks) * L::kRow + (i % kChunks) * 16,
                 kg + lo * D + static_cast<int64_t>(i) * 16);
    if (tid < cnt) cp_async4(st + L::kKs + 4 * tid, ksg + lo + tid);
    cp_async_commit();
    for (int i = tid; i < cnt * kChunks; i += kThreads)
      cp_async16(st + L::kV + (i / kChunks) * L::kRow + (i % kChunks) * 16,
                 vg + lo * D + static_cast<int64_t>(i) * 16);
    if (tid < cnt) cp_async4(st + L::kVs + 4 * tid, vsg + lo + tid);
    cp_async_commit();
  };

  if (mine > 0) issue(0);
  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = to_f32(q[head0 * D + i]);

  const int col = (tid % kCols) * 8;
  const int lane_row = tid / kCols;
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int j = 0; j < mine; ++j) {
    const int64_t lo = (rank + static_cast<int64_t>(j) * blocks) * kSplit;
    const int cnt = static_cast<int>(n - lo < kSplit ? n - lo : kSplit);
    const unsigned char* st = smem + (j % 2) * L::kStage;
    const bool more = j + 1 < mine;
    if (more) {
      issue(j + 1);      // into the stage chunk j - 1 left
      cp_async_wait<3>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();     // q and chunk j's K are in place

    float sc[G];
    if (tid < cnt) {
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      const float scale = reinterpret_cast<const float*>(st + L::kKs)[tid];
      const unsigned char* row = st + L::kK + tid * L::kRow;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(row + 16 * c);
        const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const uint32_t w = words[e / 4];
          const float4 k4 = make_float4(code(w, 0) * scale,
                                        code(w, 1) * scale,
                                        code(w, 2) * scale,
                                        code(w, 3) * scale);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 q4 =
                *reinterpret_cast<const float4*>(qs + g * D + 16 * c + e);
            dot[g] = fmaf(q4.x, k4.x, dot[g]);
            dot[g] = fmaf(q4.y, k4.y, dot[g]);
            dot[g] = fmaf(q4.z, k4.z, dot[g]);
            dot[g] = fmaf(q4.w, k4.w, dot[g]);
          }
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
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m[g];
      for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, red_max[w * G + g]);
      // cnt >= 1, so m_new is a finite score
      alpha[g] = m[g] > -INFINITY ? expf(m[g] - m_new) : 0.f;
      m[g] = m_new;
      const float pr = tid < cnt ? expf(sc[g] - m_new) : 0.f;
      ps[g * kSplit + tid] = pr;
      const float ws = warp_sum(pr);
      if (lane == 0) red_sum[warp * G + g] = ws;
    }
    if (more) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();     // chunk j's V, P and the sums are in place

    const float* vsc = reinterpret_cast<const float*>(st + L::kVs);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float bs = 0.f;
      for (int w = 0; w < kWarps; ++w) bs += red_sum[w * G + g];
      l[g] = l[g] * alpha[g] + bs;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha[g];
    }
    for (int r = lane_row; r < cnt; r += L::kLanes) {
      const uint2 w = *reinterpret_cast<const uint2*>(st + L::kV
                                                      + r * L::kRow + col);
      const float scale = vsc[r];
      float pr[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pr[g] = ps[g * kSplit + r];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = code(e < 4 ? w.x : w.y, e % 4) * scale;
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][e] = fmaf(pr[g], v, acc[g][e]);
      }
    }
    __syncthreads();     // the stage, P and the sums are consumed
  }

  // this block's partial into rec
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      part[(lane_row * G + g) * D + col + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < L::kLanes; ++r) sum += part[r * G * D + i];
    rec[2 * G + i] = sum;
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      rec[g] = m[g];
      rec[G + g] = l[g];
    }
  }

  // block 0 merges the cluster's partials from their shared memory; all
  // the remote reads of an output are issued before any is used
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      float m_r[kMaxSplits], l_r[kMaxSplits], a_r[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        m_r[r] = -INFINITY;
        l_r[r] = a_r[r] = 0.f;
        if (r < blocks) {
          const float* other = cluster.map_shared_rank(rec, r);
          m_r[r] = other[g];
          l_r[r] = other[G + g];
          a_r[r] = other[2 * G + i];
        }
      }
      float mm = -INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) mm = fmaxf(mm, m_r[r]);
      const float m_safe = mm > -INFINITY ? mm : 0.f;
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        // an empty partial (-inf, 0, 0) weighs 0
        const float w = m_r[r] > -INFINITY ? expf(m_r[r] - m_safe) : 0.f;
        ll = fmaf(w, l_r[r], ll);
        aa = fmaf(w, a_r[r], aa);
      }
      out[head0 * D + i] = aa / fmaxf(ll, 1e-30f);
    }
  }
  cluster.sync();  // every block's shared memory outlives block 0's reads
}

template <typename T, int G, int D>
int launch(const void* q, const int8_t* kc, const float* ks,
           const int8_t* vc, const float* vs, const int32_t* length,
           float* out, int64_t bh, int64_t hkv, int64_t g_all, int64_t s,
           float sm_scale, cudaStream_t stream) {
  static_assert(kThreads % (D / 8) == 0, "D / 8 must divide the block");
  constexpr size_t smem = Smem<G, D>::bytes;
  // The attribute belongs to the current device, so it is set on every
  // launch (a cheap call) rather than once per process.
  cudaError_t err = cudaFuncSetAttribute(
      qda_kernel<T, G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t chunks = (s + kSplit - 1) / kSplit;
  const unsigned n_splits = static_cast<unsigned>(
      chunks < 1 ? 1 : (chunks < kMaxSplits ? chunks : kMaxSplits));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_splits;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(bh), n_splits,
                     static_cast<unsigned>(g_all / G));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, qda_kernel<T, G, D>,
                           static_cast<const T*>(q), kc, ks, vc, vs, length,
                           out, hkv, g_all, s, sm_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int G>
int dispatch_d(int64_t d, const void* q, const int8_t* kc, const float* ks,
               const int8_t* vc, const float* vs, const int32_t* length,
               float* out, int64_t bh, int64_t hkv, int64_t g_all, int64_t s,
               float sm_scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, G, 16>(q, kc, ks, vc, vs, length, out, bh, hkv, g_all, s, sm_scale, st);
    case 32: return launch<T, G, 32>(q, kc, ks, vc, vs, length, out, bh, hkv, g_all, s, sm_scale, st);
    case 64: return launch<T, G, 64>(q, kc, ks, vc, vs, length, out, bh, hkv, g_all, s, sm_scale, st);
    case 128: return launch<T, G, 128>(q, kc, ks, vc, vs, length, out, bh, hkv, g_all, s, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// G in {1, 2, 3, 4, 6, 8}: one block row of G heads; a multiple of 8
// above 8: G / 8 rows of 8
template <typename T>
int dispatch_g(int64_t g, int64_t d, const void* q, const int8_t* kc,
               const float* ks, const int8_t* vc, const float* vs,
               const int32_t* length, float* out, int64_t bh, int64_t hkv,
               int64_t s, float sm_scale, cudaStream_t st) {
  switch (g) {
    case 1: return dispatch_d<T, 1>(d, q, kc, ks, vc, vs, length, out, bh, hkv, g, s, sm_scale, st);
    case 2: return dispatch_d<T, 2>(d, q, kc, ks, vc, vs, length, out, bh, hkv, g, s, sm_scale, st);
    case 3: return dispatch_d<T, 3>(d, q, kc, ks, vc, vs, length, out, bh, hkv, g, s, sm_scale, st);
    case 4: return dispatch_d<T, 4>(d, q, kc, ks, vc, vs, length, out, bh, hkv, g, s, sm_scale, st);
    case 6: return dispatch_d<T, 6>(d, q, kc, ks, vc, vs, length, out, bh, hkv, g, s, sm_scale, st);
    default:
      if (g < 8 || g % 8 || g / 8 > 65535) return cudaErrorInvalidValue;
      return dispatch_d<T, 8>(d, q, kc, ks, vc, vs, length, out, bh, hkv, g, s, sm_scale, st);
  }
}

}  // namespace

extern "C" {

// q (b * hkv, g, d) float32 (q_is_bf16 = 0) or bf16 (1); k/v codes
// (b * hkv, s, d) int8 and scales (b * hkv, s) f32, all contiguous, the
// codes 16-byte aligned; length (b,) int32 on the device; out
// (b * hkv, g, d) f32.  g in {1, 2, 3, 4, 6} or a multiple of 8, d in
// {16, 32, 64, 128}.
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
