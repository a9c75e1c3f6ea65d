// Matmul against packed LightPE (sum-of-powers-of-two) weights for Hopper
// (sm_90a), plain C interface.
//
// K4 p2mm_forward replaces the Pallas TPU kernel
// repro/kernels/pow2_matmul/kernel.py::pow2_matmul_pallas
// (_pow2_matmul_kernel): x (M, K) float32 or bf16 times the weights that
// uint8 codes decode to, (K, N), summed in float32, then times the
// per-column scale once the K sum is done.  The TPU walks K on a
// sequential grid axis, accumulating into its output block, and needs M, N,
// K padded to 128; here one block owns a 64 x 64 tile of outputs and loops
// over K itself with the sums in registers, and masks the ragged edges of
// M, N and K in the kernel, so nothing is padded (M = 1 runs as it is).
//
//  * Codes are decoded to exact floats in the kernel, never to device
//    memory: k=1 is a 4-bit code [s m m m] = +/- 2^-m, two to a byte,
//    column 2j in the low nibble of byte j and column 2j+1 in the high one;
//    k=2 is a byte [. s m1 m1 m1 m2 m2 m2] = +/- (2^-m1 + 2^-m2).  2^-m is
//    built from its bits ((127 - m) << 23), so every value is exact (at
//    most 8 significant bits: exact in bf16 too).
//  * A K step stages 16 rows of K: x's tile transposed to Xs[k][row]
//    (converted to float32 as it lands) and the decoded weights as
//    Ws[k][column].  Each thread owns 4 rows x 4 columns and reads both
//    with 16-byte loads: 2 shared loads per 16 FMAs.
//  * Epilogue: one __fmul_rn by scale[column] per output.  The plain
//    version folds the scale into the weights first, so the two differ
//    by float32 rounding only.
//
// Bound on this card: at qwen3-0.6b's ffn/wi shape (K = 1024, N = 3072)
// and M = 512 the work is 3.2 GFLOP (3.3 us at the tensor cores' bf16
// 989 TFLOP/s, where the decoded weights are exact) against 1.0 MB of
// bf16 x, 3.15 MB of k=2 codes (1.57 MB for k=1) and 6.29 MB of f32 out
// (3.1 us at 3.35 TB/s).  At M = 1 the codes alone bound it (0.94 us for
// k=2, 0.47 us for k=1).  This kernel runs float32 FMAs on the CUDA cores
// (67 TFLOP/s), and a decode-sized M fills N / 64 blocks; decoding into
// bf16 tiles for wgmma and a split over K are later work.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;         // rows of x per block
constexpr int kBN = 64;         // columns per block
constexpr int kBK = 16;         // rows of K per step
constexpr int kThreads = 256;   // 16 x 16; each thread 4 rows x 4 columns

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

// acc[j] += a * b[j] for the four columns of b
__device__ __forceinline__ void fma_row(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

template <int kTerms, typename XT>
__global__ void __launch_bounds__(kThreads)
p2mm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
            const float* __restrict__ scale, float* __restrict__ out,
            int64_t M, int64_t K, int64_t N) {
  __shared__ __align__(16) float Xs[kBK][kBM + 4];   // [k][row]
  __shared__ __align__(16) float Ws[kBK][kBN];       // [k][column]

  const int tid = threadIdx.x;
  const int tx = tid % 16;        // columns 4 tx .. 4 tx + 3
  const int ty = tid / 16;        // rows 4 ty .. 4 ty + 3
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
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

  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
    {
      const int64_t gm = m0 + lx_row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t gk = k0 + lx_k + c;
        Xs[lx_k + c][lx_row] =
            gm < M && gk < K ? to_f32(x[gm * K + gk]) : 0.f;
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
    for (int kk = 0; kk < kBK; ++kk) {
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

template <int kTerms>
void launch(const void* x, const uint8_t* codes, const float* scale,
            float* out, int64_t M, int64_t K, int64_t N, int x_bf16,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  if (x_bf16) {
    p2mm_kernel<kTerms, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), codes, scale, out, M, K, N);
  } else {
    p2mm_kernel<kTerms, float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), codes, scale, out, M, K, N);
  }
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
  if (k_terms == 1) {
    launch<1>(x, c, s, o, M, K, N, x_bf16, st);
  } else {
    launch<2>(x, c, s, o, M, K, N, x_bf16, st);
  }
  return static_cast<int>(cudaGetLastError());
}
