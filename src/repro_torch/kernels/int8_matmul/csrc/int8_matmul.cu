// W8A8 int8 matmul for Hopper (sm_90a), plain C interface.
//
// K3 i8mm_forward replaces the Pallas TPU kernel
// repro/kernels/int8_matmul/kernel.py::int8_matmul_pallas
// (_int8_matmul_kernel): int8 x (M, K) times int8 w (K, N) into an int32
// accumulator, then out[m][n] = ((float)acc * x_scale[m]) * w_scale[n] in
// float32.  The TPU walks K on a sequential grid axis with the int32 sum
// in VMEM scratch and needs M, N, K padded to 128; here one block owns a
// 64 x 64 tile of outputs and loops over K itself, with the sums in
// registers, and masks the ragged edges of M, N and K in the kernel, so
// nothing is padded (M = 1, a decode token, runs as it is).
//
//  * The int32 dot is __dp4a: four int8 products summed into an int32 per
//    instruction.  Exact, as on the TPU's MXU: |acc| <= 128^2 K.
//  * A K step stages 64 bytes of K: the x tile as As[row][k-word] (the
//    words x's rows already hold) and the w tile as Bs[k-word][col], one
//    32-bit word per column holding four consecutive k.  w is row-major
//    (k, n), so each thread loads four rows' words of four columns and
//    transposes the 4 x 4 bytes in registers with __byte_perm before one
//    16-byte store; both tiles are read back with 16-byte loads (four
//    k-words of a row of x; four columns of a k-word of w), so a thread's
//    4 x 4 outputs take 8 shared loads per 64 dp4a.
//  * Epilogue: __fmul_rn twice, in the reference's order, so nothing is
//    contracted or reordered and the result is bit-identical to the plain
//    version (ref.py) on any input.
//  * x_scale may be float32 or bf16 (the reference keeps a bf16 x's scales
//    in bf16 and casts them to float32 in the epilogue); w_scale is f32.
//  * When K and N are multiples of 4 and the codes are 4-byte aligned,
//    tiles are loaded a 32-bit word at a time; otherwise byte by byte.
//
// Bound on this card: at qwen3-0.6b's ffn/wi shape (K = 1024, N = 3072),
// M = 512 moves 0.52 MB of x codes, 3.15 MB of w codes and writes 6.29 MB
// of f32 out (3.0 us at 3.35 TB/s) for 3.2 GOP (1.6 us at the tensor
// cores' 1,979 int8 TOP/s): bytes bound it.  M = 1 is the 3.15 MB of w
// codes alone (0.94 us).  dp4a runs on the CUDA cores, not the tensor
// cores, and a decode-sized M fills few of the 132 SMs (N / 64 blocks):
// the s8 wgmma path and a split over K are later work.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;           // rows of x per block
constexpr int kBN = 64;           // columns of w per block
constexpr int kBK = 64;           // bytes of K per step
constexpr int kKW = kBK / 4;      // 32-bit k-words per step
constexpr int kThreads = 256;     // 16 x 16; each thread 4 rows x 4 columns

__device__ __forceinline__ float scale_f32(const float* s, int64_t i) {
  return s[i];
}
__device__ __forceinline__ float scale_f32(const __nv_bfloat16* s,
                                           int64_t i) {
  return __bfloat162float(s[i]);
}

// Four bytes of one row of a row-major int8 matrix starting at column c,
// zero past `cols` (or past the matrix's last row: `valid` false).
template <bool kVec>
__device__ __forceinline__ int load_word(const int8_t* row, int64_t c,
                                         int64_t cols, bool valid) {
  if (!valid) return 0;
  if (kVec) {
    return c < cols ? *reinterpret_cast<const int*>(row + c) : 0;
  }
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (c + b < cols) {
      word |= static_cast<uint32_t>(static_cast<uint8_t>(row[c + b]))
              << (8 * b);
    }
  }
  return static_cast<int>(word);
}

template <bool kVec, typename XS>
__global__ void __launch_bounds__(kThreads)
i8mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const XS* __restrict__ x_scale,
            const float* __restrict__ w_scale, float* __restrict__ out,
            int64_t M, int64_t K, int64_t N) {
  __shared__ __align__(16) int As[kBM][kKW];   // [row][k-word]
  __shared__ __align__(16) int Bs[kKW][kBN];   // [k-word][column]

  const int tid = threadIdx.x;
  const int tx = tid % 16;        // columns 4 tx .. 4 tx + 3
  const int ty = tid / 16;        // rows ty, ty + 16, ty + 32, ty + 48
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;

  // loaders: x's tile is 64 rows x 16 words (4 words a thread);
  // w's tile is 16 k-words x 16 column-quads (one k-word x 4 columns each)
  const int lw_kw = tid / 16;     // the k-word this thread fills in Bs
  const int lw_nq = tid % 16;     // its 4 columns: 4 lw_nq .. 4 lw_nq + 3

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + r * kThreads;
      const int row = idx / kKW, kw = idx % kKW;
      const int64_t gm = m0 + row;
      As[row][kw] = load_word<kVec>(x + gm * K, k0 + 4 * kw, K, gm < M);
    }
    {
      // four k rows of w, each a word of 4 consecutive columns ...
      uint32_t r4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t gk = k0 + 4 * lw_kw + r;
        r4[r] = static_cast<uint32_t>(load_word<kVec>(
            w + gk * N, n0 + 4 * lw_nq, N, gk < K));
      }
      // ... transposed to one word per column holding the 4 k bytes
      const uint32_t t0 = __byte_perm(r4[0], r4[1], 0x5140);
      const uint32_t t1 = __byte_perm(r4[2], r4[3], 0x5140);
      const uint32_t t2 = __byte_perm(r4[0], r4[1], 0x7362);
      const uint32_t t3 = __byte_perm(r4[2], r4[3], 0x7362);
      int4 cols;
      cols.x = static_cast<int>(__byte_perm(t0, t1, 0x5410));
      cols.y = static_cast<int>(__byte_perm(t0, t1, 0x7632));
      cols.z = static_cast<int>(__byte_perm(t2, t3, 0x5410));
      cols.w = static_cast<int>(__byte_perm(t2, t3, 0x7632));
      *reinterpret_cast<int4*>(&Bs[lw_kw][4 * lw_nq]) = cols;
    }
    __syncthreads();

#pragma unroll
    for (int kq = 0; kq < kKW / 4; ++kq) {
      int4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int4*>(&As[ty + 16 * i][4 * kq]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 b = *reinterpret_cast<const int4*>(&Bs[4 * kq + q][4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int av = q == 0 ? a[i].x : q == 1 ? a[i].y
                       : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = __dp4a(av, b.x, acc[i][0]);
          acc[i][1] = __dp4a(av, b.y, acc[i][1]);
          acc[i][2] = __dp4a(av, b.z, acc[i][2]);
          acc[i][3] = __dp4a(av, b.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  const int64_t gn = n0 + 4 * tx;
  float ws[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ws[j] = gn + j < N ? w_scale[gn + j] : 0.f;
  // four whole, 16-byte aligned columns: one vector store a row
  const bool vec_out = N % 4 == 0 && gn + 3 < N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    const float xs = scale_f32(x_scale, gm);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), xs), ws[j]);
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

template <bool kVec>
void launch(const int8_t* x, const int8_t* w, const void* x_scale,
            const float* w_scale, float* out, int64_t M, int64_t K,
            int64_t N, int xs_bf16, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  if (xs_bf16) {
    i8mm_kernel<kVec, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        x, w, static_cast<const __nv_bfloat16*>(x_scale), w_scale, out, M, K,
        N);
  } else {
    i8mm_kernel<kVec, float><<<grid, kThreads, 0, stream>>>(
        x, w, static_cast<const float*>(x_scale), w_scale, out, M, K, N);
  }
}

}  // namespace

extern "C" int i8mm_forward(const void* x, const void* w, const void* x_scale,
                            const void* w_scale, void* out, int64_t M,
                            int64_t K, int64_t N, int xs_bf16,
                            void* stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const bool vec = K % 4 == 0 && N % 4 == 0
                   && reinterpret_cast<uintptr_t>(xp) % 4 == 0
                   && reinterpret_cast<uintptr_t>(wp) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    launch<true>(xp, wp, x_scale, static_cast<const float*>(w_scale),
                 static_cast<float*>(out), M, K, N, xs_bf16, s);
  } else {
    launch<false>(xp, wp, x_scale, static_cast<const float*>(w_scale),
                  static_cast<float*>(out), M, K, N, xs_bf16, s);
  }
  return static_cast<int>(cudaGetLastError());
}
