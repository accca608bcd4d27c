// Weight-only int8 matmul: y = round_to_x_type((x @ W_q) * scale[col]).
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/quant.py::_dequant_matmul_pallas, which
// the int8 decoder (DecodeEngine(quantize=True), default route) runs in
// every projection of every decode step and in the head. x (M, K) is bf16
// (the layers) or float32 (the head); W_q (K, N) int8 with row stride ldw
// (a column slice of a wider matrix keeps its parent's stride); scale (N,)
// float32. The int8 -> float conversion is exact (|w| <= 127), so for a
// bf16 x this is the TPU kernel's int8 -> bf16 cast and float32 dot. The
// sum is float32, times the column's scale, then rounded once to x's type.
// No bias: the caller adds it after the rounding.
//
// Bound on the H100: at decode shapes (M 16 or 50 rows, K and N 256-768)
// the int8 weight dominates the bytes (192 KB for the packed qkv), a few
// hundred nanoseconds at 3.35 TB/s, so the launch itself bounds a call;
// at the cross K/V projection (M 480 or 1500 rows of the encoder memory)
// the float32 products do. Design: a plain tiled product on CUDA cores.
// A block owns a 16-row x 64-column tile of y and walks K in chunks of 64,
// staging the x chunk (as float32) and the weight chunk (converted to
// float32) in shared memory; each thread keeps 4 columns of one row in
// registers. Weight rows load as 16-byte vectors of 16 int8 where rows are
// 16-byte aligned and N is a multiple of 16, else byte by byte (the
// 138-column head).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 16;  // rows of y per block
constexpr int kBN = 64;  // columns of y per block
constexpr int kBK = 64;  // reduction chunk
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ y,
                      int M, int K, int N, int ldw, int vec) {
  __shared__ float xs[kBM][kBK];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % (kBN / 4), ty = threadIdx.x / (kBN / 4);
  // the weight chunk: each thread loads 16 adjacent columns of one row
  const int wr = threadIdx.x / (kBN / 16), wc = (threadIdx.x % 4) * 16;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? to_f32(x[static_cast<size_t>(m) * K + k])
                                  : 0.0f;
    }
    {
      const int k = k0 + wr, n = n0 + wc;
      const int8_t* row = w + static_cast<size_t>(k) * ldw;
      float v[16];
      if (vec && k < K && n < N) {
        load_vec(row + n, v);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          v[j] = (k < K && n + j < N) ? static_cast<float>(row[n + j]) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) ws[wr][wc + j] = v[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float xv = xs[ty][kk];
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      acc[0] = fmaf(xv, wv.x, acc[0]);
      acc[1] = fmaf(xv, wv.y, acc[1]);
      acc[2] = fmaf(xv, wv.z, acc[2]);
      acc[3] = fmaf(xv, wv.w, acc[3]);
    }
    __syncthreads();
  }
  const int m = m0 + ty;
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n < N)
      y[static_cast<size_t>(m) * N + n] =
          from_f32<T>(__fmul_rn(acc[j], scale[n]));
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* y, int M,
           int K, int N, int ldw, int vec, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dequant_matmul_kernel<T><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(y), M, K, N, ldw,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 1 when every weight row starts on a 16-byte boundary and N is a
// multiple of 16 (16-byte loads), else 0.
extern "C" int dequant_matmul_bf16(const void* x, const void* w,
                                   const void* scale, void* y, int M, int K,
                                   int N, int ldw, int vec, void* stream) {
  return launch<__nv_bfloat16>(x, w, scale, y, M, K, N, ldw, vec, stream);
}

extern "C" int dequant_matmul_f32(const void* x, const void* w,
                                  const void* scale, void* y, int M, int K,
                                  int N, int ldw, int vec, void* stream) {
  return launch<float>(x, w, scale, y, M, K, N, ldw, vec, stream);
}
