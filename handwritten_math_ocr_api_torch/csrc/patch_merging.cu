// Swin patch merging: 2x2 gather -> LayerNorm(4C) -> 4C->2C linear, no bias.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/patch_merging.py::fused_patch_merging
// (_kernel). x is (B, H, W, C) NHWC with H, W even; output token (b, i, j)
// concatenates x[b, 2i, 2j], x[b, 2i+1, 2j], x[b, 2i, 2j+1],
// x[b, 2i+1, 2j+1] (the [even/even, odd/even, even/odd, odd/odd] order),
// normalises the 4C vector in float32 (eps 1e-5, biased variance), applies
// the float32 scale and bias, rounds to the storage type as the TPU kernel
// does before its matmul, and multiplies by the (4C, 2C) weight with
// float32 accumulation.
//
// Bound on the H100: at Swin-T widths and batch 16 each merge is a 1.1
// GFLOP product against a few MB of traffic, so the ideal is the tensor
// cores' rate; this simple version runs the product on the CUDA
// cores. Design: one block gathers and normalises kTok consecutive output
// tokens into shared memory (the 2x2 gather is done here, in the kernel),
// then each thread owns output columns and streams the weight column by
// column, so every weight element read from L2 serves kTok tokens.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTok = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_merging_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, const T* __restrict__ w,
                     T* __restrict__ out, int B, int H, int W, int C) {
  extern __shared__ float s[];  // kTok x 4C normalised rows
  const int H2 = H / 2, W2 = W / 2, C4 = 4 * C, C2 = 2 * C;
  const int M = B * H2 * W2;
  const int m0 = blockIdx.x * kTok;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int t = warp; t < kTok; t += nwarps) {
    float* row = s + t * C4;
    const int m = m0 + t;
    if (m >= M) {
      for (int c = lane; c < C4; c += 32) row[c] = 0.0f;
      continue;
    }
    const int b = m / (H2 * W2);
    const int r = m - b * (H2 * W2);
    const int i = r / W2, j = r - (r / W2) * W2;
    float sum = 0.0f;
    for (int c = lane; c < C4; c += 32) {
      const int quad = c / C, cc = c - quad * C;
      const int y = 2 * i + (quad & 1), xx = 2 * j + (quad >> 1);
      const float val =
          to_f32(x[((static_cast<size_t>(b) * H + y) * W + xx) * C + cc]);
      row[c] = val;
      sum += val;
    }
    const float mean = warp_sum(sum) / C4;
    float sq = 0.0f;
    for (int c = lane; c < C4; c += 32) {
      const float d = row[c] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / C4 + 1e-5f);
    for (int c = lane; c < C4; c += 32) {
      const float y = (row[c] - mean) * rstd * scale[c] + bias[c];
      row[c] = to_f32(from_f32<T>(y));
    }
  }
  __syncthreads();

  for (int n = threadIdx.x; n < C2; n += blockDim.x) {
    float acc[kTok];
#pragma unroll
    for (int t = 0; t < kTok; ++t) acc[t] = 0.0f;
    for (int kk = 0; kk < C4; ++kk) {
      const float wv = to_f32(w[static_cast<size_t>(kk) * C2 + n]);
#pragma unroll
      for (int t = 0; t < kTok; ++t) acc[t] = fmaf(s[t * C4 + kk], wv, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < kTok; ++t) {
      if (m0 + t < M)
        out[static_cast<size_t>(m0 + t) * C2 + n] = from_f32<T>(acc[t]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, const void* w,
           void* out, int B, int H, int W, int C, void* stream) {
  const int M = B * (H / 2) * (W / 2);
  const size_t smem = static_cast<size_t>(kTok) * 4 * C * sizeof(float);
  cudaError_t err = allow_smem(patch_merging_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + kTok - 1) / kTok;
  patch_merging_kernel<T><<<blocks, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const T*>(w),
      static_cast<T*>(out), B, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int patch_merging_bf16(const void* x, const void* scale,
                                  const void* bias, const void* w, void* out,
                                  int B, int H, int W, int C, void* stream) {
  return launch<__nv_bfloat16>(x, scale, bias, w, out, B, H, W, C, stream);
}

extern "C" int patch_merging_f32(const void* x, const void* scale,
                                 const void* bias, const void* w, void* out,
                                 int B, int H, int W, int C, void* stream) {
  return launch<float>(x, scale, bias, w, out, B, H, W, C, stream);
}
