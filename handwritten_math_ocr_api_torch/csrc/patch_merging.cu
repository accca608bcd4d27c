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
// Bound on the H100: bytes. At Swin-T widths and 16 images a merge is
// about 1.1 GFLOP against 4-6 MB of traffic, some 200 flops a byte, under
// the card's ~295 bf16 flops per byte: the tensor cores must run the
// product for the bytes to set the time.
//
// bf16 (patch_merging_mma_kernel): a block takes a tile of 32 output
// tokens by bn output columns (the widest of 192, 128 and 64 whose grid
// still fills the SMs), so every weight element read serves the whole row
// tile; a wider tile gathers and normalises the tokens fewer times.
// Prologue: the four C-runs of each token's 2x2 neighbourhood by 16-byte
// cp.async copies into the tile's bf16 rows (exact), all in flight at once
// with the weight's first k-tiles; then a warp a token takes the float32
// statistics in two passes over its row and rounds the normalised row in
// place. Rows past M are zeros and never stored.
// Then mma_pass.cuh's product (mma.sync m16n8k16, float32 sums, weight
// k-tiles by cp.async into a 3-tile ring, the next in flight) and one
// rounding of each output.
//
// float32 (patch_merging_kernel): the CUDA-core version (no TF32): a block
// normalises kTok tokens into shared memory and each thread walks the
// weight for its output columns.
#include "common.cuh"
#include "mma_pass.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStages = 3;  // tiles of the weight ring

constexpr int kRows = 32;  // output tokens a block: 2 warp rows of 16
constexpr int kMmaThreads = mp::kThreads<2>;

template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
patch_merging_mma_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const bf16* __restrict__ w, bf16* __restrict__ out,
                         int B, int H, int W, int C, int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H2 = H / 2, W2 = W / 2, C4 = 4 * C, C2 = 2 * C;
  const int M = B * H2 * W2;
  const int lda = C4 + 8;
  bf16* A = reinterpret_cast<bf16*>(smem);
  const mp::Ring<kStages> ring{A + kRows * lda, bn + 8};
  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * bn;

  // the tile's 2x2 neighbourhoods into its rows (rows past M zero), all
  // copies in flight at once, then the weight's first tiles
  const int cv = C4 / 8;  // 16-byte vectors a row
  for (int e = threadIdx.x; e < kRows * cv; e += kMmaThreads) {
    const int t = e / cv, v = e - t * cv;
    const int m = m0 + t;
    bf16* to = A + t * lda + 8 * v;
    if (m >= M) {
      *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const int b = m / (H2 * W2);
    const int r = m - b * (H2 * W2);
    const int i = r / W2, j = r - i * W2;
    const int quad = 8 * v / C, cc = 8 * v - quad * C;
    const int y = 2 * i + (quad & 1), xx = 2 * j + (quad >> 1);
    cp_async16(to, x + ((static_cast<size_t>(b) * H + y) * W + xx) * C + cc);
  }
  cp_async_commit();
  const mp::Stream<mp::kCopies<NT, 2>> st = mp::begin<mp::kCopies<NT, 2>, 2>(
      ring, mp::Pass{w, C2, n0, bn, 0, C4, bn});
  cp_async_wait<kStages - 1>();  // the gather (the oldest group)
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int t = warp; t < kRows && m0 + t < M; t += kMmaThreads / 32)
    mp::ln_row(A + t * lda, A + t * lda, C4, scale, bias);

  float acc[1][NT][4];
  mp::zero(acc);
  mp::run<2>(ring, st, bn, A, lda, acc);
  mp::for_pairs<2>(bn, acc, [&](int r, int n, float v0, float v1) {
    if (m0 + r < M)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m0 + r) * C2 +
                                   n0 + n) = tc::pack_bf16(v0, v1);
  });
}

constexpr int kThreads = 256;
constexpr int kTok = 8;

__global__ void __launch_bounds__(kThreads)
patch_merging_kernel(const float* __restrict__ x,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ w, float* __restrict__ out,
                     int B, int H, int W, int C) {
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
      const float val = x[((static_cast<size_t>(b) * H + y) * W + xx) * C + cc];
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
    for (int c = lane; c < C4; c += 32)
      row[c] = (row[c] - mean) * rstd * scale[c] + bias[c];
  }
  __syncthreads();

  for (int n = threadIdx.x; n < C2; n += blockDim.x) {
    float acc[kTok];
#pragma unroll
    for (int t = 0; t < kTok; ++t) acc[t] = 0.0f;
    for (int kk = 0; kk < C4; ++kk) {
      const float wv = w[static_cast<size_t>(kk) * C2 + n];
#pragma unroll
      for (int t = 0; t < kTok; ++t) acc[t] = fmaf(s[t * C4 + kk], wv, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < kTok; ++t) {
      if (m0 + t < M) out[static_cast<size_t>(m0 + t) * C2 + n] = acc[t];
    }
  }
}

}  // namespace

// bf16: x, scale, bias, w, out, B, H, W, C, the wrapper's tile columns bn,
// shared memory bytes, stream. C must be a multiple of 16 and bn a
// multiple of 32 up to 256 dividing 2C (cudaErrorInvalidValue otherwise).
extern "C" int patch_merging_bf16(const void* x, const void* scale,
                                  const void* bias, const void* w, void* out,
                                  int B, int H, int W, int C, int bn,
                                  int smem, void* stream) {
  const size_t need =
      sizeof(bf16) * (static_cast<size_t>(kRows) * (4 * C + 8) +
                      static_cast<size_t>(kStages) * mp::kKt * (bn + 8));
  if (C % 16 || bn < 32 || bn > 256 || bn % 32 || (2 * C) % bn ||
      need > static_cast<size_t>(smem))
    return cudaErrorInvalidValue;
  const int M = B * (H / 2) * (W / 2);
  const dim3 grid((M + kRows - 1) / kRows, 2 * C / bn);
  const auto kernel = bn <= 64 ? patch_merging_mma_kernel<2>
                               : patch_merging_mma_kernel<8>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), B, H, W, C, bn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int patch_merging_f32(const void* x, const void* scale,
                                 const void* bias, const void* w, void* out,
                                 int B, int H, int W, int C, void* stream) {
  const int M = B * (H / 2) * (W / 2);
  const size_t smem = static_cast<size_t>(kTok) * 4 * C * sizeof(float);
  cudaError_t err = allow_smem(patch_merging_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + kTok - 1) / kTok;
  patch_merging_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(w),
      static_cast<float*>(out), B, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
