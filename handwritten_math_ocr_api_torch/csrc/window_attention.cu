// Shifted-window attention core of the Swin encoder.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/window_attention.py::window_attention_core
// (_attn_kernel): for each (batch, window, head) group g,
//   out = softmax(q k^T / sqrt(dh) + mask[g % mask_groups]) v
// with q, k, v of shape (N, dh) (N = 49 tokens of a 7x7 window, dh = 32 on
// Swin-T) and the additive mask (relative-position bias + shift mask, fill
// -100) in float32. Logits, softmax and the weighted sum run in float32.
//
// Bound on the H100: neither. Per group the kernel moves 4 * 49 * 32 * 2
// bytes of bf16 and does 4 * 49 * 49 * 32 flops, about 24 flops a byte,
// far below the card's ~295 bf16 flops per byte, so the ideal is
// memory-bound; this simple version runs its dot products on the CUDA
// cores out of shared memory. Design: one block per group; q (pre-scaled),
// k (rows padded by one float against bank conflicts) and v are staged in
// shared memory as float32, the (N, N) logits never leave the block, and
// one warp normalises each row.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ mask, T* __restrict__ out,
                        int N, int dh, int mask_groups) {
  extern __shared__ float smem[];
  const int nd = N * dh;
  const int kstride = dh + 1;
  float* qs = smem;                // N x dh, scaled by 1/sqrt(dh)
  float* ks = qs + nd;             // N x (dh + 1)
  float* vs = ks + N * kstride;    // N x dh
  float* ps = vs + nd;             // N x N logits, then probabilities

  const int g = blockIdx.x;
  const size_t base = static_cast<size_t>(g) * nd;
  const float* m = mask + static_cast<size_t>(g % mask_groups) * N * N;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));

  for (int idx = threadIdx.x; idx < nd; idx += blockDim.x) {
    const int i = idx / dh, d = idx - i * dh;
    qs[idx] = to_f32(q[base + idx]) * scale;
    ks[i * kstride + d] = to_f32(k[base + idx]);
    vs[idx] = to_f32(v[base + idx]);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
    const int i = idx / N, j = idx - i * N;
    const float* qi = qs + i * dh;
    const float* kj = ks + j * kstride;
    float acc = 0.0f;
    for (int d = 0; d < dh; ++d) acc = fmaf(qi[d], kj[d], acc);
    ps[idx] = acc + m[idx];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < N; i += nwarps) {
    float* row = ps + i * N;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nd; idx += blockDim.x) {
    const int i = idx / dh, d = idx - i * dh;
    const float* pi = ps + i * N;
    float acc = 0.0f;
    for (int j = 0; j < N; ++j) acc = fmaf(pi[j], vs[j * dh + d], acc);
    out[base + idx] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int G, int N, int dh, int mask_groups, void* stream) {
  const size_t smem =
      (static_cast<size_t>(N) * (3 * dh + 1) + static_cast<size_t>(N) * N) *
      sizeof(float);
  cudaError_t err = allow_smem(window_attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_kernel<T><<<G, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), N, dh, mask_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int window_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int G, int N, int dh,
                                     int mask_groups, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, out, G, N, dh, mask_groups,
                               stream);
}

extern "C" int window_attention_f32(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int G, int N, int dh,
                                    int mask_groups, void* stream) {
  return launch<float>(q, k, v, mask, out, G, N, dh, mask_groups, stream);
}
