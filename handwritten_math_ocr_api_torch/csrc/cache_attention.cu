// KV-cache append + single-query decode attention, one decoder layer, and
// the same attention without the append.
//
// Replaces two Pallas TPU kernels:
// - handwritten_math_ocr_api_tpu/ops/cache_attention.py::
//   cache_append_attention (_kernel). For each (batch, head) group g: write
//   k_new, v_new into row `pos` of the (T, Dh) caches, in place, then
//     out = softmax(q k_cache[0..pos]^T / sqrt(Dh)) v_cache[0..pos]
//   in float32;
// - handwritten_math_ocr_api_tpu/ops/decode_attention.py::decode_attention
//   (_kernel): the same attention over slots 0..pos of the caches as they
//   are, nothing written (kAppend false).
// Slots after `pos` are masked to -inf in the TPU kernels; they add exactly
// zero there, so this kernel does not read them at all.
//
// Bound on the H100: device memory. A step reads pos + 1 rows of K and of
// V and does 4 flops per element read, about 1 flop a byte. Design: one
// block per group, one warp per cache row for the logits (each warp reads
// a 64-byte bf16 row, coalesced), a block reduction for the softmax, and
// the weighted sum split over thread groups that each stride over the rows.
// `pos` comes by value: the kernel needs no host round trip.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read from a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nwarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T, bool kAppend>
__global__ void __launch_bounds__(kThreads)
cache_append_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_new,
                              const T* __restrict__ v_new,
                              T* __restrict__ k_cache,
                              T* __restrict__ v_cache, T* __restrict__ out,
                              int T_len, int Dh, int pos) {
  extern __shared__ float s[];
  float* qs = s;                 // Dh, scaled by 1/sqrt(Dh)
  float* kn = qs + Dh;           // Dh, the new K row
  float* vn = kn + Dh;           // Dh, the new V row
  float* p = vn + Dh;            // T_len logits, then probabilities
  float* red = p + T_len;        // 32 floats of reduction scratch
  float* part = red + 32;        // blockDim partial sums of the P.V product

  const int g = blockIdx.x;
  const size_t row = static_cast<size_t>(g) * Dh;
  const size_t cache = static_cast<size_t>(g) * T_len * Dh;
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));

  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    const size_t at = cache + static_cast<size_t>(pos) * Dh + d;
    T kv, vv;
    if (kAppend) {
      kv = k_new[row + d];
      vv = v_new[row + d];
      k_cache[at] = kv;
      v_cache[at] = vv;
    } else {
      kv = k_cache[at];
      vv = v_cache[at];
    }
    qs[d] = to_f32(q[row + d]) * scale;
    kn[d] = to_f32(kv);
    vn[d] = to_f32(vv);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t <= pos; t += nwarps) {
    const T* kt = k_cache + cache + static_cast<size_t>(t) * Dh;
    float acc = 0.0f;
    for (int d = lane; d < Dh; d += 32)
      acc = fmaf(qs[d], t == pos ? kn[d] : to_f32(kt[d]), acc);
    acc = warp_sum(acc);
    if (lane == 0) p[t] = acc;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int t = threadIdx.x; t <= pos; t += blockDim.x) mx = fmaxf(mx, p[t]);
  mx = block_reduce(mx, red, true);
  float sum = 0.0f;
  for (int t = threadIdx.x; t <= pos; t += blockDim.x) {
    const float e = expf(p[t] - mx);
    p[t] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);
  for (int t = threadIdx.x; t <= pos; t += blockDim.x) p[t] = p[t] / sum;
  __syncthreads();

  // threads form blockDim / Dh groups; group r sums rows r, r + groups, ...
  const int groups = blockDim.x / Dh;
  const int r = threadIdx.x / Dh, d = threadIdx.x - r * Dh;
  if (r < groups) {
    float acc = 0.0f;
    for (int t = r; t <= pos; t += groups) {
      const float vt =
          t == pos ? vn[d]
                   : to_f32(v_cache[cache + static_cast<size_t>(t) * Dh + d]);
      acc = fmaf(p[t], vt, acc);
    }
    part[threadIdx.x] = acc;
  }
  __syncthreads();
  for (int dd = threadIdx.x; dd < Dh; dd += blockDim.x) {
    float acc = 0.0f;
    for (int rr = 0; rr < groups; ++rr) acc += part[rr * Dh + dd];
    out[row + dd] = from_f32<T>(acc);
  }
}

template <typename T, bool kAppend>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
           void* v_cache, void* out, int G, int T_len, int Dh, int pos,
           void* stream) {
  const size_t smem =
      (static_cast<size_t>(3 * Dh + T_len + 32 + kThreads)) * sizeof(float);
  cudaError_t err =
      allow_smem(cache_append_attention_kernel<T, kAppend>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cache_append_attention_kernel<T, kAppend><<<G, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), static_cast<T*>(out), T_len, Dh, pos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cache_append_attention_bf16(const void* q, const void* k_new,
                                           const void* v_new, void* k_cache,
                                           void* v_cache, void* out, int G,
                                           int T_len, int Dh, int pos,
                                           void* stream) {
  return launch<__nv_bfloat16, true>(q, k_new, v_new, k_cache, v_cache, out,
                                     G, T_len, Dh, pos, stream);
}

extern "C" int cache_append_attention_f32(const void* q, const void* k_new,
                                          const void* v_new, void* k_cache,
                                          void* v_cache, void* out, int G,
                                          int T_len, int Dh, int pos,
                                          void* stream) {
  return launch<float, true>(q, k_new, v_new, k_cache, v_cache, out, G,
                             T_len, Dh, pos, stream);
}

// q, k, v, out: the caches are read only; k_new and v_new are not used.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out, int G,
                                     int T_len, int Dh, int pos,
                                     void* stream) {
  return launch<__nv_bfloat16, false>(q, nullptr, nullptr,
                                      const_cast<void*>(k),
                                      const_cast<void*>(v), out, G, T_len,
                                      Dh, pos, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* out, int G,
                                    int T_len, int Dh, int pos,
                                    void* stream) {
  return launch<float, false>(q, nullptr, nullptr, const_cast<void*>(k),
                              const_cast<void*>(v), out, G, T_len, Dh, pos,
                              stream);
}
