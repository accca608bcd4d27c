// One greedy decode step through every decoder layer, in one launch.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/fused_step.py::fused_decoder_layers_step_v2
// (_make_kernel_v2, the compute-only "v2" step). For each batch row b:
//   x = x_emb[b]                                  (float32 from here on)
//   per layer l:
//     q, k, v = x W_qkv + b_qkv;  k, v -> k_new[l, b], v_new[l, b]
//     x = LN1(x + (attn(q, self cache[:pos] + fresh row) W_out + b_out))
//     x = LN2(x + (attn(x W_cq + b_cq, cross K/V) W_co + b_co))
//     x = LN3(x + (relu(x W_ff1 + b_ff1) W_ff2 + b_ff2))
//   x_out[b] = x
// with the TPU kernel's numerics: every matmul input rounded to the weight
// type and accumulated in float32, float32 biases, LayerNorm and softmax,
// the fresh K/V row rounded to the cache type before it joins attention at
// slot pos, and no slot after pos read (the TPU kernel's -inf mask). The
// caches are read only; the caller appends k_new and v_new.
//
// Bound on the H100: bytes. A step reads every decoder weight once (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512), the cross K/V and
// the cache prefix, and does about two flops per weight byte per row, far
// below the card's ~295 bf16 flops per byte. Design: the layers run in
// order inside one block per batch row, so nothing between sublayers
// leaves shared memory and the step is one launch instead of hundreds.
// Weight rows stream from device memory (L2 after the first row's block
// reads them) as 16-byte vectors, each thread owning 8 (bf16) or 4
// (float32) adjacent columns and a slice of the reduction, partial sums
// meeting in shared memory. Known weakness: a batch of 16 rows fills 16 of
// the card's 132 SMs and each block reads all weights through its own SM;
// the step runs some 50x above its byte bound, and what holds it (load
// latency or the block-wide barriers between sublayers) is not measured
// yet (keeping four weight rows' loads in flight per thread measured only
// 2% faster on an H100).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Sum over the block; every thread gets the total. scratch: kWarps floats.
__device__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call may still read scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? scratch[lane] : 0.0f);
}

// y[n] = bias[n] + sum_k x[k] W[k, n]; x (K floats) in shared memory,
// W (K, N) row-major in device memory, N a multiple of the vector width.
template <typename T>
__device__ void matvec(const float* x, const T* __restrict__ W,
                       const float* __restrict__ bias, float* y, int K,
                       int N, float* red) {
  constexpr int V = Vec<T>::N;
  const int ncv = N / V;
  const int kparts = ncv >= kThreads ? 1 : kThreads / ncv;
  const int kchunk = (K + kparts - 1) / kparts;
  for (int item = threadIdx.x; item < ncv * kparts; item += kThreads) {
    const int cv = item % ncv, kp = item / ncv;
    const int k0 = kp * kchunk, k1 = min(K, k0 + kchunk);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    for (int k = k0; k < k1; ++k) {
      float w[V];
      load_vec(W + static_cast<size_t>(k) * N + cv * V, w);
      const float xv = x[k];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(xv, w[j], acc[j]);
    }
    float* r = red + static_cast<size_t>(kp) * N + cv * V;
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = acc[j];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float s = 0.0f;
    for (int kp = 0; kp < kparts; ++kp) s += red[kp * N + n];
    y[n] = s + bias[n];
  }
  __syncthreads();
}

// x = LayerNorm(x + y) * g + b over D values in shared memory (eps 1e-5).
__device__ void add_layer_norm(float* x, const float* y,
                               const float* __restrict__ g,
                               const float* __restrict__ b, int D,
                               float* scratch) {
  float s = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = x[d] + y[d];
    x[d] = v;
    s += v;
  }
  const float mean = block_sum(s, scratch) / D;
  float q = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float c = x[d] - mean;
    q += c * c;
  }
  const float inv = rsqrtf(block_sum(q, scratch) / D + 1e-5f);
  for (int d = threadIdx.x; d < D; d += kThreads)
    x[d] = (x[d] - mean) * inv * g[d] + b[d];
  __syncthreads();
}

// Multi-head single-query attention. q (D floats, pre-scaled) in shared
// memory; rows s < n_cache of K and V (row stride D) in device memory; if
// fresh_k is given, row n_cache is fresh_k / fresh_v (shared memory).
// out[d] (rounded to T) = sum_s softmax_s(q_h . k_s) v_s[d], h = d / dh.
template <typename T>
__device__ void attend(const float* q, const T* __restrict__ K,
                       const T* __restrict__ Vv, int n_cache,
                       const float* fresh_k, const float* fresh_v, int D,
                       int H, float* logits, int lstride, float* out,
                       float* red) {
  constexpr int V = Vec<T>::N;
  const int dh = D / H;
  const int n = n_cache + (fresh_k != nullptr ? 1 : 0);
  for (int item = threadIdx.x; item < n * H; item += kThreads) {
    const int s = item / H, h = item - s * H;
    const float* qh = q + h * dh;
    float acc = 0.0f;
    if (s < n_cache) {
      const T* kr = K + static_cast<size_t>(s) * D + h * dh;
      for (int d = 0; d < dh; d += V) {
        float kv[V];
        load_vec(kr + d, kv);
#pragma unroll
        for (int j = 0; j < V; ++j) acc = fmaf(qh[d + j], kv[j], acc);
      }
    } else {
      const float* kr = fresh_k + h * dh;
      for (int d = 0; d < dh; ++d) acc = fmaf(qh[d], kr[d], acc);
    }
    logits[h * lstride + s] = acc;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < H; h += kWarps) {
    float* row = logits + h * lstride;
    float mx = -INFINITY;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(row[s] - mx);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < n; s += 32) row[s] = row[s] / sum;
  }
  __syncthreads();
  // groups of D threads split the slots; partial sums meet in red
  const int groups = D >= kThreads ? 1 : kThreads / D;
  const int per = (n + groups - 1) / groups;
  for (int item = threadIdx.x; item < D * groups; item += kThreads) {
    const int d = item % D, g = item / D;
    const float* p = logits + (d / dh) * lstride;
    const int s1 = min(n, (g + 1) * per);
    float acc = 0.0f;
    for (int s = g * per; s < s1; ++s) {
      const float v = s < n_cache
                          ? to_f32(Vv[static_cast<size_t>(s) * D + d])
                          : fresh_v[d];
      acc = fmaf(p[s], v, acc);
    }
    red[g * D + d] = acc;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += red[g * D + d];
    out[d] = round_to<T>(s);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const T* __restrict__ x_emb, const T* __restrict__ w_qkv,
                  const float* __restrict__ b_qkv,
                  const T* __restrict__ w_out,
                  const float* __restrict__ b_out,
                  const T* __restrict__ w_cq, const float* __restrict__ b_cq,
                  const T* __restrict__ w_co, const float* __restrict__ b_co,
                  const T* __restrict__ w_ff1,
                  const float* __restrict__ b_ff1,
                  const T* __restrict__ w_ff2,
                  const float* __restrict__ b_ff2,
                  const float* __restrict__ ln, const T* __restrict__ self_k,
                  const T* __restrict__ self_v,
                  const T* __restrict__ cross_k,
                  const T* __restrict__ cross_v, float* __restrict__ x_out,
                  T* __restrict__ k_new, T* __restrict__ v_new, int L, int B,
                  int Tc, int D, int H, int F, int L_enc, int pos) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int N3 = 3 * D;
  const int lstride = max(pos + 1, L_enc);
  float* scratch = smem;               // kWarps floats (32 kept)
  float* x = scratch + 32;             // D: the row, float32
  float* xr = x + D;                   // max(D, F): matmul input
  float* y = xr + max(D, F);           // max(3D, F): matmul output
  float* logits = y + max(N3, F);      // H x lstride
  float* red = logits + H * lstride;   // partial sums
  const float scale = 1.0f / sqrtf(static_cast<float>(D / H));

  for (int d = threadIdx.x; d < D; d += kThreads)
    x[d] = to_f32(x_emb[static_cast<size_t>(b) * D + d]);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const float* lnl = ln + static_cast<size_t>(l) * 6 * D;
    const size_t row = static_cast<size_t>(l) * B + b;

    // self-attention over the cache prefix and the fresh row
    for (int d = threadIdx.x; d < D; d += kThreads) xr[d] = round_to<T>(x[d]);
    __syncthreads();
    matvec<T>(xr, w_qkv + static_cast<size_t>(l) * D * N3,
              b_qkv + static_cast<size_t>(l) * N3, y, D, N3, red);
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const T k = from_f32<T>(y[D + d]), v = from_f32<T>(y[2 * D + d]);
      k_new[row * D + d] = k;
      v_new[row * D + d] = v;
      y[d] *= scale;
      y[D + d] = to_f32(k);
      y[2 * D + d] = to_f32(v);
    }
    __syncthreads();
    attend<T>(y, self_k + row * Tc * D, self_v + row * Tc * D, pos, y + D,
              y + 2 * D, D, H, logits, lstride, xr, red);
    matvec<T>(xr, w_out + static_cast<size_t>(l) * D * D,
              b_out + static_cast<size_t>(l) * D, y, D, D, red);
    add_layer_norm(x, y, lnl, lnl + D, D, scratch);

    // cross-attention over the encoder K/V
    for (int d = threadIdx.x; d < D; d += kThreads) xr[d] = round_to<T>(x[d]);
    __syncthreads();
    matvec<T>(xr, w_cq + static_cast<size_t>(l) * D * D,
              b_cq + static_cast<size_t>(l) * D, y, D, D, red);
    for (int d = threadIdx.x; d < D; d += kThreads) y[d] *= scale;
    __syncthreads();
    attend<T>(y, cross_k + row * L_enc * D, cross_v + row * L_enc * D, L_enc,
              nullptr, nullptr, D, H, logits, lstride, xr, red);
    matvec<T>(xr, w_co + static_cast<size_t>(l) * D * D,
              b_co + static_cast<size_t>(l) * D, y, D, D, red);
    add_layer_norm(x, y, lnl + 2 * D, lnl + 3 * D, D, scratch);

    // ReLU FFN
    for (int d = threadIdx.x; d < D; d += kThreads) xr[d] = round_to<T>(x[d]);
    __syncthreads();
    matvec<T>(xr, w_ff1 + static_cast<size_t>(l) * D * F,
              b_ff1 + static_cast<size_t>(l) * F, y, D, F, red);
    for (int f = threadIdx.x; f < F; f += kThreads)
      xr[f] = round_to<T>(fmaxf(y[f], 0.0f));
    __syncthreads();
    matvec<T>(xr, w_ff2 + static_cast<size_t>(l) * F * D,
              b_ff2 + static_cast<size_t>(l) * D, y, F, D, red);
    add_layer_norm(x, y, lnl + 4 * D, lnl + 5 * D, D, scratch);
  }
  for (int d = threadIdx.x; d < D; d += kThreads)
    x_out[static_cast<size_t>(b) * D + d] = x[d];
}

template <typename T>
int launch(const void* x_emb, const void* w_qkv, const void* b_qkv,
           const void* w_out, const void* b_out, const void* w_cq,
           const void* b_cq, const void* w_co, const void* b_co,
           const void* w_ff1, const void* b_ff1, const void* w_ff2,
           const void* b_ff2, const void* ln, const void* self_k,
           const void* self_v, const void* cross_k, const void* cross_v,
           void* x_out, void* k_new, void* v_new, int L, int B, int Tc,
           int D, int H, int F, int L_enc, int pos, void* stream) {
  constexpr int V = Vec<T>::N;
  const size_t lstride = static_cast<size_t>(std::max(pos + 1, L_enc));
  const size_t red =
      static_cast<size_t>(std::max(kThreads * V, std::max(3 * D, F)));
  const size_t floats = 32 + D + std::max(D, F) + std::max(3 * D, F) +
                        H * lstride + red;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = allow_smem(fused_step_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CT = const T*;
  using CF = const float*;
  fused_step_kernel<T><<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<CT>(x_emb), static_cast<CT>(w_qkv),
      static_cast<CF>(b_qkv), static_cast<CT>(w_out),
      static_cast<CF>(b_out), static_cast<CT>(w_cq), static_cast<CF>(b_cq),
      static_cast<CT>(w_co), static_cast<CF>(b_co), static_cast<CT>(w_ff1),
      static_cast<CF>(b_ff1), static_cast<CT>(w_ff2),
      static_cast<CF>(b_ff2), static_cast<CF>(ln), static_cast<CT>(self_k),
      static_cast<CT>(self_v), static_cast<CT>(cross_k),
      static_cast<CT>(cross_v), static_cast<float*>(x_out),
      static_cast<T*>(k_new), static_cast<T*>(v_new), L, B, Tc, D, H, F,
      L_enc, pos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FUSED_STEP_ENTRY(NAME, TYPE)                                        \
  extern "C" int NAME(                                                      \
      const void* x_emb, const void* w_qkv, const void* b_qkv,              \
      const void* w_out, const void* b_out, const void* w_cq,               \
      const void* b_cq, const void* w_co, const void* b_co,                 \
      const void* w_ff1, const void* b_ff1, const void* w_ff2,              \
      const void* b_ff2, const void* ln, const void* self_k,               \
      const void* self_v, const void* cross_k, const void* cross_v,         \
      void* x_out, void* k_new, void* v_new, int L, int B, int Tc, int D,   \
      int H, int F, int L_enc, int pos, void* stream) {                     \
    return launch<TYPE>(x_emb, w_qkv, b_qkv, w_out, b_out, w_cq, b_cq,      \
                        w_co, b_co, w_ff1, b_ff1, w_ff2, b_ff2, ln, self_k, \
                        self_v, cross_k, cross_v, x_out, k_new, v_new, L,   \
                        B, Tc, D, H, F, L_enc, pos, stream);                \
  }

FUSED_STEP_ENTRY(fused_decoder_step_bf16, __nv_bfloat16)
FUSED_STEP_ENTRY(fused_decoder_step_f32, float)
