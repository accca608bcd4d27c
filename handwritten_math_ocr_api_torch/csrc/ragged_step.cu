// One whole decode step for R rows, each at its own position, in one launch.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/fused_step.py::fused_ragged_step
// (_make_kernel_ragged; MHA, bf16/float32 bundle, no ring). For row r:
//   x = round(emb[prev[r]] + pos_emb[pos[r]])     (float32 tables, the sum
//                                                  rounded to the weight
//                                                  type and back)
//   every layer at slot pos[r] (decoder_layers.cuh::run_layers)
//   logits = x W_head + b_head                    (float32)
// and then either the (V,) float32 logits of the row (return_logits, what
// beam search ranks) or its argmax (the first index of the max) and
// log(p_max + 1e-10), the reference's confidence numerics. prev and pos are
// int32 tensors in device memory, so a step needs no host value.
//
// Bound on the H100: bytes. A step reads every decoder weight once (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512) plus the float32 head
// (141 KB at vocab 138), each row's cross K/V and its cache prefix, and
// does about two flops per weight byte per row. Design: B1's, one block per
// row, with the row's own horizon pos[r]: the block reads no slot after it,
// so a slot past it may hold anything. Known weakness, as B1's: each block
// reads all weights through its own SM (50 rows of beam 5 at batch 10:
// 50 x 10.5 MB through L2 per step).
#include "decoder_layers.cuh"

namespace {

using decoder::kThreads;
using decoder::kWarps;

// y[n] = b[n] + sum_k x[k] W[k, n] for float32 W (D, V), any V; x and y in
// shared memory, red max(kThreads, V) floats.
__device__ void head(const float* x, const float* __restrict__ W,
                     const float* __restrict__ b, float* y, int D, int V,
                     float* red) {
  const int kparts = V >= kThreads ? 1 : kThreads / V;
  const int kchunk = (D + kparts - 1) / kparts;
  for (int item = threadIdx.x; item < V * kparts; item += kThreads) {
    const int n = item % V, kp = item / V;
    const int k1 = min(D, (kp + 1) * kchunk);
    float acc = 0.0f;
    for (int k = kp * kchunk; k < k1; ++k)
      acc = fmaf(x[k], W[static_cast<size_t>(k) * V + n], acc);
    red[kp * V + n] = acc;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < V; n += kThreads) {
    float s = 0.0f;
    for (int kp = 0; kp < kparts; ++kp) s += red[kp * V + n];
    y[n] = s + b[n];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_step_kernel(const int* __restrict__ prev, const int* __restrict__ pos,
                   const float* __restrict__ emb,
                   const float* __restrict__ pos_emb, decoder::Weights<T> w,
                   const T* __restrict__ self_k, const T* __restrict__ self_v,
                   const T* __restrict__ cross_k,
                   const T* __restrict__ cross_v,
                   const float* __restrict__ w_head,
                   const float* __restrict__ b_head,
                   float* __restrict__ logits, int* __restrict__ nxt,
                   float* __restrict__ logp, T* __restrict__ k_new,
                   T* __restrict__ v_new, int L, int R, int Tc, int D, int H,
                   int F, int L_enc, int V, int Tpos) {
  extern __shared__ float smem[];
  __shared__ float warp_max_v[kWarps];
  __shared__ int warp_max_i[kWarps];
  const int r = blockIdx.x;
  const int lstride = max(Tc, L_enc);
  const decoder::Smem s(smem, D, F, H, lstride);
  float* hy = s.red + decoder::red_floats<T>(D, F);  // V head outputs
  float* hred = hy + V;                               // max(kThreads, V)
  const int p = pos[r], tok = prev[r];

  if (p < 0 || p >= Tc || p >= Tpos || tok < 0 || tok >= V) {
    // out of range: NaN in every output of the row, nothing read
    const float nan = __int_as_float(0x7fffffff);
    for (int i = threadIdx.x; i < L * D; i += kThreads) {
      const size_t at = (static_cast<size_t>(i / D) * R + r) * D + i % D;
      k_new[at] = from_f32<T>(nan);
      v_new[at] = from_f32<T>(nan);
    }
    if (logits != nullptr) {
      for (int n = threadIdx.x; n < V; n += kThreads)
        logits[static_cast<size_t>(r) * V + n] = nan;
    } else if (threadIdx.x == 0) {
      nxt[r] = -1;
      logp[r] = nan;
    }
    return;
  }

  for (int d = threadIdx.x; d < D; d += kThreads)
    s.x[d] = round_to<T>(emb[static_cast<size_t>(tok) * D + d] +
                         pos_emb[static_cast<size_t>(p) * D + d]);
  __syncthreads();
  decoder::run_layers<T>(w, self_k, self_v, cross_k, cross_v, k_new, v_new,
                         L, R, r, Tc, D, H, F, L_enc, p, lstride, s);
  head(s.x, w_head, b_head, hy, D, V, hred);

  if (logits != nullptr) {
    for (int n = threadIdx.x; n < V; n += kThreads)
      logits[static_cast<size_t>(r) * V + n] = hy[n];
    return;
  }
  // argmax (first index of the max) and log(p_max + 1e-10)
  float mv = -INFINITY;
  int mi = V;
  for (int n = threadIdx.x; n < V; n += kThreads) {
    if (hy[n] > mv) {
      mv = hy[n];
      mi = n;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, mv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, mi, o);
    if (ov > mv || (ov == mv && oi < mi)) {
      mv = ov;
      mi = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_max_v[warp] = mv;
    warp_max_i[warp] = mi;
  }
  __syncthreads();
  mv = warp_max_v[0];
  mi = warp_max_i[0];
  for (int i = 1; i < kWarps; ++i) {
    if (warp_max_v[i] > mv || (warp_max_v[i] == mv && warp_max_i[i] < mi)) {
      mv = warp_max_v[i];
      mi = warp_max_i[i];
    }
  }
  float se = 0.0f;
  for (int n = threadIdx.x; n < V; n += kThreads) se += expf(hy[n] - mv);
  se = decoder::block_sum(se, s.scratch);
  if (threadIdx.x == 0) {
    const float p_max = expf(mv - (mv + logf(se)));
    nxt[r] = mi;
    logp[r] = logf(p_max + 1e-10f);
  }
}

template <typename T>
int launch(const void* prev, const void* pos, const void* emb,
           const void* pos_emb, const void* w_qkv, const void* b_qkv,
           const void* w_out, const void* b_out, const void* w_cq,
           const void* b_cq, const void* w_co, const void* b_co,
           const void* w_ff1, const void* b_ff1, const void* w_ff2,
           const void* b_ff2, const void* ln, const void* self_k,
           const void* self_v, const void* cross_k, const void* cross_v,
           const void* w_head, const void* b_head, void* logits, void* nxt,
           void* logp, void* k_new, void* v_new, int L, int R, int Tc, int D,
           int H, int F, int L_enc, int V, int Tpos, void* stream) {
  const size_t lstride = static_cast<size_t>(std::max(Tc, L_enc));
  const size_t floats = decoder::smem_floats<T>(D, F, H, lstride) + V +
                        std::max(kThreads, V);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = allow_smem(ragged_step_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CT = const T*;
  using CF = const float*;
  const decoder::Weights<T> w{
      static_cast<CT>(w_qkv), static_cast<CF>(b_qkv), static_cast<CT>(w_out),
      static_cast<CF>(b_out), static_cast<CT>(w_cq),  static_cast<CF>(b_cq),
      static_cast<CT>(w_co),  static_cast<CF>(b_co),  static_cast<CT>(w_ff1),
      static_cast<CF>(b_ff1), static_cast<CT>(w_ff2), static_cast<CF>(b_ff2),
      static_cast<CF>(ln)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ragged_step_kernel<T><<<R, kThreads, smem, st>>>(
      static_cast<const int*>(prev), static_cast<const int*>(pos),
      static_cast<CF>(emb), static_cast<CF>(pos_emb), w,
      static_cast<CT>(self_k), static_cast<CT>(self_v),
      static_cast<CT>(cross_k), static_cast<CT>(cross_v),
      static_cast<CF>(w_head), static_cast<CF>(b_head),
      static_cast<float*>(logits), static_cast<int*>(nxt),
      static_cast<float*>(logp), static_cast<T*>(k_new),
      static_cast<T*>(v_new), L, R, Tc, D, H, F, L_enc, V, Tpos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits is null for the argmax head (nxt, logp given), else nxt and logp
// are null.
#define RAGGED_STEP_ENTRY(NAME, TYPE)                                       \
  extern "C" int NAME(                                                      \
      const void* prev, const void* pos, const void* emb,                   \
      const void* pos_emb, const void* w_qkv, const void* b_qkv,            \
      const void* w_out, const void* b_out, const void* w_cq,               \
      const void* b_cq, const void* w_co, const void* b_co,                 \
      const void* w_ff1, const void* b_ff1, const void* w_ff2,              \
      const void* b_ff2, const void* ln, const void* self_k,                \
      const void* self_v, const void* cross_k, const void* cross_v,         \
      const void* w_head, const void* b_head, void* logits, void* nxt,      \
      void* logp, void* k_new, void* v_new, int L, int R, int Tc, int D,    \
      int H, int F, int L_enc, int V, int Tpos, void* stream) {             \
    return launch<TYPE>(prev, pos, emb, pos_emb, w_qkv, b_qkv, w_out,       \
                        b_out, w_cq, b_cq, w_co, b_co, w_ff1, b_ff1, w_ff2, \
                        b_ff2, ln, self_k, self_v, cross_k, cross_v,        \
                        w_head, b_head, logits, nxt, logp, k_new, v_new, L, \
                        R, Tc, D, H, F, L_enc, V, Tpos, stream);            \
  }

RAGGED_STEP_ENTRY(ragged_step_bf16, __nv_bfloat16)
RAGGED_STEP_ENTRY(ragged_step_f32, float)
