// One whole greedy decode step for the batch, in one launch: the embedding,
// every decoder layer, the float32 head and its argmax.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/fused_step.py::fused_whole_step
// (_make_kernel_v4, B10; MHA, the bf16 or float32 bundle of
// build_stacked_full). For batch row b at the step's position pos:
//   x = round(emb[prev[b]] + pos_emb[pos])        (float32 tables, the sum
//                                                  rounded to the compute
//                                                  type C and back)
//   every layer at slot pos (decoder_layers.cuh::run_layers)
//   logits = x W_head + b_head                    (float32)
//   nxt[b], logp[b] = argmax, log(p_max + 1e-10)  (decoder::argmax_logp)
// Two layouts of the self cache, an entry each:
// - "v4", time-major (L, T, B, D): the fresh K/V rows are written into the
//   caches at pos, in place (the TPU kernel's aliased single-row writes);
// - "v3", batch-major (L, B, T, D), read only: the fresh rows go to
//   (L, B, D) outputs that the caller appends.
// prev is an int32 tensor in device memory (a step needs no host value);
// pos comes by value. A row whose prev lies outside the vocabulary gets
// nxt -1, logp NaN and NaN fresh rows.
//
// Bound on the H100: bytes. A step reads every decoder weight once (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512) plus the float32
// head (141 KB at vocab 138), the cross K/V and the cache prefix, and does
// about two flops per weight byte per row. Design: one block per row
// (decoder_layers.cuh); the TPU kernel's one-hot matmuls for the embedding
// and the position row become two loads, and its vocabulary padding to
// 128 lanes (a -1e9 bias) is dropped: the head computes exactly V columns.
// Known weakness: each block reads all weights through its own SM.
#include "decoder_layers.cuh"

namespace {

using decoder::kThreads;

template <typename C>
__global__ void __launch_bounds__(kThreads, 1)
whole_step_kernel(const int* __restrict__ prev,
                  const float* __restrict__ emb,
                  const float* __restrict__ pos_emb, decoder::Weights<C> w,
                  const C* self_k, const C* self_v,
                  decoder::CacheLayout self, const C* __restrict__ cross_k,
                  const C* __restrict__ cross_v,
                  const float* __restrict__ w_head,
                  const float* __restrict__ b_head, int* __restrict__ nxt,
                  float* __restrict__ logp, decoder::FreshRows<C> fresh,
                  int L, int B, int D, int H, int F, int L_enc, int V,
                  int pos) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lstride = max(pos + 1, L_enc);
  const decoder::Smem s(smem, D, F, H, lstride);
  float* hy = s.red + decoder::red_floats<C>(D, F);  // V head outputs
  float* hred = hy + V;                               // max(kThreads, V)
  const int tok = prev[b];

  if (tok < 0 || tok >= V) {
    // out of range: NaN in every output of the row, nothing read
    const float nan = __int_as_float(0x7fffffff);
    for (int i = threadIdx.x; i < L * D; i += kThreads) {
      const size_t at = (i / D) * fresh.layer + b * fresh.row + i % D;
      fresh.k[at] = from_f32<C>(nan);
      fresh.v[at] = from_f32<C>(nan);
    }
    if (threadIdx.x == 0) {
      nxt[b] = -1;
      logp[b] = nan;
    }
    return;
  }

  for (int d = threadIdx.x; d < D; d += kThreads)
    s.x[d] = round_to<C>(emb[static_cast<size_t>(tok) * D + d] +
                         pos_emb[static_cast<size_t>(pos) * D + d]);
  __syncthreads();
  decoder::run_layers<C, C>(w, self_k, self_v, self, cross_k, cross_v, fresh,
                            L, B, b, D, H, F, L_enc, pos, true, lstride, s);
  decoder::head(s.x, w_head, b_head, hy, D, V, hred);
  const decoder::Pick pick = decoder::argmax_logp(hy, V, s.scratch);
  if (threadIdx.x == 0) {
    nxt[b] = pick.index;
    logp[b] = pick.logp;
  }
}

// wp: six (weight, scale, bias) triples, scale null (a float bundle).
// k_new and v_new null: time-major caches, the fresh rows written in place;
// else batch-major caches, read only.
template <typename C>
int launch(const void* prev, const void* emb, const void* pos_emb,
           const void* const* wp, const void* ln, void* self_k,
           void* self_v, const void* cross_k, const void* cross_v,
           const void* w_head, const void* b_head, void* nxt, void* logp,
           void* k_new, void* v_new, int L, int B, int Tc, int D, int H,
           int F, int L_enc, int V, int pos, void* stream) {
  const size_t lstride = static_cast<size_t>(std::max(pos + 1, L_enc));
  const size_t floats =
      decoder::smem_floats<C>(D, F, H, lstride) + decoder::head_floats(V);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = allow_smem(whole_step_kernel<C>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  C* sk = static_cast<C*>(self_k);
  C* sv = static_cast<C*>(self_v);
  const bool in_place = k_new == nullptr;
  const decoder::CacheLayout self = in_place
                                        ? decoder::time_major(B, Tc, D)
                                        : decoder::batch_major(B, Tc, D);
  const decoder::FreshRows<C> fresh =
      in_place ? decoder::rows_in_place<C>(sk, sv, self, pos)
               : decoder::rows_out<C>(k_new, v_new, B, D);
  using CC = const C*;
  using CF = const float*;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  whole_step_kernel<C><<<B, kThreads, smem, st>>>(
      static_cast<const int*>(prev), static_cast<CF>(emb),
      static_cast<CF>(pos_emb), decoder::make_weights<C>(wp, ln), sk, sv,
      self, static_cast<CC>(cross_k), static_cast<CC>(cross_v),
      static_cast<CF>(w_head), static_cast<CF>(b_head),
      static_cast<int*>(nxt), static_cast<float*>(logp), fresh, L, B, D, H,
      F, L_enc, V, pos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define WHOLE_STEP_WEIGHTS                                                  \
  const void *w_qkv, const void *b_qkv, const void *w_out,                  \
      const void *b_out, const void *w_cq, const void *b_cq,                \
      const void *w_co, const void *b_co, const void *w_ff1,                \
      const void *b_ff1, const void *w_ff2, const void *b_ff2,              \
      const void *ln
#define WHOLE_STEP_WP                                                       \
  const void* wp[18] = {w_qkv, nullptr, b_qkv, w_out, nullptr, b_out,      \
                        w_cq,  nullptr, b_cq,  w_co,  nullptr, b_co,       \
                        w_ff1, nullptr, b_ff1, w_ff2, nullptr, b_ff2}

// "v4": time-major (L, T, B, D) caches, the fresh rows written at pos.
#define WHOLE_STEP_TIME_MAJOR_ENTRY(NAME, TYPE)                             \
  extern "C" int NAME(const void* prev, const void* emb,                    \
                      const void* pos_emb, WHOLE_STEP_WEIGHTS, void* self_k, \
                      void* self_v, const void* cross_k,                    \
                      const void* cross_v, const void* w_head,              \
                      const void* b_head, void* nxt, void* logp, int L,     \
                      int B, int Tc, int D, int H, int F, int L_enc, int V, \
                      int pos, void* stream) {                              \
    WHOLE_STEP_WP;                                                          \
    return launch<TYPE>(prev, emb, pos_emb, wp, ln, self_k, self_v,        \
                        cross_k, cross_v, w_head, b_head, nxt, logp,        \
                        nullptr, nullptr, L, B, Tc, D, H, F, L_enc, V, pos, \
                        stream);                                            \
  }

// "v3": batch-major (L, B, T, D) caches, read only; the fresh rows out.
#define WHOLE_STEP_ROWS_ENTRY(NAME, TYPE)                                   \
  extern "C" int NAME(const void* prev, const void* emb,                    \
                      const void* pos_emb, WHOLE_STEP_WEIGHTS,              \
                      const void* self_k, const void* self_v,               \
                      const void* cross_k, const void* cross_v,             \
                      const void* w_head, const void* b_head, void* nxt,    \
                      void* logp, void* k_new, void* v_new, int L, int B,   \
                      int Tc, int D, int H, int F, int L_enc, int V,        \
                      int pos, void* stream) {                              \
    WHOLE_STEP_WP;                                                          \
    return launch<TYPE>(prev, emb, pos_emb, wp, ln,                        \
                        const_cast<void*>(self_k),                          \
                        const_cast<void*>(self_v), cross_k, cross_v,        \
                        w_head, b_head, nxt, logp, k_new, v_new, L, B, Tc,  \
                        D, H, F, L_enc, V, pos, stream);                    \
  }

WHOLE_STEP_TIME_MAJOR_ENTRY(whole_step_time_major_bf16, __nv_bfloat16)
WHOLE_STEP_TIME_MAJOR_ENTRY(whole_step_time_major_f32, float)
WHOLE_STEP_ROWS_ENTRY(whole_step_rows_bf16, __nv_bfloat16)
WHOLE_STEP_ROWS_ENTRY(whole_step_rows_f32, float)
