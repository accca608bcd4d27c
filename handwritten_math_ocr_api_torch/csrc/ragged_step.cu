// One whole decode step for R rows, each at its own position, in one launch.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/fused_step.py::fused_ragged_step
// (_make_kernel_ragged; MHA, no ring; the bf16/float32 bundle, or the
// int8 one with bf16 matmul inputs, see decoder_layers.cuh). For row r:
//   x = round(emb[prev[r]] + pos_emb[pos[r]])     (float32 tables, the sum
//                                                  rounded to the compute
//                                                  type C and back)
//   every layer at slot pos[r] (decoder_layers.cuh::run_layers)
//   logits = x W_head + b_head                    (float32)
// and then either the (V,) float32 logits of the row (return_logits, what
// beam search ranks) or its argmax (the first index of the max) and
// log(p_max + 1e-10), the reference's confidence numerics. prev and pos are
// int32 tensors in device memory, so a step needs no host value.
//
// Bound on the H100: bytes. A step reads every decoder weight once (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512; half in int8) plus
// the float32 head (141 KB at vocab 138), each row's cross K/V and its
// cache prefix, and does about two flops per weight byte per row. Design: B1's, one block per
// row, with the row's own horizon pos[r]: the block reads no slot after it,
// so a slot past it may hold anything. Known weakness, as B1's: each block
// reads all weights through its own SM (50 rows of beam 5 at batch 10:
// 50 x 10.5 MB through L2 per step).
#include "decoder_layers.cuh"

namespace {

using decoder::kThreads;

template <typename W, typename C>
__global__ void __launch_bounds__(kThreads, 1)
ragged_step_kernel(const int* __restrict__ prev, const int* __restrict__ pos,
                   const float* __restrict__ emb,
                   const float* __restrict__ pos_emb, decoder::Weights<W> w,
                   const C* self_k, const C* self_v,
                   const C* __restrict__ cross_k,
                   const C* __restrict__ cross_v,
                   const float* __restrict__ w_head,
                   const float* __restrict__ b_head,
                   float* __restrict__ logits, int* __restrict__ nxt,
                   float* __restrict__ logp, C* __restrict__ k_new,
                   C* __restrict__ v_new, int L, int R, int Tc, int D, int H,
                   int F, int L_enc, int V, int Tpos) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int lstride = max(Tc, L_enc);
  const decoder::Smem s(smem, D, F, H, lstride);
  float* hy = s.red + decoder::red_floats<W>(D, F);  // V head outputs
  float* hred = hy + V;                               // max(kThreads, V)
  const int p = pos[r], tok = prev[r];

  if (p < 0 || p >= Tc || p >= Tpos || tok < 0 || tok >= V) {
    // out of range: NaN in every output of the row, nothing read
    const float nan = __int_as_float(0x7fffffff);
    for (int i = threadIdx.x; i < L * D; i += kThreads) {
      const size_t at = (static_cast<size_t>(i / D) * R + r) * D + i % D;
      k_new[at] = from_f32<C>(nan);
      v_new[at] = from_f32<C>(nan);
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
    s.x[d] = round_to<C>(emb[static_cast<size_t>(tok) * D + d] +
                         pos_emb[static_cast<size_t>(p) * D + d]);
  __syncthreads();
  decoder::run_layers<W, C>(w, self_k, self_v,
                            decoder::batch_major(R, Tc, D), cross_k, cross_v,
                            {k_new, v_new, static_cast<size_t>(R) * D,
                             static_cast<size_t>(D)},
                            L, R, r, D, H, F, L_enc, p, true, lstride, s);
  decoder::head(s.x, w_head, b_head, hy, D, V, hred);

  if (logits != nullptr) {
    for (int n = threadIdx.x; n < V; n += kThreads)
      logits[static_cast<size_t>(r) * V + n] = hy[n];
    return;
  }
  const decoder::Pick pick = decoder::argmax_logp(hy, V, s.scratch);
  if (threadIdx.x == 0) {
    nxt[r] = pick.index;
    logp[r] = pick.logp;
  }
}

// wp: six (weight, scale, bias) triples, scale null for a float bundle.
template <typename W, typename C>
int launch(const void* prev, const void* pos, const void* emb,
           const void* pos_emb, const void* const* wp, const void* ln,
           const void* self_k, const void* self_v, const void* cross_k,
           const void* cross_v, const void* w_head, const void* b_head,
           void* logits, void* nxt, void* logp, void* k_new, void* v_new,
           int L, int R, int Tc, int D, int H, int F, int L_enc, int V,
           int Tpos, void* stream) {
  const size_t lstride = static_cast<size_t>(std::max(Tc, L_enc));
  const size_t floats =
      decoder::smem_floats<W>(D, F, H, lstride) + decoder::head_floats(V);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = allow_smem(ragged_step_kernel<W, C>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CC = const C*;
  using CF = const float*;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ragged_step_kernel<W, C><<<R, kThreads, smem, st>>>(
      static_cast<const int*>(prev), static_cast<const int*>(pos),
      static_cast<CF>(emb), static_cast<CF>(pos_emb),
      decoder::make_weights<W>(wp, ln), static_cast<CC>(self_k),
      static_cast<CC>(self_v), static_cast<CC>(cross_k),
      static_cast<CC>(cross_v), static_cast<CF>(w_head),
      static_cast<CF>(b_head), static_cast<float*>(logits),
      static_cast<int*>(nxt), static_cast<float*>(logp),
      static_cast<C*>(k_new), static_cast<C*>(v_new), L, R, Tc, D, H, F,
      L_enc, V, Tpos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits is null for the argmax head (nxt, logp given), else nxt and logp
// are null. The bf16 and float32 bundles: six (weight, bias) pairs.
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
    const void* wp[18] = {w_qkv, nullptr, b_qkv, w_out, nullptr, b_out,    \
                          w_cq,  nullptr, b_cq,  w_co,  nullptr, b_co,     \
                          w_ff1, nullptr, b_ff1, w_ff2, nullptr, b_ff2};   \
    return launch<TYPE, TYPE>(prev, pos, emb, pos_emb, wp, ln, self_k,     \
                              self_v, cross_k, cross_v, w_head, b_head,     \
                              logits, nxt, logp, k_new, v_new, L, R, Tc, D, \
                              H, F, L_enc, V, Tpos, stream);                \
  }

// The int8 bundle: six (weight, scale, bias) triples; CACHE the cache
// type (the model's compute dtype).
#define RAGGED_STEP_I8_ENTRY(NAME, CACHE)                                   \
  extern "C" int NAME(                                                      \
      const void* prev, const void* pos, const void* emb,                   \
      const void* pos_emb, const void* w_qkv, const void* s_qkv,            \
      const void* b_qkv, const void* w_out, const void* s_out,              \
      const void* b_out, const void* w_cq, const void* s_cq,                \
      const void* b_cq, const void* w_co, const void* s_co,                 \
      const void* b_co, const void* w_ff1, const void* s_ff1,               \
      const void* b_ff1, const void* w_ff2, const void* s_ff2,              \
      const void* b_ff2, const void* ln, const void* self_k,                \
      const void* self_v, const void* cross_k, const void* cross_v,         \
      const void* w_head, const void* b_head, void* logits, void* nxt,      \
      void* logp, void* k_new, void* v_new, int L, int R, int Tc, int D,    \
      int H, int F, int L_enc, int V, int Tpos, void* stream) {             \
    const void* wp[18] = {w_qkv, s_qkv, b_qkv, w_out, s_out, b_out,        \
                          w_cq,  s_cq,  b_cq,  w_co,  s_co,  b_co,         \
                          w_ff1, s_ff1, b_ff1, w_ff2, s_ff2, b_ff2};       \
    return launch<int8_t, CACHE>(prev, pos, emb, pos_emb, wp, ln, self_k,  \
                                 self_v, cross_k, cross_v, w_head, b_head,  \
                                 logits, nxt, logp, k_new, v_new, L, R, Tc, \
                                 D, H, F, L_enc, V, Tpos, stream);          \
  }

RAGGED_STEP_ENTRY(ragged_step_bf16, __nv_bfloat16)
RAGGED_STEP_ENTRY(ragged_step_f32, float)
RAGGED_STEP_I8_ENTRY(ragged_step_i8_bf16, __nv_bfloat16)
RAGGED_STEP_I8_ENTRY(ragged_step_i8_f32, float)
