// A whole greedy decode in one launch: every step's embedding, decoder
// layers, float32 head, argmax and the finished/EOS bookkeeping.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/whole_decode.py::fused_whole_decode
// (_make_kernel, B12, the "v5" decode; MHA; the bf16 or float32 bundle of
// build_stacked_full, or the int8 one of quantize_stacked). Batch row b
// starts from prev = sos_id and, for t = 0, 1, ...:
//   x = round(emb[prev] + pos_emb[t])             (float32 tables, the sum
//                                                  rounded to the compute
//                                                  type C and back)
//   every layer at slot t (decoder_layers.cuh::run_layers), the fresh K/V
//   rows written into the row's self cache at slot t; attention takes the
//   fresh row in float32, unrounded (the TPU kernel's lnew = q * k_new and
//   p_new * v_new); only the stored row is rounded to C
//   logits = x W_head + b_head                    (float32)
//   tokens[b, t], logp = argmax, log(p_max + 1e-10)
//   lp += logp; cnt += (token != eos_id); prev = token
// until the row emits eos_id (that step counted in lp) or t reaches T_out.
// A row that has finished would go on emitting pad_id, fed eos_id, and add
// nothing to lp or cnt (the TPU kernel runs all T_out steps): so its block
// stops there and fills the rest of its tokens with pad_id. The outputs
// are the same; the self cache, which is not an output, is not written
// past the row's last step.
//
// The self cache is the caller's scratch (L, B, T_out, D) pair, batch-major:
// row b's slots are contiguous, and only its block reads or writes them,
// so the __syncthreads() between a step's write of slot t and the next
// step's read of it is all the ordering needed (no grid-wide barrier).
// The TPU kernel's merged (L, T, B, 2D) cache, its prefix-bucket DMAs and
// its padding of the batch, L_enc and T to 16 rows are TPU tiling and are
// dropped.
//
// Bound on the H100: bytes. Every step reads every decoder weight (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512; half in int8), the
// head, the row's cross K/V and its cache prefix. The TPU design's premise
// is that the weights are read from device memory once a decode and stay
// resident on chip; counted so, the decode's bytes are the weights and
// the cross K/V once plus every self-cache slot read over the steps.
// Design: the one-block-a-row step of decoder_layers.cuh, looped in the
// block; each block reads the weights through its own SM every step (from
// L2 after the first block), so the kernel stays far above that bound.
#include "decoder_layers.cuh"

namespace {

using decoder::kThreads;

template <typename W, typename C>
__global__ void __launch_bounds__(kThreads, 1)
whole_decode_kernel(const float* __restrict__ emb,
                    const float* __restrict__ pos_emb, decoder::Weights<W> w,
                    C* self_k, C* self_v, const C* __restrict__ cross_k,
                    const C* __restrict__ cross_v,
                    const float* __restrict__ w_head,
                    const float* __restrict__ b_head,
                    int* __restrict__ tokens, float* __restrict__ lp_out,
                    int* __restrict__ cnt_out, int L, int B, int T_out,
                    int D, int H, int F, int L_enc, int V, int sos_id,
                    int eos_id, int pad_id) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lstride = max(T_out, L_enc);
  const decoder::Smem s(smem, D, F, H, lstride);
  float* hy = s.red + decoder::red_floats<W>(D, F);  // V head outputs
  float* hred = hy + V;                               // max(kThreads, V)
  const decoder::CacheLayout self = decoder::batch_major(B, T_out, D);
  int* row_tokens = tokens + static_cast<size_t>(b) * T_out;

  // every thread holds the same prev, lp and cnt: each pick is computed
  // alike in every thread, so the loop's exit is uniform over the block
  int prev = sos_id, cnt = 0, t = 0;
  float lp = 0.0f;
  while (t < T_out) {
    for (int d = threadIdx.x; d < D; d += kThreads)
      s.x[d] = round_to<C>(emb[static_cast<size_t>(prev) * D + d] +
                           pos_emb[static_cast<size_t>(t) * D + d]);
    __syncthreads();
    decoder::run_layers<W, C>(w, self_k, self_v, self, cross_k, cross_v,
                              decoder::rows_in_place<C>(self_k, self_v,
                                                        self, t),
                              L, B, b, D, H, F, L_enc, t, false, lstride, s);
    decoder::head(s.x, w_head, b_head, hy, D, V, hred);
    const decoder::Pick pick = decoder::argmax_logp(hy, V, s.scratch);
    if (threadIdx.x == 0) row_tokens[t] = pick.index;
    lp += pick.logp;
    ++t;
    if (pick.index == eos_id) break;
    ++cnt;
    prev = pick.index;
  }
  for (int i = t + threadIdx.x; i < T_out; i += kThreads)
    row_tokens[i] = pad_id;
  if (threadIdx.x == 0) {
    lp_out[b] = lp;
    cnt_out[b] = cnt;
  }
}

// wp: six (weight, scale, bias) triples, scale null for a float bundle.
template <typename W, typename C>
int launch(const void* emb, const void* pos_emb, const void* const* wp,
           const void* ln, void* self_k, void* self_v, const void* cross_k,
           const void* cross_v, const void* w_head, const void* b_head,
           void* tokens, void* lp, void* cnt, int L, int B, int T_out, int D,
           int H, int F, int L_enc, int V, int sos_id, int eos_id,
           int pad_id, void* stream) {
  const size_t lstride = static_cast<size_t>(std::max(T_out, L_enc));
  const size_t floats =
      decoder::smem_floats<W>(D, F, H, lstride) + decoder::head_floats(V);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = allow_smem(whole_decode_kernel<W, C>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CC = const C*;
  using CF = const float*;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  whole_decode_kernel<W, C><<<B, kThreads, smem, st>>>(
      static_cast<CF>(emb), static_cast<CF>(pos_emb),
      decoder::make_weights<W>(wp, ln), static_cast<C*>(self_k),
      static_cast<C*>(self_v), static_cast<CC>(cross_k),
      static_cast<CC>(cross_v), static_cast<CF>(w_head),
      static_cast<CF>(b_head), static_cast<int*>(tokens),
      static_cast<float*>(lp), static_cast<int*>(cnt), L, B, T_out, D, H, F,
      L_enc, V, sos_id, eos_id, pad_id);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define WHOLE_DECODE_TAIL                                                   \
  const void *ln, void *self_k, void *self_v, const void *cross_k,          \
      const void *cross_v, const void *w_head, const void *b_head,          \
      void *tokens, void *lp, void *cnt, int L, int B, int T_out, int D,    \
      int H, int F, int L_enc, int V, int sos_id, int eos_id, int pad_id,   \
      void *stream
#define WHOLE_DECODE_ARGS                                                   \
  emb, pos_emb, wp, ln, self_k, self_v, cross_k, cross_v, w_head, b_head,   \
      tokens, lp, cnt, L, B, T_out, D, H, F, L_enc, V, sos_id, eos_id,      \
      pad_id, stream

// The bf16 and float32 bundles: six (weight, bias) pairs.
#define WHOLE_DECODE_ENTRY(NAME, TYPE)                                      \
  extern "C" int NAME(                                                      \
      const void* emb, const void* pos_emb, const void* w_qkv,              \
      const void* b_qkv, const void* w_out, const void* b_out,              \
      const void* w_cq, const void* b_cq, const void* w_co,                 \
      const void* b_co, const void* w_ff1, const void* b_ff1,               \
      const void* w_ff2, const void* b_ff2, WHOLE_DECODE_TAIL) {            \
    const void* wp[18] = {w_qkv, nullptr, b_qkv, w_out, nullptr, b_out,    \
                          w_cq,  nullptr, b_cq,  w_co,  nullptr, b_co,     \
                          w_ff1, nullptr, b_ff1, w_ff2, nullptr, b_ff2};   \
    return launch<TYPE, TYPE>(WHOLE_DECODE_ARGS);                           \
  }

// The int8 bundle: six (weight, scale, bias) triples; CACHE the cache
// type (the model's compute dtype).
#define WHOLE_DECODE_I8_ENTRY(NAME, CACHE)                                  \
  extern "C" int NAME(                                                      \
      const void* emb, const void* pos_emb, const void* w_qkv,              \
      const void* s_qkv, const void* b_qkv, const void* w_out,              \
      const void* s_out, const void* b_out, const void* w_cq,               \
      const void* s_cq, const void* b_cq, const void* w_co,                 \
      const void* s_co, const void* b_co, const void* w_ff1,                \
      const void* s_ff1, const void* b_ff1, const void* w_ff2,              \
      const void* s_ff2, const void* b_ff2, WHOLE_DECODE_TAIL) {            \
    const void* wp[18] = {w_qkv, s_qkv, b_qkv, w_out, s_out, b_out,        \
                          w_cq,  s_cq,  b_cq,  w_co,  s_co,  b_co,         \
                          w_ff1, s_ff1, b_ff1, w_ff2, s_ff2, b_ff2};       \
    return launch<int8_t, CACHE>(WHOLE_DECODE_ARGS);                        \
  }

WHOLE_DECODE_ENTRY(whole_decode_bf16, __nv_bfloat16)
WHOLE_DECODE_ENTRY(whole_decode_f32, float)
WHOLE_DECODE_I8_ENTRY(whole_decode_i8_bf16, __nv_bfloat16)
WHOLE_DECODE_I8_ENTRY(whole_decode_i8_f32, float)
