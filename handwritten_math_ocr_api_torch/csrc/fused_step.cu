// One greedy decode step through every decoder layer, in one launch.
//
// Replaces two Pallas TPU kernels of
// handwritten_math_ocr_api_tpu/ops/fused_step.py:
// - fused_decoder_layers_step_v2 (_make_kernel_v2, B1, the compute-only
//   "v2" step): the caches are read only, the fresh K/V rows go to
//   (L, B, D) outputs that the caller appends;
// - fused_decoder_layers_step (_make_kernel, B11, the "v1" step): the same
//   layers, the fresh rows written into the caches at pos, in place (the
//   TPU kernel's aliased cache write-back).
// For each batch row b:
//   x = x_emb[b]                                  (float32 from here on)
//   every layer at slot pos (decoder_layers.cuh::run_layers)
//   x_out[b] = x
// with the TPU kernels' numerics (see decoder_layers.cuh). B1's entries:
// the bf16 and float32 bundles, and the int8 bundle ("v2q",
// quantize_stacked: int8 weights with per-column float32 scales, bf16
// matmul inputs) over bf16 or float32 caches. B11's: the bf16 and float32
// bundles (its TPU kernel would cast activations to int8 on an int8 one).
//
// Bound on the H100: bytes. A step reads every decoder weight once (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512; half in int8), the
// cross K/V and the cache prefix, and does about two flops per weight byte
// per row, far below the card's ~295 bf16 flops per byte. Design: the layers run in
// order inside one block per batch row, so nothing between sublayers
// leaves shared memory and the step is one launch instead of hundreds.
// B11 differs from B1 only in where the fresh rows go (FreshRows), so it
// writes 2 L B D elements into the caches and no whole-cache copy.
// Known weakness: a batch of 16 rows fills 16 of the card's 132 SMs and
// each block reads all weights through its own SM; the step runs some 50x
// above its byte bound, and what holds it (load latency or the block-wide
// barriers between sublayers) is not measured yet (keeping four weight
// rows' loads in flight per thread measured only 2% faster on an H100).
#include "decoder_layers.cuh"

namespace {

using decoder::kThreads;

template <typename W, typename C>
__global__ void __launch_bounds__(kThreads, 1)
fused_step_kernel(const C* __restrict__ x_emb, decoder::Weights<W> w,
                  const C* self_k, const C* self_v,
                  decoder::CacheLayout self, const C* __restrict__ cross_k,
                  const C* __restrict__ cross_v, float* __restrict__ x_out,
                  decoder::FreshRows<C> fresh, int L, int B, int D, int H,
                  int F, int L_enc, int pos) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lstride = max(pos + 1, L_enc);
  const decoder::Smem s(smem, D, F, H, lstride);
  for (int d = threadIdx.x; d < D; d += kThreads)
    s.x[d] = to_f32(x_emb[static_cast<size_t>(b) * D + d]);
  __syncthreads();
  decoder::run_layers<W, C>(w, self_k, self_v, self, cross_k, cross_v,
                            fresh, L, B, b, D, H, F, L_enc, pos, true,
                            lstride, s);
  for (int d = threadIdx.x; d < D; d += kThreads)
    x_out[static_cast<size_t>(b) * D + d] = s.x[d];
}

// wp: six (weight, scale, bias) triples, scale null for a float bundle.
// k_new and v_new null: B11, the fresh rows written into the caches.
template <typename W, typename C>
int launch(const void* x_emb, const void* const* wp, const void* ln,
           const void* self_k, const void* self_v, const void* cross_k,
           const void* cross_v, void* x_out, void* k_new, void* v_new, int L,
           int B, int Tc, int D, int H, int F, int L_enc, int pos,
           void* stream) {
  const size_t lstride = static_cast<size_t>(std::max(pos + 1, L_enc));
  const size_t smem =
      decoder::smem_floats<W>(D, F, H, lstride) * sizeof(float);
  cudaError_t err = allow_smem(fused_step_kernel<W, C>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CC = const C*;
  const decoder::CacheLayout self = decoder::batch_major(B, Tc, D);
  C* sk = static_cast<C*>(const_cast<void*>(self_k));
  C* sv = static_cast<C*>(const_cast<void*>(self_v));
  const decoder::FreshRows<C> fresh =
      k_new != nullptr ? decoder::rows_out<C>(k_new, v_new, B, D)
                       : decoder::rows_in_place<C>(sk, sv, self, pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_step_kernel<W, C><<<B, kThreads, smem, st>>>(
      static_cast<CC>(x_emb), decoder::make_weights<W>(wp, ln), sk, sv, self,
      static_cast<CC>(cross_k), static_cast<CC>(cross_v),
      static_cast<float*>(x_out), fresh, L, B, D, H, F, L_enc, pos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 and float32 bundles: six (weight, bias) pairs.
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
    const void* wp[18] = {w_qkv, nullptr, b_qkv, w_out, nullptr, b_out,    \
                          w_cq,  nullptr, b_cq,  w_co,  nullptr, b_co,     \
                          w_ff1, nullptr, b_ff1, w_ff2, nullptr, b_ff2};   \
    return launch<TYPE, TYPE>(x_emb, wp, ln, self_k, self_v, cross_k,      \
                              cross_v, x_out, k_new, v_new, L, B, Tc, D, H, \
                              F, L_enc, pos, stream);                       \
  }

// The int8 bundle: six (weight, scale, bias) triples; CACHE the cache and
// x_emb type.
#define FUSED_STEP_I8_ENTRY(NAME, CACHE)                                    \
  extern "C" int NAME(                                                      \
      const void* x_emb, const void* w_qkv, const void* s_qkv,              \
      const void* b_qkv, const void* w_out, const void* s_out,              \
      const void* b_out, const void* w_cq, const void* s_cq,                \
      const void* b_cq, const void* w_co, const void* s_co,                 \
      const void* b_co, const void* w_ff1, const void* s_ff1,               \
      const void* b_ff1, const void* w_ff2, const void* s_ff2,              \
      const void* b_ff2, const void* ln, const void* self_k,                \
      const void* self_v, const void* cross_k, const void* cross_v,         \
      void* x_out, void* k_new, void* v_new, int L, int B, int Tc, int D,   \
      int H, int F, int L_enc, int pos, void* stream) {                     \
    const void* wp[18] = {w_qkv, s_qkv, b_qkv, w_out, s_out, b_out,        \
                          w_cq,  s_cq,  b_cq,  w_co,  s_co,  b_co,         \
                          w_ff1, s_ff1, b_ff1, w_ff2, s_ff2, b_ff2};       \
    return launch<int8_t, CACHE>(x_emb, wp, ln, self_k, self_v, cross_k,   \
                                 cross_v, x_out, k_new, v_new, L, B, Tc, D, \
                                 H, F, L_enc, pos, stream);                 \
  }

// B11: the bf16 and float32 bundles, the fresh rows written into self_k and
// self_v at pos.
#define LAYERS_STEP_IN_PLACE_ENTRY(NAME, TYPE)                              \
  extern "C" int NAME(                                                      \
      const void* x_emb, const void* w_qkv, const void* b_qkv,              \
      const void* w_out, const void* b_out, const void* w_cq,               \
      const void* b_cq, const void* w_co, const void* b_co,                 \
      const void* w_ff1, const void* b_ff1, const void* w_ff2,              \
      const void* b_ff2, const void* ln, void* self_k, void* self_v,        \
      const void* cross_k, const void* cross_v, void* x_out, int L, int B,  \
      int Tc, int D, int H, int F, int L_enc, int pos, void* stream) {      \
    const void* wp[18] = {w_qkv, nullptr, b_qkv, w_out, nullptr, b_out,    \
                          w_cq,  nullptr, b_cq,  w_co,  nullptr, b_co,     \
                          w_ff1, nullptr, b_ff1, w_ff2, nullptr, b_ff2};   \
    return launch<TYPE, TYPE>(x_emb, wp, ln, self_k, self_v, cross_k,      \
                              cross_v, x_out, nullptr, nullptr, L, B, Tc,   \
                              D, H, F, L_enc, pos, stream);                 \
  }

FUSED_STEP_ENTRY(fused_decoder_step_bf16, __nv_bfloat16)
FUSED_STEP_ENTRY(fused_decoder_step_f32, float)
LAYERS_STEP_IN_PLACE_ENTRY(layers_step_in_place_bf16, __nv_bfloat16)
LAYERS_STEP_IN_PLACE_ENTRY(layers_step_in_place_f32, float)
FUSED_STEP_I8_ENTRY(fused_decoder_step_i8_bf16, __nv_bfloat16)
FUSED_STEP_I8_ENTRY(fused_decoder_step_i8_f32, float)
