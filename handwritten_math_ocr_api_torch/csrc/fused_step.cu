// One greedy decode step through every decoder layer, in one launch.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/fused_step.py::fused_decoder_layers_step_v2
// (_make_kernel_v2, the compute-only "v2" step). For each batch row b:
//   x = x_emb[b]                                  (float32 from here on)
//   every layer at slot pos (decoder_layers.cuh::run_layers)
//   x_out[b] = x
// with the TPU kernel's numerics (see decoder_layers.cuh). The caches are
// read only; the caller appends k_new and v_new.
//
// Bound on the H100: bytes. A step reads every decoder weight once (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512), the cross K/V and
// the cache prefix, and does about two flops per weight byte per row, far
// below the card's ~295 bf16 flops per byte. Design: the layers run in
// order inside one block per batch row, so nothing between sublayers
// leaves shared memory and the step is one launch instead of hundreds.
// Known weakness: a batch of 16 rows fills 16 of the card's 132 SMs and
// each block reads all weights through its own SM; the step runs some 50x
// above its byte bound, and what holds it (load latency or the block-wide
// barriers between sublayers) is not measured yet (keeping four weight
// rows' loads in flight per thread measured only 2% faster on an H100).
#include "decoder_layers.cuh"

namespace {

using decoder::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const T* __restrict__ x_emb, decoder::Weights<T> w,
                  const T* __restrict__ self_k, const T* __restrict__ self_v,
                  const T* __restrict__ cross_k,
                  const T* __restrict__ cross_v, float* __restrict__ x_out,
                  T* __restrict__ k_new, T* __restrict__ v_new, int L, int B,
                  int Tc, int D, int H, int F, int L_enc, int pos) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lstride = max(pos + 1, L_enc);
  const decoder::Smem s(smem, D, F, H, lstride);
  for (int d = threadIdx.x; d < D; d += kThreads)
    s.x[d] = to_f32(x_emb[static_cast<size_t>(b) * D + d]);
  __syncthreads();
  decoder::run_layers<T>(w, self_k, self_v, cross_k, cross_v, k_new, v_new,
                         L, B, b, Tc, D, H, F, L_enc, pos, lstride, s);
  for (int d = threadIdx.x; d < D; d += kThreads)
    x_out[static_cast<size_t>(b) * D + d] = s.x[d];
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
  const size_t lstride = static_cast<size_t>(std::max(pos + 1, L_enc));
  const size_t smem = decoder::smem_floats<T>(D, F, H, lstride) * sizeof(float);
  cudaError_t err = allow_smem(fused_step_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CT = const T*;
  using CF = const float*;
  const decoder::Weights<T> w{
      static_cast<CT>(w_qkv), static_cast<CF>(b_qkv), static_cast<CT>(w_out),
      static_cast<CF>(b_out), static_cast<CT>(w_cq), static_cast<CF>(b_cq),
      static_cast<CT>(w_co),  static_cast<CF>(b_co),  static_cast<CT>(w_ff1),
      static_cast<CF>(b_ff1), static_cast<CT>(w_ff2), static_cast<CF>(b_ff2),
      static_cast<CF>(ln)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_step_kernel<T><<<B, kThreads, smem, st>>>(
      static_cast<CT>(x_emb), w, static_cast<CT>(self_k),
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
