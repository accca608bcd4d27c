// B7's entries without the segment ring (ragged_step.cuh has the kernel):
// the bf16/float32 bundles and the int8 one, MHA and MQA.
#include "ragged_step.cuh"

// Every entry returns 0, a cudaError, or kRefused (-1) for a model or batch
// the kernel does not take. logits is null for the argmax head (nxt, logp
// given), else nxt and logp are null. R is the caches' rows, Rr the rows
// computed (the first Rr). The bf16 and float32 bundles: six
// (weight, bias) pairs.
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
      void* logp, void* k_new, void* v_new, int L, int R, int Rr, int Tc,   \
      int D, int H, int Hkv, int F, int L_enc, int V, int Tpos,             \
      void* stream) {                                                       \
    const void* wp[18] = {w_qkv, nullptr, b_qkv, w_out, nullptr, b_out,    \
                          w_cq,  nullptr, b_cq,  w_co,  nullptr, b_co,     \
                          w_ff1, nullptr, b_ff1, w_ff2, nullptr, b_ff2};   \
    const Args a{prev,    pos,     emb,     pos_emb, wp,     ln,  self_k,  \
                 self_v,  cross_k, cross_v, nullptr, nullptr, nullptr,     \
                 w_head,  b_head,  logits,  nxt,     logp,   k_new, v_new, \
                 L,       R,       Rr,      Tc,      D,      H,   Hkv,     \
                 F,       L_enc,   V,       Tpos,    0};                   \
    return launch<TYPE, TYPE, false>(a, stream);                           \
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
      void* logp, void* k_new, void* v_new, int L, int R, int Rr, int Tc,   \
      int D, int H, int Hkv, int F, int L_enc, int V, int Tpos,             \
      void* stream) {                                                       \
    const void* wp[18] = {w_qkv, s_qkv, b_qkv, w_out, s_out, b_out,        \
                          w_cq,  s_cq,  b_cq,  w_co,  s_co,  b_co,         \
                          w_ff1, s_ff1, b_ff1, w_ff2, s_ff2, b_ff2};       \
    const Args a{prev,    pos,     emb,     pos_emb, wp,     ln,  self_k,  \
                 self_v,  cross_k, cross_v, nullptr, nullptr, nullptr,     \
                 w_head,  b_head,  logits,  nxt,     logp,   k_new, v_new, \
                 L,       R,       Rr,      Tc,      D,      H,   Hkv,     \
                 F,       L_enc,   V,       Tpos,    0};                   \
    return launch<int8_t, CACHE, false>(a, stream);                        \
  }

RAGGED_STEP_ENTRY(ragged_step_bf16, __nv_bfloat16)
RAGGED_STEP_ENTRY(ragged_step_f32, float)
RAGGED_STEP_I8_ENTRY(ragged_step_i8_bf16, __nv_bfloat16)
RAGGED_STEP_I8_ENTRY(ragged_step_i8_f32, float)

// The kernel for the one geometry entry (cluster_geometry, fused_step.cu):
// the non-ring kernel (the ring kernel's rows' segment starts take 64 more
// bytes of shared memory, 16 ints, which can cost it one staged slot).
const void* cluster_step::ragged_step_kernel(bool int8, bool f32, bool mqa) {
  return mqa ? kernel_for<true, false>(int8, f32)
             : kernel_for<false, false>(int8, f32);
}
