// B7's segment-ring entries (ragged_step.cuh has the kernel, Step's kRing
// in decoder_cluster.cuh the ring's attention): the bf16/float32 bundles and
// the int8 one, MHA and MQA. Replaces the ring mode of the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/fused_step.py::fused_ragged_step
// (_make_kernel_ragged with ring_s > 0), which decode/continuous.py's fused
// segments run at every step.
#include "ragged_step.cuh"

// The entries of ragged_step.cu plus, after cross_v, each row's segment
// start seg (R,) int32 and the ring K/V (L, R, S, kvd), and S after Tpos.
#define RAGGED_RING_ENTRY(NAME, TYPE)                                       \
  extern "C" int NAME(                                                      \
      const void* prev, const void* pos, const void* emb,                   \
      const void* pos_emb, const void* w_qkv, const void* b_qkv,            \
      const void* w_out, const void* b_out, const void* w_cq,               \
      const void* b_cq, const void* w_co, const void* b_co,                 \
      const void* w_ff1, const void* b_ff1, const void* w_ff2,              \
      const void* b_ff2, const void* ln, const void* self_k,                \
      const void* self_v, const void* cross_k, const void* cross_v,         \
      const void* seg, const void* ring_k, const void* ring_v,              \
      const void* w_head, const void* b_head, void* logits, void* nxt,      \
      void* logp, void* k_new, void* v_new, int L, int R, int Rr, int Tc,   \
      int D, int H, int Hkv, int F, int L_enc, int V, int Tpos, int S,      \
      void* stream) {                                                       \
    const void* wp[18] = {w_qkv, nullptr, b_qkv, w_out, nullptr, b_out,    \
                          w_cq,  nullptr, b_cq,  w_co,  nullptr, b_co,     \
                          w_ff1, nullptr, b_ff1, w_ff2, nullptr, b_ff2};   \
    const Args a{prev,   pos,     emb,     pos_emb, wp,     ln,    self_k, \
                 self_v, cross_k, cross_v, seg,     ring_k, ring_v,        \
                 w_head, b_head,  logits,  nxt,     logp,   k_new, v_new,  \
                 L,      R,       Rr,      Tc,      D,      H,     Hkv,    \
                 F,      L_enc,   V,       Tpos,    S};                    \
    return launch<TYPE, TYPE, true>(a, stream);                            \
  }

#define RAGGED_RING_I8_ENTRY(NAME, CACHE)                                   \
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
      const void* seg, const void* ring_k, const void* ring_v,              \
      const void* w_head, const void* b_head, void* logits, void* nxt,      \
      void* logp, void* k_new, void* v_new, int L, int R, int Rr, int Tc,   \
      int D, int H, int Hkv, int F, int L_enc, int V, int Tpos, int S,      \
      void* stream) {                                                       \
    const void* wp[18] = {w_qkv, s_qkv, b_qkv, w_out, s_out, b_out,        \
                          w_cq,  s_cq,  b_cq,  w_co,  s_co,  b_co,         \
                          w_ff1, s_ff1, b_ff1, w_ff2, s_ff2, b_ff2};       \
    const Args a{prev,   pos,     emb,     pos_emb, wp,     ln,    self_k, \
                 self_v, cross_k, cross_v, seg,     ring_k, ring_v,        \
                 w_head, b_head,  logits,  nxt,     logp,   k_new, v_new,  \
                 L,      R,       Rr,      Tc,      D,      H,     Hkv,    \
                 F,      L_enc,   V,       Tpos,    S};                    \
    return launch<int8_t, CACHE, true>(a, stream);                         \
  }

RAGGED_RING_ENTRY(ragged_ring_bf16, __nv_bfloat16)
RAGGED_RING_ENTRY(ragged_ring_f32, float)
RAGGED_RING_I8_ENTRY(ragged_ring_i8_bf16, __nv_bfloat16)
RAGGED_RING_I8_ENTRY(ragged_ring_i8_f32, float)
