// One whole greedy decode step for the batch, in one launch: the embedding,
// every decoder layer, the float32 head and its argmax.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/fused_step.py::fused_whole_step
// (_make_kernel_v4, B10; MHA, the bf16 or float32 bundle of
// build_stacked_full). For batch row b at the step's position pos:
//   x = round(emb[prev[b]] + pos_emb[min(pos, Tpos - 1)])
//                                                 (float32 tables, the sum
//                                                  rounded to the compute
//                                                  type C and back; a step
//                                                  past the position table
//                                                  takes its last row)
//   every layer at slot pos (decoder_cluster.cuh::Step::run)
//   logits = x W_head + b_head                    (float32)
//   nxt[b], logp[b] = argmax (the first index of the max),
//                     log(p_max + 1e-10)
// Two layouts of the self cache, an entry each:
// - "v4", time-major (L, T, B, D): the fresh K/V rows are written into the
//   caches at pos, in place (the TPU kernel's aliased single-row writes);
// - "v3", batch-major (L, B, T, D), read only: the fresh rows go to
//   (L, B, D) outputs that the caller appends.
// prev is an int32 tensor in device memory (a step needs no host value);
// pos comes by value. A row whose prev lies outside the vocabulary gets
// nxt -1, logp NaN and NaN fresh rows (in "v4" at slot pos; no other slot
// is touched), and leaves the other rows of its group as they are.
//
// Bound on the H100: bytes. A step reads every decoder weight once (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512) plus the float32
// head (141 KB at vocab 138), the cross K/V and the cache prefix, and does
// about two flops per weight byte per row. Design: B7's kernel
// (ragged_step.cu) at one position for the launch, on the cluster layer
// code of decoder_cluster.cuh: the rows go in groups, one thread-block
// cluster of kClusterBlocks blocks a group (at 16 rows: 8 clusters of 2),
// each block computing its columns of every product for all the group's
// rows on the tensor cores, so each weight byte is read once a group; the
// embedding in the prologue (Step::embed), the head in the epilogue
// (Step::head, argmax mode: a (max, first index, sum exp) triple a row and
// block that block 0 merges). The host plans the launch at pos, as B1
// (fused_step.cu): the self caches' maps end at slot pos, so a stage's
// boxes never hold the slot that "v4" writes. The TPU kernel's one-hot
// matmuls for the embedding and the position row become two loads, and its
// vocabulary padding to 128 lanes (a -1e9 bias) is dropped: the head
// computes exactly V columns.
// No fallback: a cluster shape the card cannot place is returned as an
// error, which the wrapper raises; a model the kernel does not split
// returns kRefused, which the wrapper raises as a ValueError.
#include <algorithm>

#include "decoder_cluster.cuh"

namespace {

using cluster_step::kRefused;
using cluster_step::kThreads;
using cluster_step::Shape;

template <typename C>
__global__ void __launch_bounds__(kThreads, 1)
whole_step_cluster_kernel(const int* __restrict__ prev,
                          const float* __restrict__ emb,
                          const float* __restrict__ pos_emb,
                          decoder::Weights<C> w, const C* self_k,
                          const C* self_v, decoder::CacheLayout self,
                          const C* __restrict__ cross_k,
                          const C* __restrict__ cross_v,
                          const float* __restrict__ w_head,
                          const float* __restrict__ b_head,
                          int* __restrict__ nxt, float* __restrict__ logp,
                          decoder::FreshRows<C> fresh,
                          const __grid_constant__ cluster_step::Maps maps,
                          Shape s, int V, int Tpos) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using Step = cluster_step::Step<C, C>;
  // the swizzled weight stages need a 1024-byte aligned base
  unsigned char* smem =
      smem_raw + ((1024 - (cluster_step::smem_u32(smem_raw) & 1023)) & 1023);
  const int row0 = static_cast<int>(blockIdx.x) / s.Cs * s.Mg;
  Step step(w, self_k, self_v, self, cross_k, cross_v, fresh, &maps, s,
            smem, row0);
  // every row at s.pos (checked by the host), dead if its prev is not a
  // token
  step.positions(nullptr, prev, s.pos + 1, V);
  step.with_head(w_head, b_head, V);
  step.start();
  step.embed(prev + row0, emb, pos_emb, Tpos);
  step.cluster.sync();  // every block runs before any remote store
  step.run();
  step.head(nullptr, nxt, logp);
}

template <typename C>
const void* kernel_of() {
  return reinterpret_cast<const void*>(whole_step_cluster_kernel<C>);
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
           int F, int L_enc, int V, int Tpos, int pos, void* stream) {
  const void* kernel = kernel_of<C>();
  Shape s;
  const bool in_place = k_new == nullptr;
  cudaError_t err = cluster_step::choose_shape<C, C>(
      kernel, L, B, Tc, D, H, H, F, L_enc, pos, &s, 0, in_place ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.stages < 1 || !cluster_step::head_fits<C, C>(s, V)) return kRefused;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  err = cluster_step::configure<C, C>(
      kernel, s, cfg, attr, static_cast<cudaStream_t>(stream), &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // the self caches' map ends at slot pos (encoded for this launch)
  cluster_step::Maps maps;
  err = cluster_step::make_maps<C, C>(s, Tc, std::max(pos, 1), false, wp,
                                      self_k, self_v, cross_k, cross_v,
                                      &maps);
  if (err != cudaSuccess) return static_cast<int>(err);
  C* sk = static_cast<C*>(self_k);
  C* sv = static_cast<C*>(self_v);
  const decoder::CacheLayout self = in_place
                                        ? decoder::time_major(B, Tc, D)
                                        : decoder::batch_major(B, Tc, D);
  const decoder::FreshRows<C> fresh =
      in_place ? decoder::rows_in_place<C>(sk, sv, self, pos)
               : decoder::rows_out<C>(k_new, v_new, B, D);
  using CC = const C*;
  using CF = const float*;
  err = cudaLaunchKernelEx(
      &cfg, whole_step_cluster_kernel<C>, static_cast<const int*>(prev),
      static_cast<CF>(emb), static_cast<CF>(pos_emb),
      decoder::make_weights<C>(wp, ln), static_cast<CC>(sk),
      static_cast<CC>(sv), self, static_cast<CC>(cross_k),
      static_cast<CC>(cross_v), static_cast<CF>(w_head),
      static_cast<CF>(b_head), static_cast<int*>(nxt),
      static_cast<float*>(logp), fresh, maps, s, V, Tpos);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry returns 0, a cudaError, or kRefused (-1) for a model or batch
// the kernel does not take (make_shape, head_fits).
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
                      int Tpos, int pos, void* stream) {                    \
    WHOLE_STEP_WP;                                                          \
    return launch<TYPE>(prev, emb, pos_emb, wp, ln, self_k, self_v,        \
                        cross_k, cross_v, w_head, b_head, nxt, logp,        \
                        nullptr, nullptr, L, B, Tc, D, H, F, L_enc, V,      \
                        Tpos, pos, stream);                                 \
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
                      int Tpos, int pos, void* stream) {                    \
    WHOLE_STEP_WP;                                                          \
    return launch<TYPE>(prev, emb, pos_emb, wp, ln,                        \
                        const_cast<void*>(self_k),                          \
                        const_cast<void*>(self_v), cross_k, cross_v,        \
                        w_head, b_head, nxt, logp, k_new, v_new, L, B, Tc,  \
                        D, H, F, L_enc, V, Tpos, pos, stream);              \
  }

WHOLE_STEP_TIME_MAJOR_ENTRY(whole_step_time_major_bf16, __nv_bfloat16)
WHOLE_STEP_TIME_MAJOR_ENTRY(whole_step_time_major_f32, float)
WHOLE_STEP_ROWS_ENTRY(whole_step_rows_bf16, __nv_bfloat16)
WHOLE_STEP_ROWS_ENTRY(whole_step_rows_f32, float)

// The kernel for the one geometry entry (cluster_geometry, fused_step.cu):
// float bundles only.
const void* cluster_step::whole_step_kernel(bool int8, bool f32) {
  if (int8) return nullptr;
  return f32 ? kernel_of<float>() : kernel_of<__nv_bfloat16>();
}
