// One whole decode step for R rows, each at its own position, in one launch.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/fused_step.py::fused_ragged_step
// (_make_kernel_ragged, no ring; the bf16/float32 bundle, or the int8 one
// with bf16 matmul inputs; MHA self caches (L, R, T, D), or MQA's of the
// TPU kernel's kv_dim, one KV head: (L, R, T, dh), a kernel of its own,
// kMqa). For row r:
//   x = round(emb[prev[r]] + pos_emb[pos[r]])     (float32 tables, the sum
//                                                  rounded to the compute
//                                                  type C and back)
//   every layer at slot pos[r]                    (decoder_cluster.cuh)
//   logits = x W_head + b_head                    (float32)
// and then either the (V,) float32 logits of the row (return_logits, what
// beam search ranks) or its argmax (the first index of the max) and
// log(p_max + 1e-10), the reference's confidence numerics. prev and pos are
// int32 tensors in device memory, so a step needs no host value. A row
// whose prev or pos is out of range gets NaN outputs (nxt -1), reads
// nothing, and leaves the other rows of its group as they are.
//
// Bound on the H100: bytes. A step reads every decoder weight once (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512; half in int8) plus
// the float32 head (141 KB at vocab 138), each row's cross K/V and its
// cache prefix, and does about two flops per weight byte per row, far
// below the card's ~295 bf16 flops per byte. Design: B1's cluster layer
// code (decoder_cluster.cuh): the rows go in groups, one thread-block
// cluster of kClusterBlocks blocks a group (at beam 5 x batch 10, 50 rows:
// 13 clusters of 4 rows), each block computing its columns of every
// product for all the group's rows on the tensor cores, so each weight
// byte is read once a group, its next weight columns and its attention
// items' cache slots arriving by TMA while it computes. What B7 adds:
// - a position per row: each row attends its own slots [0, pos[r]) and
//   its fresh row at pos[r] (Step::positions); the host plans the launch
//   for the last slot (Tc - 1) and its self-cache maps span all Tc slots,
//   so an item's staged box may hold slots past the row's horizon, which
//   are never read (they may hold anything, NaN included);
// - the embedding in the prologue (Step::embed): each block forms its
//   group's rows from the float32 tables;
// - the float32 head in the epilogue (Step::head): each block computes
//   its ceil(V / Cs) columns from a segment of w_head that lands in a ring
//   stage while the last sublayer computes, and either writes them or
//   reduces them to a (max, first index, sum exp) triple a row that block
//   0 merges after one more cluster barrier.
// No fallback: a cluster shape the card cannot place is returned as an
// error, which the wrapper raises; a model the kernel does not split
// returns kRefused, which the wrapper raises as a ValueError.
#include "decoder_cluster.cuh"

namespace {

using cluster_step::kRefused;
using cluster_step::kThreads;
using cluster_step::Shape;

template <typename W, typename C, bool kMqa>
__global__ void __launch_bounds__(kThreads, 1)
ragged_step_cluster_kernel(const int* __restrict__ prev,
                           const int* __restrict__ pos,
                           const float* __restrict__ emb,
                           const float* __restrict__ pos_emb,
                           decoder::Weights<W> w, const C* self_k,
                           const C* self_v, decoder::CacheLayout self,
                           const C* __restrict__ cross_k,
                           const C* __restrict__ cross_v,
                           const float* __restrict__ w_head,
                           const float* __restrict__ b_head,
                           float* __restrict__ logits, int* __restrict__ nxt,
                           float* __restrict__ logp,
                           decoder::FreshRows<C> fresh,
                           const __grid_constant__ cluster_step::Maps maps,
                           Shape s, int Tc, int V, int Tpos) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using Step = cluster_step::Step<W, C, false, kMqa>;
  // the swizzled weight stages need a 1024-byte aligned base
  unsigned char* smem =
      smem_raw + ((1024 - (cluster_step::smem_u32(smem_raw) & 1023)) & 1023);
  const int row0 = static_cast<int>(blockIdx.x) / s.Cs * s.Mg;
  Step step(w, self_k, self_v, self, cross_k, cross_v, fresh, &maps, s,
            smem, row0);
  step.positions(pos, prev, Tc, Tpos, V);
  step.with_head(w_head, b_head, V);
  step.start();
  step.embed(prev + row0, emb, pos_emb);
  step.cluster.sync();  // every block runs before any remote store
  step.run();
  step.head(logits, nxt, logp);
}

template <typename W, typename C, bool kMqa>
const void* kernel_of() {
  return reinterpret_cast<const void*>(ragged_step_cluster_kernel<W, C, kMqa>);
}

// wp: six (weight, scale, bias) triples, scale null for a float bundle.
template <typename W, typename C, bool kMqa>
int launch_kernel(const void* prev, const void* pos, const void* emb,
                  const void* pos_emb, const void* const* wp, const void* ln,
                  const void* self_k, const void* self_v,
                  const void* cross_k, const void* cross_v,
                  const void* w_head, const void* b_head, void* logits,
                  void* nxt, void* logp, void* k_new, void* v_new, int L,
                  int R, int Tc, int D, int H, int Hkv, int F, int L_enc,
                  int V, int Tpos, void* stream) {
  const void* kernel = kernel_of<W, C, kMqa>();
  // planned for the last slot: any row may be there
  Shape s;
  cudaError_t err = cluster_step::choose_shape<W, C>(
      kernel, L, R, Tc, D, H, Hkv, F, L_enc, Tc - 1, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.stages < 1 || !cluster_step::head_fits<W, C>(s, V)) return kRefused;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  err = cluster_step::configure<W, C>(
      kernel, s, cfg, attr, static_cast<cudaStream_t>(stream), &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // the self caches' maps span all Tc slots (the same for every step)
  cluster_step::Maps maps;
  err = cluster_step::make_maps<W, C>(s, Tc, Tc, true, wp, self_k, self_v,
                                      cross_k, cross_v, &maps);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CC = const C*;
  using CF = const float*;
  using CI = const int*;
  const int kvd = Hkv * (D / H);  // the self caches' lanes
  err = cudaLaunchKernelEx(
      &cfg, ragged_step_cluster_kernel<W, C, kMqa>, static_cast<CI>(prev),
      static_cast<CI>(pos), static_cast<CF>(emb), static_cast<CF>(pos_emb),
      decoder::make_weights<W>(wp, ln), static_cast<CC>(self_k),
      static_cast<CC>(self_v), decoder::batch_major(R, Tc, kvd),
      static_cast<CC>(cross_k), static_cast<CC>(cross_v),
      static_cast<CF>(w_head), static_cast<CF>(b_head),
      static_cast<float*>(logits), static_cast<int*>(nxt),
      static_cast<float*>(logp), decoder::rows_out<C>(k_new, v_new, R, kvd),
      maps, s, Tc, V, Tpos);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The MHA kernel where Hkv == H, else the MQA one (its shape refuses any
// Hkv but 1).
template <typename W, typename C>
int launch(const void* prev, const void* pos, const void* emb,
           const void* pos_emb, const void* const* wp, const void* ln,
           const void* self_k, const void* self_v, const void* cross_k,
           const void* cross_v, const void* w_head, const void* b_head,
           void* logits, void* nxt, void* logp, void* k_new, void* v_new,
           int L, int R, int Tc, int D, int H, int Hkv, int F, int L_enc,
           int V, int Tpos, void* stream) {
  return (Hkv == H ? launch_kernel<W, C, false> : launch_kernel<W, C, true>)(
      prev, pos, emb, pos_emb, wp, ln, self_k, self_v, cross_k, cross_v,
      w_head, b_head, logits, nxt, logp, k_new, v_new, L, R, Tc, D, H, Hkv,
      F, L_enc, V, Tpos, stream);
}

}  // namespace

// Every entry returns 0, a cudaError, or kRefused (-1) for a model or batch
// the kernel does not take. logits is null for the argmax head (nxt, logp
// given), else nxt and logp are null. The bf16 and float32 bundles: six
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
      void* logp, void* k_new, void* v_new, int L, int R, int Tc, int D,    \
      int H, int Hkv, int F, int L_enc, int V, int Tpos, void* stream) {    \
    const void* wp[18] = {w_qkv, nullptr, b_qkv, w_out, nullptr, b_out,    \
                          w_cq,  nullptr, b_cq,  w_co,  nullptr, b_co,     \
                          w_ff1, nullptr, b_ff1, w_ff2, nullptr, b_ff2};   \
    return launch<TYPE, TYPE>(prev, pos, emb, pos_emb, wp, ln, self_k,     \
                              self_v, cross_k, cross_v, w_head, b_head,     \
                              logits, nxt, logp, k_new, v_new, L, R, Tc, D, \
                              H, Hkv, F, L_enc, V, Tpos, stream);           \
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
      int H, int Hkv, int F, int L_enc, int V, int Tpos, void* stream) {    \
    const void* wp[18] = {w_qkv, s_qkv, b_qkv, w_out, s_out, b_out,        \
                          w_cq,  s_cq,  b_cq,  w_co,  s_co,  b_co,         \
                          w_ff1, s_ff1, b_ff1, w_ff2, s_ff2, b_ff2};       \
    return launch<int8_t, CACHE>(prev, pos, emb, pos_emb, wp, ln, self_k,  \
                                 self_v, cross_k, cross_v, w_head, b_head,  \
                                 logits, nxt, logp, k_new, v_new, L, R, Tc, \
                                 D, H, Hkv, F, L_enc, V, Tpos, stream);     \
  }

RAGGED_STEP_ENTRY(ragged_step_bf16, __nv_bfloat16)
RAGGED_STEP_ENTRY(ragged_step_f32, float)
RAGGED_STEP_I8_ENTRY(ragged_step_i8_bf16, __nv_bfloat16)
RAGGED_STEP_I8_ENTRY(ragged_step_i8_f32, float)

// The kernel for the one geometry entry (cluster_geometry, fused_step.cu).
template <bool kMqa>
const void* kernel_for(bool int8, bool f32) {
  if (int8)
    return f32 ? kernel_of<int8_t, float, kMqa>()
               : kernel_of<int8_t, __nv_bfloat16, kMqa>();
  return f32 ? kernel_of<float, float, kMqa>()
             : kernel_of<__nv_bfloat16, __nv_bfloat16, kMqa>();
}

const void* cluster_step::ragged_step_kernel(bool int8, bool f32, bool mqa) {
  return mqa ? kernel_for<true>(int8, f32) : kernel_for<false>(int8, f32);
}
