// A whole greedy decode in one launch: every step's embedding, decoder
// layers, float32 head, argmax and the finished/EOS bookkeeping.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/whole_decode.py::fused_whole_decode
// (_make_kernel, B12, the "v5" decode; MHA; the bf16 or float32 bundle of
// build_stacked_full, or the int8 one of quantize_stacked). Batch row b
// starts from prev = sos_id and, for t = 0, 1, ...:
//   x = round(emb[prev] + pos_emb[min(t, Tpos - 1)])
//                                                 (float32 tables, the sum
//                                                  rounded to the compute
//                                                  type C and back; a step
//                                                  past the position table
//                                                  takes its last row)
//   every layer at slot t (decoder_cluster.cuh::Step::run), the fresh K/V
//   rows written into the row's self cache at slot t; attention takes the
//   fresh row in float32, unrounded (the TPU kernel's lnew = q * k_new and
//   p_new * v_new); only the stored row is rounded to C
//   logits = x W_head + b_head                    (float32)
//   tokens[b, t], logp = argmax, log(p_max + 1e-10)
//   lp += logp; cnt += (token != eos_id); prev = token
// until the row emits eos_id (that step counted in lp) or t reaches T_out.
// A row that has finished would go on emitting pad_id, fed eos_id, and add
// nothing to lp or cnt (the TPU kernel runs all T_out steps): so from its
// next step on it is a dead row of its group (it reads and writes no cache
// slot and its picks are dropped), its tokens are pad_id, and a group
// whose rows have all finished stops and fills the rest with pad_id. The
// outputs are the same; the self cache, which is not an output, is not
// written past a row's last step.
//
// The self cache is the caller's scratch (L, B, T_out, D) pair, batch-major.
// The TPU kernel's merged (L, T, B, 2D) cache, its prefix-bucket DMAs and
// its padding of the batch, L_enc and T to 16 rows are TPU tiling and are
// dropped.
//
// Bound on the H100: a decode reads the weights (about 10.5 MB of bf16 at
// 8 layers, d_model 256, FFN 512; half in int8) and the cross K/V once if
// they stay on chip (the TPU design's premise, which on the H100 is the
// 50 MB L2), writes every cache slot once, and its time is 150 dependent
// steps. Design: a persistent cluster decode on the layer code of
// decoder_cluster.cuh (Step<W, C, true>). Each thread-block cluster of
// kClusterBlocks blocks owns one group of rows (shaped by choose_shape for
// the last slot, T_out - 1, as B7: at 16 rows 8 clusters of 2) and loops
// over the steps itself: embed from its rows' previous picks, run, the
// head in argmax mode with every block's (max, first index, sum exp)
// triples pushed to every block so that each merges them alike and keeps
// the same decode state (the loop's exit is the same in every block), the
// bookkeeping, and the next step. Groups never depend on each other, so no
// grid-wide barrier is needed. The copy ring runs on over the steps: the
// next step's first weight segments are in flight during this step's
// head; the head's own weights stay resident in shared memory. Step t
// writes its fresh rows with generic stores and step t + 1 reads them by
// TMA (the async proxy): the writers fence (fence.proxy.async.global)
// before the barriers that order them with the next copies. The weights
// (10.5 MB) and the caches (24 MB at 16 rows) stay in the 50 MB L2 without
// a cache policy: an L2 evict_last policy on the weight copies and other
// row groups were no faster (kernel_ab.py decode, PERF.md).
// No fallback: a cluster shape the card cannot place is returned as an
// error, which the wrapper raises; a model the kernel does not split
// returns kRefused, which the wrapper raises as a ValueError.
#include "decoder_cluster.cuh"

namespace {

using cluster_step::kRefused;
using cluster_step::kThreads;
using cluster_step::Shape;

template <typename W, typename C>
__global__ void __launch_bounds__(kThreads, 1)
whole_decode_cluster_kernel(const float* __restrict__ emb,
                            const float* __restrict__ pos_emb,
                            decoder::Weights<W> w, C* self_k, C* self_v,
                            const C* __restrict__ cross_k,
                            const C* __restrict__ cross_v,
                            const float* __restrict__ w_head,
                            const float* __restrict__ b_head,
                            int* __restrict__ tokens,
                            float* __restrict__ lp_out,
                            int* __restrict__ cnt_out,
                            const __grid_constant__ cluster_step::Maps maps,
                            Shape s, int V, int Tpos, int sos_id,
                            int eos_id, int pad_id) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using Step = cluster_step::Step<W, C, true>;
  // the swizzled weight stages need a 1024-byte aligned base
  unsigned char* smem =
      smem_raw + ((1024 - (cluster_step::smem_u32(smem_raw) & 1023)) & 1023);
  const int row0 = static_cast<int>(blockIdx.x) / s.Cs * s.Mg;
  const int T_out = s.pos + 1;  // planned for the last slot
  const decoder::CacheLayout self = decoder::batch_major(s.B, T_out, s.D);
  Step step(w, self_k, self_v, self, cross_k, cross_v,
            decoder::rows_in_place<C>(self_k, self_v, self, 0), &maps, s,
            smem, row0);
  step.begin_decode(sos_id);
  step.with_head(w_head, b_head, V);
  step.start();
  step.embed(step.prev_tok(), emb, pos_emb, Tpos);
  step.cluster.sync();  // every block runs before any remote store
  int st = 0, ph = 0;  // the ring's stage and parity run on over the steps
  int t = 0;           // the steps taken
  for (bool live = true; live && t < T_out; ++t) {
    if (t > 0) {
      step.fresh.k += self.slot;  // slot t
      step.fresh.v += self.slot;
      step.embed(step.prev_tok(), emb, pos_emb, Tpos);
    }
    step.run(st, ph);
    live = step.pick(t, T_out, eos_id, pad_id, tokens);
  }
  step.drain(st, ph);
  if (step.rank == 0) {
    const int rest = T_out - t;  // every row's tokens after the last step
    for (int i = threadIdx.x; i < step.rows * rest; i += kThreads)
      tokens[static_cast<size_t>(row0 + i / rest) * T_out + t + i % rest] =
          pad_id;
    const int r = threadIdx.x;
    if (r < step.rows) {
      lp_out[row0 + r] = step.lp_sum()[r];
      cnt_out[row0 + r] = step.count()[r];
    }
  }
}

template <typename W, typename C>
const void* kernel_of() {
  return reinterpret_cast<const void*>(whole_decode_cluster_kernel<W, C>);
}

// wp: six (weight, scale, bias) triples, scale null for a float bundle.
template <typename W, typename C>
int launch(const void* emb, const void* pos_emb, const void* const* wp,
           const void* ln, void* self_k, void* self_v, const void* cross_k,
           const void* cross_v, const void* w_head, const void* b_head,
           void* tokens, void* lp, void* cnt, int L, int B, int T_out, int D,
           int H, int F, int L_enc, int V, int Tpos, int sos_id, int eos_id,
           int pad_id, void* stream) {
  const void* kernel = kernel_of<W, C>();
  const int hres = cluster_step::head_cols(V);
  // planned for the last slot: a group's rows reach it
  Shape s;
  cudaError_t err = cluster_step::choose_shape<W, C>(
      kernel, L, B, T_out, D, H, H, F, L_enc, T_out - 1, &s, hres);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.stages < 1 || !cluster_step::head_fits<W, C>(s, V)) return kRefused;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  err = cluster_step::configure<W, C>(
      kernel, s, cfg, attr, static_cast<cudaStream_t>(stream), &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // the self caches' maps span all T_out slots (every step's)
  cluster_step::Maps maps;
  err = cluster_step::make_maps<W, C>(s, T_out, T_out, true, wp, self_k,
                                      self_v, cross_k, cross_v, &maps);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CC = const C*;
  using CF = const float*;
  err = cudaLaunchKernelEx(
      &cfg, whole_decode_cluster_kernel<W, C>, static_cast<CF>(emb),
      static_cast<CF>(pos_emb), decoder::make_weights<W>(wp, ln),
      static_cast<C*>(self_k), static_cast<C*>(self_v),
      static_cast<CC>(cross_k), static_cast<CC>(cross_v),
      static_cast<CF>(w_head), static_cast<CF>(b_head),
      static_cast<int*>(tokens), static_cast<float*>(lp),
      static_cast<int*>(cnt), maps, s, V, Tpos, sos_id, eos_id, pad_id);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry returns 0, a cudaError, or kRefused (-1) for a model or batch
// the kernel does not take (make_shape, head_fits).
#define WHOLE_DECODE_TAIL                                                   \
  const void *ln, void *self_k, void *self_v, const void *cross_k,          \
      const void *cross_v, const void *w_head, const void *b_head,          \
      void *tokens, void *lp, void *cnt, int L, int B, int T_out, int D,    \
      int H, int F, int L_enc, int V, int Tpos, int sos_id, int eos_id,     \
      int pad_id, void *stream
#define WHOLE_DECODE_ARGS                                                   \
  emb, pos_emb, wp, ln, self_k, self_v, cross_k, cross_v, w_head, b_head,   \
      tokens, lp, cnt, L, B, T_out, D, H, F, L_enc, V, Tpos, sos_id,        \
      eos_id, pad_id, stream

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

// The kernel for the one geometry entry (cluster_geometry, fused_step.cu).
const void* cluster_step::whole_decode_kernel(bool int8, bool f32) {
  if (int8)
    return f32 ? kernel_of<int8_t, float>()
               : kernel_of<int8_t, __nv_bfloat16>();
  return f32 ? kernel_of<float, float>()
             : kernel_of<__nv_bfloat16, __nv_bfloat16>();
}
