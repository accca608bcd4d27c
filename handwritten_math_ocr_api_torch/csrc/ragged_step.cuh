// One whole decode step for R rows, each at its own position, in one launch:
// the kernel and its launch, for ragged_step.cu and ragged_ring.cu.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/fused_step.py::fused_ragged_step
// (_make_kernel_ragged; the bf16/float32 bundle, or the int8 one with bf16
// matmul inputs; MHA self caches (L, R, T, D), or MQA's of the TPU kernel's
// kv_dim, one KV head: (L, R, T, dh), a kernel of its own, kMqa; and its
// segment-ring mode, kernels of their own, kRing, whose entries are in
// ragged_ring.cu, the others' in ragged_step.cu: two files, so that nvcc
// builds them in parallel). For row r:
//   x = round(emb[prev[r]] + pos_emb[min(pos[r], Tpos - 1)])
//                                                 (float32 tables, the sum
//                                                  rounded to the compute
//                                                  type C and back; a slot
//                                                  past the position table
//                                                  takes its last row)
//   every layer at slot pos[r]                    (decoder_cluster.cuh)
//   logits = x W_head + b_head                    (float32)
// and then either the (V,) float32 logits of the row (return_logits, what
// beam search ranks) or its argmax (the first index of the max) and
// log(p_max + 1e-10), the reference's confidence numerics. prev and pos are
// int32 tensors in device memory, so a step needs no host value. A row
// whose prev lies outside the vocabulary or whose pos lies outside the
// cache gets NaN outputs (nxt -1), reads nothing, and leaves the other rows
// of its group as they are.
//
// Ring mode (decode/continuous.py's segment ring): each row also has a
// segment start seg[r] (int32, device memory) and the ring K/V
// (L, R, S, kvd) of the segment's earlier steps; row r attends its cache
// slots [0, seg[r]), ring rows 0 .. pos[r] - seg[r] - 1 for the slots
// [seg[r], pos[r]) and its fresh row at pos[r], one softmax over all three
// (Step's kRing). A row whose seg[r] lies outside [pos[r] - (S - 1),
// pos[r]] is dead as above.
//
// Run rows (the TPU kernel's n_chunks): a launch computes the first Rr of
// the R rows whose caches it is given (Shape::B the run rows, Shape::pool
// the caches' rows, the strides); the outputs of rows Rr .. R - 1 are not
// written.
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
#pragma once

#include "decoder_cluster.cuh"

namespace {

using cluster_step::kRefused;
using cluster_step::kThreads;
using cluster_step::Shape;

template <typename W, typename C, bool kMqa, bool kRing>
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
                           decoder::SegmentRing<C> ring,
                           const __grid_constant__ cluster_step::Maps maps,
                           Shape s, int Tc, int V, int Tpos) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using Step = cluster_step::Step<W, C, false, kMqa, kRing>;
  // the swizzled weight stages need a 1024-byte aligned base
  unsigned char* smem =
      smem_raw + ((1024 - (cluster_step::smem_u32(smem_raw) & 1023)) & 1023);
  const int row0 = static_cast<int>(blockIdx.x) / s.Cs * s.Mg;
  Step step(w, self_k, self_v, self, cross_k, cross_v, fresh, &maps, s,
            smem, row0);
  if constexpr (kRing) step.with_ring(ring);
  step.positions(pos, prev, Tc, V);
  step.with_head(w_head, b_head, V);
  step.start();
  step.embed(prev + row0, emb, pos_emb, Tpos);
  step.cluster.sync();  // every block runs before any remote store
  step.run();
  step.head(logits, nxt, logp);
}

template <typename W, typename C, bool kMqa, bool kRing>
const void* kernel_of() {
  return reinterpret_cast<const void*>(
      ragged_step_cluster_kernel<W, C, kMqa, kRing>);
}

// The operands of a launch: wp six (weight, scale, bias) triples, scale
// null for a float bundle; seg, ring_k and ring_v null without kRing.
struct Args {
  const void *prev, *pos, *emb, *pos_emb;
  const void* const* wp;
  const void *ln, *self_k, *self_v, *cross_k, *cross_v, *seg, *ring_k,
      *ring_v, *w_head, *b_head;
  void *logits, *nxt, *logp, *k_new, *v_new;
  int L, R, Rr, Tc, D, H, Hkv, F, L_enc, V, Tpos, S;
};

template <typename W, typename C, bool kMqa, bool kRing>
int launch_kernel(const Args& a, void* stream) {
  if (a.Rr < 1 || a.Rr > a.R || (kRing && a.S < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = kernel_of<W, C, kMqa, kRing>();
  // planned for the last slot (any row may be there) over the run rows
  Shape s;
  cudaError_t err = cluster_step::choose_shape<W, C>(
      kernel, a.L, a.Rr, a.Tc, a.D, a.H, a.Hkv, a.F, a.L_enc, a.Tc - 1, &s,
      0, 0, kRing ? a.S : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.stages < 1 || !cluster_step::head_fits<W, C>(s, a.V)) return kRefused;
  s.pool = a.R;  // the caches' rows: the strides
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  err = cluster_step::configure<W, C>(
      kernel, s, cfg, attr, static_cast<cudaStream_t>(stream), &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // the self caches' maps span all Tc slots (the same for every step)
  cluster_step::Maps maps;
  err = cluster_step::make_maps<W, C>(s, a.Tc, a.Tc, true, a.wp, a.self_k,
                                      a.self_v, a.cross_k, a.cross_v, &maps);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CC = const C*;
  using CF = const float*;
  using CI = const int*;
  const int kvd = a.Hkv * (a.D / a.H);  // the self caches' lanes
  err = cudaLaunchKernelEx(
      &cfg, ragged_step_cluster_kernel<W, C, kMqa, kRing>,
      static_cast<CI>(a.prev), static_cast<CI>(a.pos),
      static_cast<CF>(a.emb), static_cast<CF>(a.pos_emb),
      decoder::make_weights<W>(a.wp, a.ln), static_cast<CC>(a.self_k),
      static_cast<CC>(a.self_v), decoder::batch_major(a.R, a.Tc, kvd),
      static_cast<CC>(a.cross_k), static_cast<CC>(a.cross_v),
      static_cast<CF>(a.w_head), static_cast<CF>(a.b_head),
      static_cast<float*>(a.logits), static_cast<int*>(a.nxt),
      static_cast<float*>(a.logp),
      decoder::rows_out<C>(a.k_new, a.v_new, a.R, kvd),
      decoder::segment_ring<C>(a.seg, a.ring_k, a.ring_v, a.R,
                               kRing ? a.S : 0, kvd),
      maps, s, a.Tc, a.V, a.Tpos);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The MHA kernel where Hkv == H, else the MQA one (its shape refuses any
// Hkv but 1).
template <typename W, typename C, bool kRing>
int launch(const Args& a, void* stream) {
  return (a.Hkv == a.H ? launch_kernel<W, C, false, kRing>
                       : launch_kernel<W, C, true, kRing>)(a, stream);
}

// The kernel of a bundle and cache type, MHA or MQA (cluster_geometry).
template <bool kMqa, bool kRing>
const void* kernel_for(bool int8, bool f32) {
  if (int8)
    return f32 ? kernel_of<int8_t, float, kMqa, kRing>()
               : kernel_of<int8_t, __nv_bfloat16, kMqa, kRing>();
  return f32 ? kernel_of<float, float, kMqa, kRing>()
             : kernel_of<__nv_bfloat16, __nv_bfloat16, kMqa, kRing>();
}

}  // namespace
