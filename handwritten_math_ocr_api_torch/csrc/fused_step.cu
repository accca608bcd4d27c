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
//   every layer at slot pos (decoder_cluster.cuh::Step::run)
//   x_out[b] = x
// with the TPU kernels' numerics (see decoder_cluster.cuh). B1's entries:
// the bf16 and float32 bundles, and the int8 bundle ("v2q",
// quantize_stacked: int8 weights with per-column float32 scales, bf16
// matmul inputs) over bf16 or float32 caches; each over MHA self caches
// (L, B, T, D) or MQA's (Hkv 1: (L, B, T, dh), the TPU kernel's kv_dim,
// a kernel of its own, kMqa). B11's: the bf16 and float32 bundles (its
// TPU kernel would cast activations to int8 on an int8 one), MHA only, as
// the TPU kernel.
//
// Bound on the H100: bytes. A step reads every decoder weight once (about
// 10.5 MB of bf16 at 8 layers, d_model 256, FFN 512; half in int8), the
// cross K/V and the cache prefix (19.5 MB at pos 149 and 16 rows), and
// does about two flops per weight byte per row, far below the card's ~295
// bf16 flops per byte. Design (decoder_cluster.cuh): the rows go in groups
// of up to 16, one thread-block cluster of kClusterBlocks blocks (on as
// many SMs) a group, the fewest rows a group whose clusters the card holds
// at once;
// each block computes its columns of every product for all the group's
// rows on the tensor cores, so each weight byte is read once a group,
// and its next weight columns and its attention items' cache slots
// arrive by TMA while it computes; the group's (row, head) attention
// items are spread over the cluster's blocks, each block owning the
// heads whose q/k/v columns it computes; the blocks exchange activations
// through distributed shared memory and meet at six cluster barriers a
// layer. The TPU kernel likewise held the whole batch against one layer's
// weights per grid step (grid=(L,)). What the time is then made of is
// the latency of those phases, not the bytes (decoder_cluster.cuh). B11
// differs from B1 only in where the fresh rows go (FreshRows), so it
// writes 2 L B D elements into the caches and no whole-cache copy; the
// step reads only slots before pos, so no block reads a slot that another
// writes.
//
// No fallback: a cluster shape the card cannot place (no active cluster,
// or cudaLaunchKernelEx refusing it) is returned as an error, which the
// wrapper raises; a model the kernel does not split
// (decoder_cluster.cuh's make_shape) returns kRefused, which the wrapper
// raises as a ValueError.
#include <algorithm>

#include "decoder_cluster.cuh"

namespace {

using cluster_step::kRefused;
using cluster_step::kThreads;
using cluster_step::Shape;

template <typename W, typename C, bool kMqa>
__global__ void __launch_bounds__(kThreads, 1)
fused_step_cluster_kernel(const C* __restrict__ x_emb,
                          decoder::Weights<W> w, const C* self_k,
                          const C* self_v, decoder::CacheLayout self,
                          const C* __restrict__ cross_k,
                          const C* __restrict__ cross_v,
                          float* __restrict__ x_out,
                          decoder::FreshRows<C> fresh,
                          const __grid_constant__ cluster_step::Maps maps,
                          Shape s) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using Step = cluster_step::Step<W, C, false, kMqa>;
  using X = typename Step::X;
  // the swizzled weight stages need a 1024-byte aligned base
  unsigned char* smem =
      smem_raw + ((1024 - (cluster_step::smem_u32(smem_raw) & 1023)) & 1023);
  const int row0 = static_cast<int>(blockIdx.x) / s.Cs * s.Mg;
  Step step(w, self_k, self_v, self, cross_k, cross_v, fresh, &maps, s,
            smem, row0);
  step.positions(nullptr, nullptr, 0, 0);  // every row at s.pos
  step.start();
  const int D = s.D, lda = D + cluster_step::pad_of<X>();
  for (int i = threadIdx.x; i < step.rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const float v = to_f32(x_emb[static_cast<size_t>(row0 + r) * D + d]);
    step.x[i] = v;
    step.xa[r * lda + d] = from_f32<X>(v);
  }
  step.cluster.sync();  // every block runs before any remote store
  step.run();
  if (step.rank == 0) {
    for (int i = threadIdx.x; i < step.rows * D; i += kThreads)
      x_out[static_cast<size_t>(row0) * D + i] = step.x[i];
  }
}

template <typename W, typename C, bool kMqa>
const void* kernel_of() {
  return reinterpret_cast<const void*>(fused_step_cluster_kernel<W, C, kMqa>);
}

// wp: six (weight, scale, bias) triples, scale null for a float bundle.
// k_new and v_new null: B11, the fresh rows written into the caches.
template <typename W, typename C, bool kMqa>
int launch_kernel(const void* x_emb, const void* const* wp, const void* ln,
                  const void* self_k, const void* self_v,
                  const void* cross_k, const void* cross_v, void* x_out,
                  void* k_new, void* v_new, int L, int B, int Tc, int D,
                  int H, int Hkv, int F, int L_enc, int pos, void* stream) {
  const void* kernel = kernel_of<W, C, kMqa>();
  Shape s;
  cudaError_t err = cluster_step::choose_shape<W, C>(
      kernel, L, B, Tc, D, H, Hkv, F, L_enc, pos, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.stages < 1) return kRefused;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  err = cluster_step::configure<W, C>(
      kernel, s, cfg, attr, static_cast<cudaStream_t>(stream), &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // the self caches' map ends at slot pos (encoded for this launch)
  cluster_step::Maps maps;
  err = cluster_step::make_maps<W, C>(s, Tc, std::max(pos, 1), false, wp,
                                      self_k, self_v, cross_k, cross_v,
                                      &maps);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CC = const C*;
  const int kvd = Hkv * (D / H);  // the self caches' lanes
  const decoder::CacheLayout self = decoder::batch_major(B, Tc, kvd);
  C* sk = static_cast<C*>(const_cast<void*>(self_k));
  C* sv = static_cast<C*>(const_cast<void*>(self_v));
  const decoder::FreshRows<C> fresh =
      k_new != nullptr ? decoder::rows_out<C>(k_new, v_new, B, kvd)
                       : decoder::rows_in_place<C>(sk, sv, self, pos);
  err = cudaLaunchKernelEx(
      &cfg, fused_step_cluster_kernel<W, C, kMqa>, static_cast<CC>(x_emb),
      decoder::make_weights<W>(wp, ln), static_cast<CC>(sk),
      static_cast<CC>(sv), self, static_cast<CC>(cross_k),
      static_cast<CC>(cross_v), static_cast<float*>(x_out), fresh, maps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The MHA kernel where Hkv == H, the MQA one where Hkv is 1 (its shape
// refuses any other Hkv). B11's entries (k_new null) pass Hkv = H.
template <typename W, typename C>
int launch(const void* x_emb, const void* const* wp, const void* ln,
           const void* self_k, const void* self_v, const void* cross_k,
           const void* cross_v, void* x_out, void* k_new, void* v_new, int L,
           int B, int Tc, int D, int H, int Hkv, int F, int L_enc, int pos,
           void* stream) {
  return (Hkv == H ? launch_kernel<W, C, false> : launch_kernel<W, C, true>)(
      x_emb, wp, ln, self_k, self_v, cross_k, cross_v, x_out, k_new, v_new,
      L, B, Tc, D, H, Hkv, F, L_enc, pos, stream);
}

}  // namespace

// Every entry returns 0, a cudaError, or kRefused (-1) for a model or batch
// the kernel does not take (make_shape).

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
      int H, int Hkv, int F, int L_enc, int pos, void* stream) {            \
    const void* wp[18] = {w_qkv, nullptr, b_qkv, w_out, nullptr, b_out,    \
                          w_cq,  nullptr, b_cq,  w_co,  nullptr, b_co,     \
                          w_ff1, nullptr, b_ff1, w_ff2, nullptr, b_ff2};   \
    return launch<TYPE, TYPE>(x_emb, wp, ln, self_k, self_v, cross_k,      \
                              cross_v, x_out, k_new, v_new, L, B, Tc, D, H, \
                              Hkv, F, L_enc, pos, stream);                  \
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
      int H, int Hkv, int F, int L_enc, int pos, void* stream) {            \
    const void* wp[18] = {w_qkv, s_qkv, b_qkv, w_out, s_out, b_out,        \
                          w_cq,  s_cq,  b_cq,  w_co,  s_co,  b_co,         \
                          w_ff1, s_ff1, b_ff1, w_ff2, s_ff2, b_ff2};       \
    return launch<int8_t, CACHE>(x_emb, wp, ln, self_k, self_v, cross_k,   \
                                 cross_v, x_out, k_new, v_new, L, B, Tc, D, \
                                 H, Hkv, F, L_enc, pos, stream);            \
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
                              D, H, H, F, L_enc, pos, stream);              \
  }

FUSED_STEP_ENTRY(fused_decoder_step_bf16, __nv_bfloat16)
FUSED_STEP_ENTRY(fused_decoder_step_f32, float)
LAYERS_STEP_IN_PLACE_ENTRY(layers_step_in_place_bf16, __nv_bfloat16)
LAYERS_STEP_IN_PLACE_ENTRY(layers_step_in_place_f32, float)
FUSED_STEP_I8_ENTRY(fused_decoder_step_i8_bf16, __nv_bfloat16)
FUSED_STEP_I8_ENTRY(fused_decoder_step_i8_f32, float)

template <bool kMqa>
const void* kernel_for(bool int8, bool f32) {
  if (int8)
    return f32 ? kernel_of<int8_t, float, kMqa>()
               : kernel_of<int8_t, __nv_bfloat16, kMqa>();
  return f32 ? kernel_of<float, float, kMqa>()
             : kernel_of<__nv_bfloat16, __nv_bfloat16, kMqa>();
}

const void* cluster_step::fused_step_kernel(bool int8, bool f32, bool mqa) {
  return mqa ? kernel_for<true>(int8, f32) : kernel_for<false>(int8, f32);
}

// The launch geometry of a cluster kernel (cluster_step::Kernel: B1/B11,
// B7, B10 or B12) for B rows at the last slot, with int8 weights if `int8`
// and a float32 cache if `f32` (else bf16), and the float32 head of V
// columns (none if V is 0; resident in shared memory for B12), over self
// caches of Hkv KV heads (H; or 1, MQA, for B1 and B7): out[0..7] =
// blocks a cluster, clusters, rows a group, shared memory bytes a block,
// stages of the ring, clusters the card holds at once, self-cache and
// cross K/V slots an item stages. Returns the error a launch would
// (kRefused for a shape or a kernel the port does not have).
extern "C" int cluster_geometry(int kernel, int int8, int f32, int B,
                                int Tc, int D, int H, int Hkv, int F,
                                int L_enc, int V, int* out) {
  using namespace cluster_step;
  const bool mqa = Hkv != H;
  const void* k =
      kernel == kFusedStep    ? fused_step_kernel(int8, f32, mqa)
      : kernel == kRaggedStep ? ragged_step_kernel(int8, f32, mqa)
      : mqa                   ? nullptr
      : kernel == kWholeStep  ? whole_step_kernel(int8, f32)
      : kernel == kWholeDecode ? whole_decode_kernel(int8, f32)
                               : nullptr;
  if (k == nullptr) return kRefused;
  const bool resident = kernel == kWholeDecode;
  if (int8)
    return f32 ? geometry<int8_t, float>(k, B, Tc, D, H, Hkv, F, L_enc, V,
                                         out, resident)
               : geometry<int8_t, __nv_bfloat16>(k, B, Tc, D, H, Hkv, F,
                                                 L_enc, V, out, resident);
  return f32 ? geometry<float, float>(k, B, Tc, D, H, Hkv, F, L_enc, V, out,
                                      resident)
             : geometry<__nv_bfloat16, __nv_bfloat16>(k, B, Tc, D, H, Hkv, F,
                                                      L_enc, V, out,
                                                      resident);
}
