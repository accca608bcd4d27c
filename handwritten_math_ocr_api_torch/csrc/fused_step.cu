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
// with the TPU kernels' numerics (see decoder_layers.cuh). B1's entries:
// the bf16 and float32 bundles, and the int8 bundle ("v2q",
// quantize_stacked: int8 weights with per-column float32 scales, bf16
// matmul inputs) over bf16 or float32 caches. B11's: the bf16 and float32
// bundles (its TPU kernel would cast activations to int8 on an int8 one).
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
// wrapper raises; a model the kernel does not split (make_shape) returns
// kRefused, which the wrapper raises as a ValueError.
#include <algorithm>
#include <cstring>

#include "decoder_cluster.cuh"

namespace {

using cluster_step::kThreads;
using cluster_step::Shape;

// Blocks of a cluster: the portable size, the fastest of 4, 8 and 16 on an
// H100 at 1 and 16 rows (PERF.md, the decoder step's cluster shapes).
constexpr int kClusterBlocks = 8;
// What an entry returns for a model or batch the kernel does not take.
constexpr int kRefused = -1;

template <typename W, typename C>
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
  using Step = cluster_step::Step<W, C>;
  using X = typename Step::X;
  // the swizzled weight stages need a 1024-byte aligned base
  unsigned char* smem =
      smem_raw + ((1024 - (cluster_step::smem_u32(smem_raw) & 1023)) & 1023);
  const int row0 = static_cast<int>(blockIdx.x) / s.Cs * s.Mg;
  Step step(w, self_k, self_v, self, cross_k, cross_v, fresh, &maps, s,
            smem, row0);
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

// The largest count of an item's slots (rows of `row` bytes, K and V) that
// `bytes` of shared memory hold for `items` items, at most `most`.
int slots_in(size_t bytes, int items, int row, int most) {
  const size_t each = bytes / (2 * static_cast<size_t>(items));
  int n = static_cast<int>(std::min<size_t>(most, each / row));
  while (n > 0 && cluster_step::align128(static_cast<size_t>(n) * row) > each)
    --n;
  return n;
}

// The Shape of a launch with Mg rows a group and kClusterBlocks blocks a
// cluster (stages 0 if the kernel does not take it: the heads an even
// split over the blocks or the blocks over the heads, each block's
// columns of every product a multiple of 8, or 16 for int8, and at most
// kBox, a block's columns of a product at most 8 kTilesPerWarp a warp, K
// of every product at most kBox or a multiple of it, a head's row 2^k
// 16-byte vectors, shared memory for the activations and one stage). The
// ring takes as many stages as fit up to kMaxStages, at least two if one
// stage would leave the cache unstaged; what is left stages the items'
// cross K/V slots, then their self-cache slots (up to Tc - 1, and kBox,
// slots). This is the one statement of the shapes the kernel takes.
template <typename W, typename C>
Shape make_shape(int L, int B, int Tc, int D, int H, int F, int L_enc,
                 int pos, int Mg) {
  const int Cs = kClusterBlocks;
  Shape s{L, B, D, H, F, L_enc, pos, Mg, Cs, 0, 0, 0};
  const int cols = std::max(8, 16 / static_cast<int>(sizeof(W)));
  const int dh = H > 0 ? D / H : 0;
  const int nvec = dh * static_cast<int>(sizeof(C)) / 16;
  const int bph = Cs >= H ? Cs / std::max(H, 1) : 1;
  const bool ok =
      B >= 1 && L >= 1 && H >= 1 && D % H == 0 && L_enc >= 1 && pos >= 0 &&
      pos < Tc && Mg >= 1 && Mg <= cluster_step::kGroupMax &&
      (Cs % H == 0 || H % Cs == 0) && Mg % bph == 0 &&
      (dh * sizeof(C)) % 16 == 0 && nvec <= 32 && (nvec & (nvec - 1)) == 0 &&
      dh % cols == 0 && D % (Cs * cols) == 0 && F % (Cs * cols) == 0 &&
      D % 16 == 0 && F % 16 == 0 && F / Cs <= cluster_step::kBox &&
      D / Cs <= cluster_step::kBox && dh <= cluster_step::kBox &&
      (D <= cluster_step::kBox || D % cluster_step::kBox == 0) &&
      (F <= cluster_step::kBox || F % cluster_step::kBox == 0);
  if (!ok) return s;
  const cluster_step::Split split(s);
  if (split.ipb > cluster_step::kMaxItems) return s;
  for (int p = 0; p < cluster_step::kSublayers; ++p)
    if (split.cols(s, p) > 8 * cluster_step::kTilesPerWarp * kThreads / 32)
      return s;
  const int items = cluster_step::Split(s).ipb;
  const int row = dh * static_cast<int>(sizeof(C));
  const int most_self = std::min(std::max(Tc - 1, 0), cluster_step::kBox);
  const int most_cross = std::min(L_enc, cluster_step::kBox);
  const size_t want =
      2 * items * (cluster_step::align128(static_cast<size_t>(row) * most_self) +
                   cluster_step::align128(static_cast<size_t>(row) * most_cross));
  int fit = 0;
  for (int n = 1; n <= cluster_step::kMaxStages; ++n) {
    s.stages = n;
    if (cluster_step::Layout<W, C>(s).end + 1024 <= cluster_step::kSmemMax)
      fit = n;
  }
  if (fit == 0) {
    s.stages = 0;
    return s;
  }
  s.stages = fit;
  for (int n = fit; n >= std::min(2, fit); --n) {  // the most stages that
    s.stages = n;                                  // stage every slot
    if (cluster_step::Layout<W, C>(s).end + 1024 + want <=
        cluster_step::kSmemMax)
      break;
  }
  const size_t room =
      cluster_step::kSmemMax - 1024 - cluster_step::Layout<W, C>(s).end;
  s.cap_cross = slots_in(room, items, row, most_cross);
  s.cap_self = slots_in(
      room - 2 * items * cluster_step::align128(
                             static_cast<size_t>(row) * s.cap_cross),
      items, row, most_self);
  return s;
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// the driver library).
cudaError_t encoder(Encode* out) {
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    fn = reinterpret_cast<Encode>(p);
  }
  *out = fn;
  return cudaSuccess;
}

template <typename T>
CUtensorMapDataType tma_type() {
  if constexpr (std::is_same_v<T, float>) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if constexpr (std::is_same_v<T, int8_t>) return CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The tensor map of a tensor of T at ptr (dims innermost first; byte
// strides of dims 1.. in `strides`, or dense if null) copied in boxes of
// `box`. A map with `keep` is encoded once and kept (a decode's steps use
// the same weights and cross K/V); the self-cache maps end at pos, which
// every step moves, and are encoded for each launch.
template <typename T>
cudaError_t tensor_map(CUtensorMap* out, const void* ptr, int rank,
                       const uint64_t* dims, const uint32_t* box,
                       int swizzle_bits, const uint64_t* strides = nullptr,
                       bool keep = true) {
  struct Key {
    const void* ptr;
    uint64_t dims[4];
    uint32_t box[4];
    int rank, swizzle;
  };
  static Key keys[64];
  static CUtensorMap maps[64];
  static int used = 0, next = 0;
  Key key;
  std::memset(&key, 0, sizeof(key));  // padding too: keys compare as bytes
  key.ptr = ptr;
  key.rank = rank;
  key.swizzle = swizzle_bits;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
  }
  for (int i = 0; keep && i < used; ++i) {
    if (std::memcmp(&keys[i], &key, sizeof(Key)) == 0) {
      *out = maps[i];
      return cudaSuccess;
    }
  }
  Encode fn;
  const cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], estride[4];
  cuuint64_t stride = sizeof(T);
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = strides != nullptr ? strides[i - 1] : stride;
    stride *= dims[i];
  }
  if (fn(out, tma_type<T>(), rank, const_cast<void*>(ptr), gdim, gstride,
         bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle_bits == 1   ? CU_TENSOR_MAP_SWIZZLE_32B
         : swizzle_bits == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
         : swizzle_bits == 3 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_NONE,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (!keep) return cudaSuccess;
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % 64;
  used = std::max(used, next == 0 ? 64 : next);
  return cudaSuccess;
}

// The launch's tensor maps: the six weights, the self caches' slots before
// pos (at least one, which a step at pos 0 never copies) of their Tc, and
// the cross K/V.
template <typename W, typename C>
cudaError_t make_maps(const Shape& s, int Tc, const void* const* wp,
                      const void* self_k, const void* self_v,
                      const void* cross_k, const void* cross_v,
                      cluster_step::Maps* maps) {
  const cluster_step::Split sp(s);
  for (int p = 0; p < cluster_step::kSublayers; ++p) {
    const int K = sp.k(s, p);
    const uint64_t dims[3] = {static_cast<uint64_t>(sp.n_all(s, p)),
                              static_cast<uint64_t>(K),
                              static_cast<uint64_t>(s.L)};
    const uint32_t box[3] = {static_cast<uint32_t>(sp.seg_cols(s, p)),
                             static_cast<uint32_t>(
                                 std::min(K, cluster_step::kBox)),
                             1};
    const cudaError_t err = tensor_map<W>(
        &maps->w[p], wp[3 * p], 3, dims, box,
        cluster_step::swizzle_bits(sp.seg_cols(s, p) * sizeof(W)));
    if (err != cudaSuccess) return err;
  }
  const uint64_t self_dims[4] = {static_cast<uint64_t>(s.D),
                                 static_cast<uint64_t>(std::max(s.pos, 1)),
                                 static_cast<uint64_t>(s.B),
                                 static_cast<uint64_t>(s.L)};
  const uint64_t row = s.D * sizeof(C);
  const uint64_t self_strides[3] = {row, row * Tc, row * Tc * s.B};
  const uint64_t cross_dims[4] = {static_cast<uint64_t>(s.D),
                                  static_cast<uint64_t>(s.L_enc),
                                  static_cast<uint64_t>(s.B),
                                  static_cast<uint64_t>(s.L)};
  const uint32_t self_box[4] = {static_cast<uint32_t>(sp.dh),
                                static_cast<uint32_t>(std::max(s.cap_self, 1)),
                                1, 1};
  const uint32_t cross_box[4] = {
      static_cast<uint32_t>(sp.dh),
      static_cast<uint32_t>(std::max(s.cap_cross, 1)), 1, 1};
  cudaError_t err = tensor_map<C>(&maps->self_k, self_k, 4, self_dims,
                                  self_box, 0, self_strides, false);
  if (err == cudaSuccess)
    err = tensor_map<C>(&maps->self_v, self_v, 4, self_dims, self_box, 0,
                        self_strides, false);
  if (err == cudaSuccess)
    err = tensor_map<C>(&maps->cross_k, cross_k, 4, cross_dims, cross_box, 0);
  if (err == cudaSuccess)
    err = tensor_map<C>(&maps->cross_v, cross_v, 4, cross_dims, cross_box, 0);
  return err;
}

// The clusters of a kernel's shape and shared memory that fit on the card
// at once (0: none), queried once for each.
template <typename W, typename C>
cudaError_t active_clusters(const cudaLaunchConfig_t& cfg, int* active) {
  static int keys[16][2], values[16], used = 0;
  const int cs = static_cast<int>(cfg.attrs[0].val.clusterDim.x);
  const int smem = static_cast<int>(cfg.dynamicSmemBytes);
  for (int i = 0; i < used; ++i) {
    if (keys[i][0] == cs && keys[i][1] == smem) {
      *active = values[i];
      return cudaSuccess;
    }
  }
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      active, fused_step_cluster_kernel<W, C>, &cfg);
  if (err == cudaSuccess && used < 16) {
    keys[used][0] = cs;
    keys[used][1] = smem;
    values[used++] = *active;
  }
  return err;
}

// The launch configuration of a Shape, and in *active the clusters of its
// shape that fit on the card at once.
template <typename W, typename C>
cudaError_t configure(const Shape& s, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr, cudaStream_t st,
                      int* active) {
  static bool attributes_set = false;
  if (!attributes_set) {
    auto kernel = fused_step_cluster_kernel<W, C>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cluster_step::kSmemMax));
    if (err != cudaSuccess) return err;
    attributes_set = true;
  }
  const int groups = (s.B + s.Mg - 1) / s.Mg;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(s.Cs * groups));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cluster_step::Layout<W, C>(s).end + 1024;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(s.Cs);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return active_clusters<W, C>(cfg, active);
}

// The Shape of a step for B rows: the fewest rows a group (so the most
// clusters) whose groups all fit on the card at once, 16 if none does.
// stages 0: no shape the kernel takes.
template <typename W, typename C>
cudaError_t choose_shape(int L, int B, int Tc, int D, int H, int F,
                         int L_enc, int pos, Shape* out) {
  Shape last{};
  for (int Mg = 1; Mg <= cluster_step::kGroupMax; Mg *= 2) {
    const Shape s = make_shape<W, C>(L, B, Tc, D, H, F, L_enc, pos, Mg);
    if (s.stages < 1) continue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int active = 0;
    const cudaError_t err = configure<W, C>(s, cfg, attr, nullptr, &active);
    if (err != cudaSuccess) return err;
    last = s;
    if ((B + Mg - 1) / Mg <= active) break;
  }
  *out = last;
  return cudaSuccess;
}

// wp: six (weight, scale, bias) triples, scale null for a float bundle.
// k_new and v_new null: B11, the fresh rows written into the caches.
template <typename W, typename C>
int launch(const void* x_emb, const void* const* wp, const void* ln,
           const void* self_k, const void* self_v, const void* cross_k,
           const void* cross_v, void* x_out, void* k_new, void* v_new, int L,
           int B, int Tc, int D, int H, int F, int L_enc, int pos,
           void* stream) {
  Shape s;
  cudaError_t err =
      choose_shape<W, C>(L, B, Tc, D, H, F, L_enc, pos, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.stages < 1) return kRefused;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  err = configure<W, C>(s, cfg, attr, static_cast<cudaStream_t>(stream),
                        &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  cluster_step::Maps maps;
  err = make_maps<W, C>(s, Tc, wp, self_k, self_v, cross_k, cross_v, &maps);
  if (err != cudaSuccess) return static_cast<int>(err);
  using CC = const C*;
  const decoder::CacheLayout self = decoder::batch_major(B, Tc, D);
  C* sk = static_cast<C*>(const_cast<void*>(self_k));
  C* sv = static_cast<C*>(const_cast<void*>(self_v));
  const decoder::FreshRows<C> fresh =
      k_new != nullptr ? decoder::rows_out<C>(k_new, v_new, B, D)
                       : decoder::rows_in_place<C>(sk, sv, self, pos);
  err = cudaLaunchKernelEx(
      &cfg, fused_step_cluster_kernel<W, C>, static_cast<CC>(x_emb),
      decoder::make_weights<W>(wp, ln), static_cast<CC>(sk),
      static_cast<CC>(sv), self, static_cast<CC>(cross_k),
      static_cast<CC>(cross_v), static_cast<float*>(x_out), fresh, maps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, typename C>
int geometry(int B, int Tc, int D, int H, int F, int L_enc, int* out) {
  Shape s;
  cudaError_t err = choose_shape<W, C>(1, B, Tc, D, H, F, L_enc, Tc - 1, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.stages < 1) return kRefused;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  err = configure<W, C>(s, cfg, attr, nullptr, &active);
  out[0] = s.Cs;
  out[1] = (s.B + s.Mg - 1) / s.Mg;
  out[2] = s.Mg;
  out[3] = static_cast<int>(cfg.dynamicSmemBytes);
  out[4] = s.stages;
  out[5] = active;
  out[6] = s.cap_self;
  out[7] = s.cap_cross;
  return static_cast<int>(err);
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

// The launch geometry of a step for B rows, with int8 weights if `int8`
// and a float32 cache if `f32` (else bf16), at the last slot: out[0..7] =
// blocks a cluster, clusters, rows a group, shared memory bytes a block,
// stages of the ring, clusters the card holds at once, self-cache and
// cross K/V slots an item stages. Returns the error a launch would
// (kRefused for a shape the kernel does not take).
extern "C" int fused_step_geometry(int int8, int f32, int B, int Tc, int D,
                                   int H, int F, int L_enc, int* out) {
  if (int8)
    return f32 ? geometry<int8_t, float>(B, Tc, D, H, F, L_enc, out)
               : geometry<int8_t, __nv_bfloat16>(B, Tc, D, H, F, L_enc, out);
  return f32 ? geometry<float, float>(B, Tc, D, H, F, L_enc, out)
             : geometry<__nv_bfloat16, __nv_bfloat16>(B, Tc, D, H, F, L_enc,
                                                     out);
}
