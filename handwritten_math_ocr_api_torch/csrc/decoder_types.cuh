// The operand types of the decoder-step kernels: the stacked weights of a
// bundle (Linear, Weights), the matmul input type of a weight type
// (InputOf), where a self cache lies (CacheLayout) and where a step's fresh
// K/V rows go (FreshRows), for the cluster layer code of every decoder-step
// kernel (decoder_cluster.cuh: B1, B7, B10, B11, B12).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace decoder {

// The type a matmul input is rounded to for weights of type W.
template <typename W>
using InputOf =
    std::conditional_t<std::is_same_v<W, int8_t>, __nv_bfloat16, W>;

// One stacked weight of every layer: (L, K, N) of type W, its scales
// (L, 1, N) float32 (null unless W is int8) and its bias (L, 1, N)
// float32.
template <typename W>
struct Linear {
  const W* w;
  const float* s;
  const float* b;
};

// The stacked weights of every layer (build_stacked's bundle, or
// quantize_stacked's), and LayerNorm (L, 6, D) in float32.
template <typename W>
struct Weights {
  Linear<W> qkv, out, cq, co, ff1, ff2;
  const float* ln;
};

// The Weights of a C entry's pointers: six (weight, scale, bias) triples
// (scale null for a float bundle) and the LayerNorm table.
template <typename W>
__host__ inline Weights<W> make_weights(const void* const* p,
                                        const void* ln) {
  Linear<W> lin[6];
  for (int i = 0; i < 6; ++i)
    lin[i] = {static_cast<const W*>(p[3 * i]),
              static_cast<const float*>(p[3 * i + 1]),
              static_cast<const float*>(p[3 * i + 2])};
  return {lin[0], lin[1], lin[2], lin[3], lin[4], lin[5],
          static_cast<const float*>(ln)};
}

// Where a self cache lies: element d of slot t of row r in layer l is at
// base + l * layer + r * row + t * slot + d.
struct CacheLayout {
  size_t layer, row, slot;
};

// (L, B, T, D): a row's slots are contiguous (B1, B7, B10 "v3", B11, B12).
__host__ __device__ inline CacheLayout batch_major(int B, int T, int D) {
  return {static_cast<size_t>(B) * T * D, static_cast<size_t>(T) * D,
          static_cast<size_t>(D)};
}

// (L, T, B, D): a slot's rows are contiguous (B10 "v4").
__host__ __device__ inline CacheLayout time_major(int B, int T, int D) {
  return {static_cast<size_t>(T) * B * D, static_cast<size_t>(D),
          static_cast<size_t>(B) * D};
}

// Where a step's fresh K/V rows go: row r of layer l at k + l * layer +
// r * row (and v alike).
template <typename C>
struct FreshRows {
  C* k;
  C* v;
  size_t layer, row;
};

// (L, B, D) outputs that the caller appends.
template <typename C>
__host__ inline FreshRows<C> rows_out(void* k, void* v, int B, int D) {
  return {static_cast<C*>(k), static_cast<C*>(v),
          static_cast<size_t>(B) * D, static_cast<size_t>(D)};
}

// B7's segment ring (ring mode): each pool row's segment start seg[r] and
// the ring K/V (L, B, S, kvd) of the segment's earlier fresh rows, ring row
// j holding slot seg[r] + j: element d of ring row j of row r in layer l at
// k + l * layer + r * row + j * slot + d (v alike).
template <typename C>
struct SegmentRing {
  const int* seg;
  const C* k;
  const C* v;
  size_t layer, row, slot;
};

template <typename C>
__host__ inline SegmentRing<C> segment_ring(const void* seg, const void* k,
                                            const void* v, int B, int S,
                                            int kvd) {
  return {static_cast<const int*>(seg), static_cast<const C*>(k),
          static_cast<const C*>(v), static_cast<size_t>(B) * S * kvd,
          static_cast<size_t>(S) * kvd, static_cast<size_t>(kvd)};
}

// The self cache itself at slot pos, written in place: the step reads only
// slots before pos, so no block reads what another writes.
template <typename C>
__host__ __device__ inline FreshRows<C> rows_in_place(C* k, C* v,
                                                      CacheLayout c,
                                                      int pos) {
  return {k + pos * c.slot, v + pos * c.slot, c.layer, c.row};
}

}  // namespace decoder
