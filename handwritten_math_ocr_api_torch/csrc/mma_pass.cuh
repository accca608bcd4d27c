// A block's matrix product on the tensor cores with its weights staged in
// shared memory, and LayerNorm of bf16 rows in shared memory: the building
// blocks of the whole Swin block (B4, swin_block.cu) and of patch merging
// (B3, patch_merging.cu).
//
// A pass is acc += A W[:, cols] for the block's 16 * MT * WR rows of A (bf16
// in shared memory) and up to 32 * NT columns of a bf16 weight in device
// memory. Its 4 WR warps stand WR (rows) by 4 (columns): a warp owns 16 * MT
// rows and a quarter of the columns, n / 4 of them, in m16n8 accumulator
// tiles of float32 (the caller's registers, kept across passes where a sum
// runs over several). mma.sync m16n8k16 takes A through ldmatrix and the
// weight through ldmatrix.trans. The weight comes in k-tiles of kKt rows by
// 16-byte cp.async copies into a ring of S tiles: the copies of tile
// t + S - 1 are issued before tile t is computed, and `begin` issues a
// pass's first tiles ahead, so that they fly while the block does other
// work. A thread's copies of a tile sit at the same offsets in every tile:
// `begin` works them out once a pass. Rows of A and of the ring are padded
// by 16 bytes, so that ldmatrix reads them without bank conflicts.
#pragma once

#include "common.cuh"

namespace mp {

constexpr int kKt = 32;  // weight rows a staged tile

// The threads of a block of WR rows of 4 warps.
template <int WR>
constexpr int kThreads = 128 * WR;

// The most 16-byte copies a thread issues for a tile of 32 * NT columns.
template <int NT, int WR>
constexpr int kCopies = (kKt * 4 * NT + kThreads<WR> - 1) / kThreads<WR>;

using bf16 = __nv_bfloat16;

// The weight of a pass: K rows (a multiple of kKt) of ldw elements from w;
// column n < n of the pass is base + (n / seg) * seg_stride + n % seg (one
// run of columns, or the q, k and v runs of a head group); n a multiple
// of 32, seg and base multiples of 8.
struct Pass {
  const bf16* w;
  int ldw, base, seg, seg_stride, K, n;
};

// S tiles of kKt rows, ld elements a row (at least the widest pass plus 8).
template <int S>
struct Ring {
  bf16* s;
  int ld;
};

// A pass in flight: this thread's copies of a tile (at most NC, kCopies of
// the widest pass), as element offsets from the tile's first weight row and
// from its ring slot.
template <int NC>
struct Stream {
  const bf16* w;
  int ldw, tiles, copies;
  int src[NC], dst[NC];
};

template <int S, int NC>
__device__ __forceinline__ void issue(const Ring<S>& r, const Stream<NC>& st,
                                      int kt) {
  const bf16* w = st.w + static_cast<size_t>(kt) * kKt * st.ldw;
  bf16* d = r.s + (kt % S) * kKt * r.ld;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < st.copies) cp_async16(d + st.dst[i], w + st.src[i]);
}

// Start a pass: work out this thread's copies and issue the first S - 1
// tiles (one commit group each). The ring must be free: after `run`
// returns, or before the first pass.
template <int NC, int WR, int S>
__device__ __forceinline__ Stream<NC> begin(const Ring<S>& r, const Pass& p) {
  Stream<NC> st;
  st.w = p.w;
  st.ldw = p.ldw;
  st.tiles = p.K / kKt;
  const int chunks = p.n / 8;  // 16-byte copies a weight row
  st.copies = 0;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = threadIdx.x + i * kThreads<WR>;
    const int row = c / chunks, n = (c - row * chunks) * 8;
    st.src[i] = row * p.ldw + p.base + (n / p.seg) * p.seg_stride + n % p.seg;
    st.dst[i] = row * r.ld + n;
    if (c < kKt * chunks) st.copies = i + 1;
  }
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < st.tiles) issue(r, st, s);
    cp_async_commit();
  }
  return st;
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// acc += A W for the pass `begin` started, n its columns. A: the block's
// 16 * MT * WR rows, lda elements apart, K columns. Ends with every copy
// landed and every warp past its last read of the ring and of A.
template <int WR, int MT, int NT, int S, int NC>
__device__ __forceinline__ void run(const Ring<S>& r, const Stream<NC>& st,
                                    int n, const bf16* A, int lda,
                                    float (&acc)[MT][NT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = n / 32;                    // n8 tiles of this warp
  const int c0 = (warp / WR) * nt * 8;      // its first column
  const bf16* a_row = A + ((warp % WR) * 16 * MT + (lane & 15)) * lda +
                      (lane >> 4) * 8;
  for (int kt = 0; kt < st.tiles; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + S - 1 < st.tiles) issue(r, st, kt + S - 1);
    cp_async_commit();
    const bf16* ws = r.s + (kt % S) * kKt * r.ld;
#pragma unroll
    for (int kk = 0; kk < kKt / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        tc::ldmatrix_x4(a[i], a_row + i * 16 * lda + kt * kKt + kk * 16);
      // lanes 0-15 address k rows 0-15 of the step, lanes 16-31 the same
      // rows 8 columns on: matrices (k 0-7, k 8-15) x (n, n + 8)
      const bf16* b_row = ws + (kk * 16 + (lane & 15)) * r.ld + c0;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j + 1 < nt) {
          uint32_t b[4];
          tc::ldmatrix_x4_trans(b, b_row + j * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            tc::mma_bf16(acc[i][j], a[i], b[0], b[1]);
            tc::mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
          }
        } else if (j < nt) {
          uint32_t b0, b1;
          tc::ldmatrix_x2_trans(b0, b1, b_row + j * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) tc::mma_bf16(acc[i][j], a[i], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The (row, column) of element pair (i, j, h) of the warp's accumulator
// tiles in a pass of n columns: m16 tile i, n8 tile j, h 0 for row gq and
// 1 for row gq + 8 (columns col and col + 1).
template <int WR, int MT>
__device__ __forceinline__ int pair_row(int i, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % WR) * 16 * MT + 16 * i + 8 * h + (lane >> 2);
}

template <int WR>
__device__ __forceinline__ int pair_col(int n, int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / WR) * (n / 32) * 8 + 8 * j + 2 * (lane & 3);
}

// epi(row, col, v0, v1) for each pair of adjacent columns of the warp's
// accumulator tiles (rows of the block, columns of a pass of n columns).
template <int WR, int MT, int NT, typename Epi>
__device__ __forceinline__ void for_pairs(int n, const float (&acc)[MT][NT][4],
                                          Epi epi) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < n / 32) {
        const int col = pair_col<WR>(n, j);
        epi(pair_row<WR, MT>(i, 0), col, acc[i][j][0], acc[i][j][1]);
        epi(pair_row<WR, MT>(i, 1), col, acc[i][j][2], acc[i][j][3]);
      }
}

// One warp: dst = round(LN(src) * g + b) over a row of n bf16 values in
// shared memory (n even; dst may be src), float32 statistics in two passes
// (biased variance, eps 1e-5).
__device__ __forceinline__ void ln_row(const bf16* src, bf16* dst, int n,
                                       const float* __restrict__ g,
                                       const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(src);
  float sum = 0.0f;
  for (int c = lane; c < n / 2; c += 32) {
    const float2 v = __bfloat1622float2(s2[c]);
    sum += v.x + v.y;
  }
  const float mean = warp_sum(sum) / n;
  float sq = 0.0f;
  for (int c = lane; c < n / 2; c += 32) {
    const float2 v = __bfloat1622float2(s2[c]);
    sq += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
  }
  const float inv = rsqrtf(warp_sum(sq) / n + 1e-5f);
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  for (int c = lane; c < n / 2; c += 32) {
    const float2 v = __bfloat1622float2(s2[c]);
    const float2 gg = __ldg(reinterpret_cast<const float2*>(g) + c);
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b) + c);
    d2[c] = __floats2bfloat162_rn((v.x - mean) * inv * gg.x + bb.x,
                                  (v.y - mean) * inv * gg.y + bb.y);
  }
}

}  // namespace mp
