// Softmax attention of one warp's 16 query rows over the N <= 64 keys of a
// window on the tensor cores: the core of window attention (B2,
// window_attention.cu) and of the whole Swin block (B4, swin_block.cu).
//
// q, k and v are bf16 rows in shared memory, `stride` elements apart
// (rows padded by 16 bytes, so that ldmatrix reads them without bank
// conflicts). The warp's rows are m16 * 16 + gq and + 8 (lane = 4 gq +
// tq). S = Q K^T by mma.sync m16n8k16 (bf16 in, float32 sums, operands
// through ldmatrix) with the keys padded to 64; each S element becomes
// S * scale + bias(j, e, row, col) for a key col < N, and -inf for the
// 64 - N padding columns of the product; row max and sum by quad shuffles;
// P, rounded to bf16, goes from the accumulator straight into the A
// operand (the m16n8 accumulator layout is the m16k16 A layout), and O = P V
// runs on the tensor cores with V through ldmatrix.trans. Row addresses
// past N - 1 are clamped to row N - 1: a query row past N computes a copy
// of a real row (the caller discards it), and a padding key meets a
// probability of exactly 0 against finite data, so no row past N is read.
//
// Returns the unnormalised o (the m16n8 accumulator tiles of the DH output
// columns) and the reciprocal row sums of rows gq and gq + 8.
#pragma once

#include "common.cuh"

namespace wattn {

constexpr int kKeyTiles = 8;  // 64 keys in tiles of 8

// Fragment layouts of mma.m16n8k16 (lane = 4 * gq + tq): the accumulator's
// d[0], d[1] are row gq, columns 2 tq and 2 tq + 1 of the 16x8 tile, d[2],
// d[3] the same columns of row gq + 8; a[0..3] hold rows gq / gq + 8 at
// columns 2 tq (+1) and 2 tq + 8 (+1), in the order (gq, lo), (gq + 8, lo),
// (gq, hi), (gq + 8, hi).
template <int DH, typename Bias>
__device__ __forceinline__ void attend_rows(const __nv_bfloat16* qs,
                                            const __nv_bfloat16* ks,
                                            const __nv_bfloat16* vs,
                                            int stride, int N, int m16,
                                            Bias bias, float (&o)[DH / 8][4],
                                            float& inv0, float& inv1) {
  constexpr int kSteps = DH / 16;  // k-steps of S = Q K^T
  constexpr int kOutTiles = DH / 8;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = m16 * 16 + gq, row1 = row0 + 8;

  // S = Q K^T: A = the warp's 16 q rows, B = k rows (keys) as columns
  uint32_t a[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int r = min(m16 * 16 + (lane & 15), N - 1);
    tc::ldmatrix_x4(a[kk], qs + r * stride + kk * 16 + (lane >> 4) * 8);
  }
  float s[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int jp = 0; jp < kKeyTiles / 2; ++jp) {
    // two key tiles: matrices (keys 16 jp + 0..7, cols +0 / +8) and
    // (keys 16 jp + 8..15, cols +0 / +8)
    const int key = min(16 * jp + (lane >> 4) * 8 + (lane & 7), N - 1);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t b[4];
      tc::ldmatrix_x4(b, ks + key * stride + kk * 16 + ((lane >> 3) & 1) * 8);
      tc::mma_bf16(s[2 * jp], a[kk], b[0], b[1]);
      tc::mma_bf16(s[2 * jp + 1], a[kk], b[2], b[3]);
    }
  }

  // scale, bias, softmax numerators in float32; rows gq and gq + 8 are
  // spread over the 4 lanes of a quad
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * tq + (e & 1);
      s[j][e] = c < N ? fmaf(s[j][e], scale,
                             bias(j, e, e < 2 ? row0 : row1, c))
                      : -INFINITY;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    s[j][0] = expf(s[j][0] - mx0);
    s[j][1] = expf(s[j][1] - mx0);
    s[j][2] = expf(s[j][2] - mx1);
    s[j][3] = expf(s[j][3] - mx1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }

  // O = P V: P's k-step kk is key tiles 2 kk and 2 kk + 1 of S
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
    const uint32_t pa[4] = {tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    // matrices (keys +0..7 / +8..15) x (dh cols of tile 2 dp / 2 dp + 1),
    // transposed into B fragments
    const int key = min(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8, N - 1);
#pragma unroll
    for (int dp = 0; dp < kOutTiles / 2; ++dp) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, vs + key * stride + (2 * dp + (lane >> 4)) * 8);
      tc::mma_bf16(o[2 * dp], pa, b[0], b[1]);
      tc::mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
    }
  }
  inv0 = 1.0f / sum0;
  inv1 = 1.0f / sum1;
}

}  // namespace wattn
