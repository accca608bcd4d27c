// Shifted-window attention core of the Swin encoder.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/window_attention.py::window_attention_core
// (_attn_kernel): for each (batch, window, head) group g,
//   out = softmax(q k^T / sqrt(dh) + mask[g % mask_groups]) v
// with q, k, v of shape (N, dh) (N = 49 tokens of a 7x7 window, dh = 32 on
// Swin-T) and the additive mask (relative-position bias + shift mask, fill
// -100) in float32. Logits and softmax run in float32. With
// mask_groups = nW * nh the mask is (nW, nh, N, N); with mask_groups = nh
// it is (1, nh, N, N), one per head for all windows (an unshifted block):
// groups are ordered (batch, window, head), so g % nh is the head.
//
// Bound on the H100: device memory. Per group the kernel moves 4 * 49 * 32
// * 2 bytes of bf16 (q, k, v in, out back) and does 4 * 49 * 49 * 32
// flops, about 24 flops a byte, far below the card's ~295 bf16 flops per
// byte: one encode's 12 launches move 156 MB, 0.047 ms at 3.35 TB/s.
//
// bf16 (window_attention_mma_kernel): one block of 4 warps per group. The
// block copies q, k and v (three contiguous (N, dh) tiles) into shared
// memory with 16-byte cp.async copies, rows padded by 16 bytes so that
// ldmatrix reads them without bank conflicts, and loads the warp's part of
// the float32 mask from L2 into registers while the copies fly. Each warp
// owns 16 query rows against all keys, N padded to 64: S = Q K^T on the
// tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate, operands
// through ldmatrix), the scale and mask added to the accumulator, key
// columns >= N set to -inf, row max and sum in registers with quad
// shuffles. P goes from the accumulator straight into the A operand (the
// m16n8 accumulator layout is the m16k16 A layout), rounded to bf16, and
// O = P V runs on the tensor cores with V through ldmatrix.trans. O is
// divided by the float32 row sum, staged in the warp's own q rows and
// written out as 16-byte stores, rows < N only. Padded rows (N..63) are
// never copied: their ldmatrix addresses are clamped to row N - 1, so a
// padded query row computes a discarded copy of a real one and a padded
// key meets a probability of exactly 0 against finite data; no stale
// shared memory reaches a product. Shared memory is 3 * N * (dh + 8) * 2
// bytes (11.8 KB at Swin-T's shapes), so several groups are in flight on
// each SM.
//
// float32 (window_attention_kernel): the CUDA-core version, one block per
// group; q (pre-scaled), k (rows padded by one float against bank
// conflicts) and v staged in shared memory as float32, the (N, N) logits
// kept in the block, one warp normalising each row.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ mask, T* __restrict__ out,
                        int N, int dh, int mask_groups) {
  extern __shared__ float smem[];
  const int nd = N * dh;
  const int kstride = dh + 1;
  float* qs = smem;                // N x dh, scaled by 1/sqrt(dh)
  float* ks = qs + nd;             // N x (dh + 1)
  float* vs = ks + N * kstride;    // N x dh
  float* ps = vs + nd;             // N x N logits, then probabilities

  const int g = blockIdx.x;
  const size_t base = static_cast<size_t>(g) * nd;
  const float* m = mask + static_cast<size_t>(g % mask_groups) * N * N;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));

  for (int idx = threadIdx.x; idx < nd; idx += blockDim.x) {
    const int i = idx / dh, d = idx - i * dh;
    qs[idx] = to_f32(q[base + idx]) * scale;
    ks[i * kstride + d] = to_f32(k[base + idx]);
    vs[idx] = to_f32(v[base + idx]);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
    const int i = idx / N, j = idx - i * N;
    const float* qi = qs + i * dh;
    const float* kj = ks + j * kstride;
    float acc = 0.0f;
    for (int d = 0; d < dh; ++d) acc = fmaf(qi[d], kj[d], acc);
    ps[idx] = acc + m[idx];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < N; i += nwarps) {
    float* row = ps + i * N;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nd; idx += blockDim.x) {
    const int i = idx / dh, d = idx - i * dh;
    const float* pi = ps + i * N;
    float acc = 0.0f;
    for (int j = 0; j < N; ++j) acc = fmaf(pi[j], vs[j * dh + d], acc);
    out[base + idx] = from_f32<T>(acc);
  }
}

constexpr int kMmaWarps = 4;  // 16 query rows each: N <= 64
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kKeyTiles = 8;  // 64 keys in tiles of 8

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, float32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * gq + tq): the accumulator's
// d[0], d[1] are row gq, columns 2 tq and 2 tq + 1 of the 16x8 tile, d[2],
// d[3] the same columns of row gq + 8; a[0..3] hold rows gq / gq + 8 at
// columns 2 tq (+1) and 2 tq + 8 (+1), in the order (gq, lo), (gq + 8, lo),
// (gq, hi), (gq + 8, hi).
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 4)
window_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ mask,
                            __nv_bfloat16* __restrict__ out, int N,
                            int mask_groups) {
  constexpr int kStride = DH + 8;  // bf16 a shared row: 16 bytes of padding
  constexpr int kChunks = DH / 8;  // 16-byte copies a row
  constexpr int kSteps = DH / 16;  // k-steps of S = Q K^T
  constexpr int kOutTiles = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + N * kStride;
  __nv_bfloat16* vs = ks + N * kStride;

  const int g = blockIdx.x;
  const size_t base = static_cast<size_t>(g) * N * DH;
  for (int c = threadIdx.x; c < N * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, off = r * kStride + (c % kChunks) * 8;
    const size_t src = base + static_cast<size_t>(c) * 8;
    cp_async16(qs + off, q + src);
    cp_async16(ks + off, k + src);
    cp_async16(vs + off, v + src);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = warp * 16 + gq, row1 = row0 + 8;
  // the warp's mask entries, read while the copies fly (0 on padded rows,
  // whose outputs are discarded; padded columns are set to -inf below)
  const float* m = mask + static_cast<size_t>(g % mask_groups) * N * N;
  float mk[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? row0 : row1, c = 8 * j + 2 * tq + (e & 1);
      mk[j][e] = r < N && c < N ? m[r * N + c] : 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp * 16 >= N) return;  // no query row of this warp is real

  // S = Q K^T: A = this warp's 16 q rows, B = k rows (keys) as columns
  uint32_t a[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int r = min(warp * 16 + (lane & 15), N - 1);
    ldmatrix_x4(a[kk], qs + r * kStride + kk * 16 + (lane >> 4) * 8);
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
      ldmatrix_x4(b, ks + key * kStride + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * jp], a[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], a[kk], b[2], b[3]);
    }
  }

  // scale, mask, softmax numerators in float32; rows gq and gq + 8 are
  // spread over the 4 lanes of a quad
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * tq + (e & 1);
      s[j][e] = c < N ? fmaf(s[j][e], scale, mk[j][e]) : -INFINITY;
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
  float o[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    // matrices (keys +0..7 / +8..15) x (dh cols of tile 2 dp / 2 dp + 1),
    // transposed into B fragments
    const int key = min(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8, N - 1);
#pragma unroll
    for (int dp = 0; dp < kOutTiles / 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + key * kStride + (2 * dp + (lane >> 4)) * 8);
      mma_bf16(o[2 * dp], pa, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
    }
  }

  // normalise, stage in this warp's own q rows (no other warp reads them),
  // then 16-byte stores of the real rows
  const float inv0 = 1.0f / sum0, inv1 = 1.0f / sum1;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int c = 8 * n + 2 * tq;
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(qs + row0 * kStride + c) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(qs + row1 * kStride + c) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  const int rows = min(16, N - warp * 16);
  for (int c = lane; c < rows * kChunks; c += 32) {
    const int r = warp * 16 + c / kChunks, col = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(out + base + static_cast<size_t>(r) * DH +
                              col) =
        *reinterpret_cast<const uint4*>(qs + r * kStride + col);
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* mask,
               void* out, int G, int N, int mask_groups, void* stream) {
  const size_t smem =
      3 * static_cast<size_t>(N) * (DH + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(window_attention_mma_kernel<DH>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_mma_kernel<DH><<<G, kMmaThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), N, mask_groups);
  return static_cast<int>(cudaGetLastError());
}

// launch_mma<dh> for dh = DH, DH + 16, ..., 128
template <int DH>
int dispatch_mma(const void* q, const void* k, const void* v,
                 const void* mask, void* out, int G, int N, int dh,
                 int mask_groups, void* stream) {
  if (dh == DH)
    return launch_mma<DH>(q, k, v, mask, out, G, N, mask_groups, stream);
  if constexpr (DH < 128)
    return dispatch_mma<DH + 16>(q, k, v, mask, out, G, N, dh, mask_groups,
                                 stream);
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int G, int N, int dh, int mask_groups, void* stream) {
  const size_t smem =
      (static_cast<size_t>(N) * (3 * dh + 1) + static_cast<size_t>(N) * N) *
      sizeof(float);
  cudaError_t err = allow_smem(window_attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_kernel<T><<<G, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), N, dh, mask_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: N <= 64 and dh a multiple of 16 up to 128 (the wrapper checks;
// cudaErrorInvalidValue otherwise).
extern "C" int window_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int G, int N, int dh,
                                     int mask_groups, void* stream) {
  if (N < 1 || N > 16 * kMmaWarps) return cudaErrorInvalidValue;
  return dispatch_mma<16>(q, k, v, mask, out, G, N, dh, mask_groups, stream);
}

extern "C" int window_attention_f32(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int G, int N, int dh,
                                    int mask_groups, void* stream) {
  return launch<float>(q, k, v, mask, out, G, N, dh, mask_groups, stream);
}
