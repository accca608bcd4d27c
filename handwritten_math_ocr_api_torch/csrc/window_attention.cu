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
// owns 16 query rows against all keys: window_attend.cuh's attend_rows
// (S = Q K^T, the scale and mask, softmax and O = P V on the tensor cores;
// rows N..63 are never copied, their addresses clamped to row N - 1). O is
// divided by the float32 row sum, staged in the warp's own q rows and
// written out as 16-byte stores, rows < N only. Shared memory is
// 3 * N * (dh + 8) * 2 bytes (11.8 KB at Swin-T's shapes), so several
// groups are in flight on each SM.
//
// float32 (window_attention_kernel): the CUDA-core version, one block per
// group; q (pre-scaled), k (rows padded by one float against bank
// conflicts) and v staged in shared memory as float32, the (N, N) logits
// kept in the block, one warp normalising each row.
#include "common.cuh"
#include "window_attend.cuh"

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
  constexpr int kOutTiles = DH / 8;
  constexpr int kKeyTiles = wattn::kKeyTiles;
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
  // whose outputs are discarded; padded columns are set to -inf)
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

  float o[kOutTiles][4], inv0, inv1;
  wattn::attend_rows<DH>(
      qs, ks, vs, kStride, N, warp,
      [&](int j, int e, int, int) { return mk[j][e]; }, o, inv0, inv1);

  // normalise, stage in this warp's own q rows (no other warp reads them),
  // then 16-byte stores of the real rows
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int c = 8 * n + 2 * tq;
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(qs + row0 * kStride + c) =
          tc::pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(qs + row1 * kStride + c) =
          tc::pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
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
