// Weight-only int8 matmul: y = round_to_x_type((x @ W_q) * scale[col]).
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/quant.py::_dequant_matmul_pallas, which
// the int8 decoder (DecodeEngine(quantize=True), default route) runs in
// every projection of every decode step and in the head. x (M, K) is bf16
// (the layers) or float32 (the head); W_q (K, N) int8 with row stride ldw
// (a column slice of a wider matrix keeps its parent's stride); scale (N,)
// float32. The int8 -> bf16 / float32 conversion is exact (|w| <= 127), so
// for a bf16 x this is the TPU kernel's int8 -> bf16 cast and float32 dot.
// The sum is float32, times the column's scale, then rounded once to x's
// type. No bias: the caller adds it after the rounding.
//
// Bound on the H100: at decode shapes (M 16 or 50 rows, K 256 or 512, N
// 256-768) a call moves under 0.5 MB (the int8 weight dominates: 192 KB
// for the packed qkv), a few hundred nanoseconds at 3.35 TB/s, so the
// latency of one block's path from its first load to its last store sets
// the time; at the cross K/V projection (M 480 or 1500 rows of the encoder
// memory) the bytes of x and y. Design: every block issues all of its
// copies (16-byte cp.async, zero-filled past the edges) before its first
// wait, then computes from shared memory with no further round trip.
// - bf16 x, on the tensor cores: mma.sync.m16n8k16 with float32 sums. A
//   (x's rows) by ldmatrix from rows padded to 16 bytes past a 128-byte
//   multiple (no bank conflict). B is the int8 weight converted to bf16 in
//   registers, four bytes at a time (tc::i8x4_to_bf16x2): the weight
//   rows land in shared memory permuted within each 16-row k-step, so
//   that the four k rows of a lane's B fragment (2t, 2t + 1, 2t + 8,
//   2t + 9) are read in one pass by four consecutive rows (no bank
//   conflict), and a 4-byte transpose of 4 rows x NT columns (byte
//   permutes) gives each of the lane's NT columns its four k values as one
//   word. A warp's NT n8-tiles take columns NT g + j (g = lane / 4).
//   Tiles by shape (the fastest of eleven shapes timed on an H100 at each
//   served M): at M <= 64 (a decode step) a block takes 16 rows and 16
//   columns (32 where 16-column blocks would outnumber the SMs: the qkv
//   projection at 50 rows), and its 8 warps split K; at M > 64 (the cross
//   K/V projection) 32 rows and 32 columns, 4 warps splitting K for each
//   m16 tile. The warps' partial tiles meet in shared memory (N = 256 at
//   16 rows: 16 blocks).
// - float32 x (the head; no TF32): CUDA cores. A block takes 8 rows and
//   32 columns (a lane a column), its 8 warps split K: x's rows by 4-byte
//   cp.async into shared memory and each lane's weight bytes into
//   registers, all issued before the wait; the partial sums meet in shared
//   memory.
// Ragged edges take no separate path: rows past M, columns past N and k
// past K are zero-filled copies (the K of the bf16 tiles is padded to 16);
// an x whose rows are not 16-byte aligned (K not a multiple of 8) or a
// weight whose rows are not (the 138-column head, 138-byte rows) is staged
// element by element instead.
#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper
// What an entry returns for a shape the kernel does not take (a K whose
// staged operands exceed shared memory).
constexpr int kRefused = -1;

// The row of shared memory that holds weight row k: within each 16-row
// k-step, row 2t + e + 8 h (t = k / 2 % 4) goes to 4 (e + 2 h) + t, so
// that the rows of load i of a lane's B fragment are 4 i + t, t = 0..3.
__device__ __forceinline__ int permuted_row(int k) {
  return (k & ~15) + 4 * ((k & 1) + ((k >> 2) & 2)) + ((k >> 1) & 3);
}

// Row-stride in bytes of a staged x row of Kp bf16 values: a 128-byte
// multiple plus 16 (ldmatrix's 8 rows fall in 8 distinct bank groups).
__host__ __device__ inline int x_stride(int Kp) {
  return ((Kp * 2 + 127) & ~127) + 16;
}

// Bytes of shared memory of the bf16 kernel: x rows, the weight (Kp x BN
// bytes) and the partial tiles (KW x rows x (BN + 4) floats).
__host__ __device__ inline size_t mma_smem(int rows, int Kp, int BN, int KW) {
  return static_cast<size_t>(rows) * x_stride(Kp) +
         static_cast<size_t>(Kp) * BN +
         sizeof(float) * KW * rows * (BN + 4);
}

// The B fragments (b[j][0], b[j][1]) of one k-step for the lane's NT
// columns from the k-step's 16 permuted weight rows (row stride BN bytes):
// lane (g, t) reads bytes [NT g, NT g + NT) of rows 4 i + t, i = 0..3, and
// transposes them into one word a column (its k rows 2t, 2t + 1, 2t + 8,
// 2t + 9), converted to two bf16 pairs.
template <int NT>
__device__ __forceinline__ void load_b_i8(const unsigned char* rows, int BN,
                                          int lane, uint32_t (&b)[NT][2]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t col[NT];
  if constexpr (NT == 2) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint16_t*>(rows + (4 * i + t) * BN +
                                                2 * g);
    const uint32_t p01 = __byte_perm(r[0], r[1], 0x5410);
    const uint32_t p23 = __byte_perm(r[2], r[3], 0x5410);
    col[0] = __byte_perm(p01, p23, 0x6420);
    col[1] = __byte_perm(p01, p23, 0x7531);
  } else {
    static_assert(NT % 4 == 0, "2 or a multiple of 4 columns a lane");
#pragma unroll
    for (int q = 0; q < NT / 4; ++q) {
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(rows + (4 * i + t) * BN +
                                                  NT * g + 4 * q);
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      col[4 * q] = __byte_perm(t0, t2, 0x5410);
      col[4 * q + 1] = __byte_perm(t0, t2, 0x7632);
      col[4 * q + 2] = __byte_perm(t1, t3, 0x5410);
      col[4 * q + 3] = __byte_perm(t1, t3, 0x7632);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) tc::i8x4_to_bf16x2(col[j], b[j][0], b[j][1]);
}

// bf16 x. A block: MW m16-tiles of rows, NT * 8 columns; warp w takes the
// k-steps of part w % KW of m-tile w / KW. xvec: x's rows 16-byte aligned
// (K % 8 == 0 and an aligned x); wvec: the weight's rows 16-byte aligned.
template <int KW, int MW, int NT>
__global__ void __launch_bounds__(kThreads)
dequant_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N,
                   int ldw, int xvec, int wvec) {
  static_assert(KW * MW == kWarps, "the warps split K and the rows");
  constexpr int BN = NT * 8, RS = BN + 4, rows = MW * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Kp = (K + 15) & ~15, xs_stride = x_stride(Kp);
  unsigned char* xs = smem;
  unsigned char* ws = xs + static_cast<size_t>(rows) * xs_stride;
  float* red = reinterpret_cast<float*>(ws + static_cast<size_t>(Kp) * BN);
  const int m0 = blockIdx.y * rows, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // every copy of the block, then one wait
  if (xvec) {
    const int per = Kp / 8;  // 16-byte chunks a row
    int r = tid / per, c = tid - r * per;
    const int dr = kThreads / per, dc = kThreads - dr * per;
    while (r < rows) {
      const int m = m0 + r, k = c * 8;
      const int bytes = m < M ? 2 * max(0, min(8, K - k)) : 0;
      cp_async16_zfill(xs + r * xs_stride + c * 16,
                       bytes > 0 ? x + static_cast<size_t>(m) * K + k : x,
                       bytes);
      r += dr;
      c += dc;
      if (c >= per) {
        c -= per;
        ++r;
      }
    }
  } else {
    for (int i = tid; i < rows * Kp; i += kThreads) {
      const int r = i / Kp, k = i - r * Kp, m = m0 + r;
      reinterpret_cast<__nv_bfloat16*>(xs + r * xs_stride)[k] =
          m < M && k < K ? x[static_cast<size_t>(m) * K + k]
                         : __float2bfloat16(0.0f);
    }
  }
  if (wvec) {
    constexpr int per = BN / 16;
    for (int i = tid; i < Kp * per; i += kThreads) {
      const int k = i / per, c = i % per, n = n0 + c * 16;
      const int bytes = k < K ? max(0, min(16, N - n)) : 0;
      cp_async16_zfill(ws + permuted_row(k) * BN + c * 16,
                       bytes > 0 ? w + static_cast<size_t>(k) * ldw + n : w,
                       bytes);
    }
  } else {
    for (int i = tid; i < Kp * BN; i += kThreads) {
      const int k = i / BN, c = i % BN, n = n0 + c;
      ws[permuted_row(k) * BN + c] =
          k < K && n < N ? static_cast<unsigned char>(
                               w[static_cast<size_t>(k) * ldw + n])
                         : 0;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int kw = warp % KW, mw = warp / KW;
  const int steps = Kp / 16, per_part = (steps + KW - 1) / KW;
  const int s0 = kw * per_part, s1 = min(steps, s0 + per_part);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const unsigned char* arow =
      xs + (mw * 16 + (lane & 15)) * xs_stride + (lane >> 4) * 16;
  for (int s = s0; s < s1; ++s) {
    uint32_t b[NT][2], a[4];
    load_b_i8<NT>(ws + s * 16 * BN, BN, lane, b);
    tc::ldmatrix_x4(a, arow + s * 32);
#pragma unroll
    for (int j = 0; j < NT; ++j) tc::mma_bf16(acc[j], a, b[j][0], b[j][1]);
  }
  // partial tiles: logical column 2t (+1) of tile j is block column
  // NT (2t) + j (NT (2t + 1) + j)
  const int g = lane >> 2, t = lane & 3;
  float* part = red + (kw * rows + mw * 16 + g) * RS;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    part[NT * 2 * t + j] = acc[j][0];
    part[NT * (2 * t + 1) + j] = acc[j][1];
    part[8 * RS + NT * 2 * t + j] = acc[j][2];
    part[8 * RS + NT * (2 * t + 1) + j] = acc[j][3];
  }
  __syncthreads();
  for (int o = tid; o < rows * BN; o += kThreads) {
    const int r = o / BN, c = o % BN, m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float sum = 0.0f;
#pragma unroll
      for (int p = 0; p < KW; ++p) sum += red[(p * rows + r) * RS + c];
      y[static_cast<size_t>(m) * N + n] =
          __float2bfloat16(__fmul_rn(sum, scale[n]));
    }
  }
}

constexpr int kF32Rows = 8;     // rows of y a block (float32 x)
constexpr int kF32Cols = 32;    // columns a block: a lane a column
constexpr int kF32Chunk = 32;   // weight values a lane holds at once

// Shared memory of the float32 kernel: x's rows (Kp floats each) and the
// partial sums (kWarps x rows x 32 floats).
__host__ __device__ inline size_t f32_smem(int Kp) {
  return sizeof(float) * (kF32Rows * Kp + kWarps * kF32Rows * kF32Cols);
}

// float32 x: warp w sums k in [w kc, (w + 1) kc), kc a multiple of 4.
__global__ void __launch_bounds__(kThreads)
dequant_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ y,
                   int M, int K, int N, int ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Kp = (K + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem);
  float* red = xs + kF32Rows * Kp;
  const int m0 = blockIdx.y * kF32Rows, n0 = blockIdx.x * kF32Cols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kF32Rows * Kp; i += kThreads) {
    const int r = i / Kp, k = i - r * Kp, m = m0 + r;
    const bool in = m < M && k < K;
    cp_async4_zfill(xs + i, in ? x + static_cast<size_t>(m) * K + k : x,
                    in ? 4 : 0);
  }
  const int kc = ((K + kWarps - 1) / kWarps + 3) & ~3;
  const int k0 = warp * kc, k1 = min(K, k0 + kc);
  const int n = n0 + lane;
  float acc[kF32Rows], wv[kF32Chunk];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) acc[r] = 0.0f;
  // the lane's weight values of k in [kb, kb + kF32Chunk) of its part
  const auto load_w = [&](int kb) {
#pragma unroll
    for (int j = 0; j < kF32Chunk; ++j) {
      const int k = kb + j;
      wv[j] = k < k1 && n < N
                  ? static_cast<float>(w[static_cast<size_t>(k) * ldw + n])
                  : 0.0f;
    }
  };
  load_w(k0);  // in flight with x's copies
  cp_async_wait_all();
  __syncthreads();
  for (int kb = k0; kb < k1; kb += kF32Chunk) {
    if (kb != k0) load_w(kb);
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const float* xr = xs + r * Kp + kb;
#pragma unroll
      for (int j = 0; j < kF32Chunk; j += 4) {
        if (kb + j < k1) {  // past K: zeros on both sides
          const float4 xv = *reinterpret_cast<const float4*>(xr + j);
          acc[r] = fmaf(xv.x, wv[j], acc[r]);
          acc[r] = fmaf(xv.y, wv[j + 1], acc[r]);
          acc[r] = fmaf(xv.z, wv[j + 2], acc[r]);
          acc[r] = fmaf(xv.w, wv[j + 3], acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r)
    red[(warp * kF32Rows + r) * kF32Cols + lane] = acc[r];
  __syncthreads();
  {
    const int r = tid / kF32Cols, c = tid % kF32Cols;
    const int m = m0 + r, col = n0 + c;
    if (m < M && col < N) {
      float sum = 0.0f;
#pragma unroll
      for (int p = 0; p < kWarps; ++p)
        sum += red[(p * kF32Rows + r) * kF32Cols + c];
      y[static_cast<size_t>(m) * N + col] = __fmul_rn(sum, scale[col]);
    }
  }
}

// Allow a kernel up to kSmemMax bytes of dynamic shared memory (once).
template <typename Kernel>
cudaError_t allow_all_smem(Kernel kernel, std::atomic<bool>* done) {
  if (done->load()) return cudaSuccess;
  // threads that race both set the same attribute
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemMax));
  if (err == cudaSuccess) done->store(true);
  return err;
}

template <int KW, int MW, int NT>
int launch_mma(const void* x, const void* w, const void* scale, void* y,
               int M, int K, int N, int ldw, cudaStream_t st) {
  static std::atomic<bool> attr{false};
  auto kernel = dequant_mma_kernel<KW, MW, NT>;
  const int rows = MW * 16, Kp = (K + 15) & ~15;
  const size_t smem = mma_smem(rows, Kp, NT * 8, KW);
  if (smem > kSmemMax) return kRefused;
  cudaError_t err = allow_all_smem(kernel, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  const int xvec = K % 8 == 0 && xp % 16 == 0;
  const int wvec = ldw % 16 == 0 && wp % 16 == 0;
  const dim3 grid((N + NT * 8 - 1) / (NT * 8), (M + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M,
      K, N, ldw, xvec, wvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry returns 0, a cudaError, or kRefused (-1) for a K the kernel
// does not stage (shared memory).
extern "C" int dequant_matmul_bf16(const void* x, const void* w,
                                   const void* scale, void* y, int M, int K,
                                   int N, int ldw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 64)  // the cross K/V projection: 32 rows x 32 columns a block
    return launch_mma<4, 2, 4>(x, w, scale, y, M, K, N, ldw, st);
  // a decode step: 16 rows x 16 columns a block, K over its 8 warps; 32
  // columns where 16-column blocks would outnumber the SMs (a second wave)
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((N + 15) / 16 * ((M + 15) / 16) > sms)
    return launch_mma<kWarps, 1, 4>(x, w, scale, y, M, K, N, ldw, st);
  return launch_mma<kWarps, 1, 2>(x, w, scale, y, M, K, N, ldw, st);
}

extern "C" int dequant_matmul_f32(const void* x, const void* w,
                                  const void* scale, void* y, int M, int K,
                                  int N, int ldw, void* stream) {
  static std::atomic<bool> attr{false};
  const size_t smem = f32_smem((K + 3) & ~3);
  if (smem > kSmemMax) return kRefused;
  cudaError_t err = allow_all_smem(dequant_f32_kernel, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kF32Cols - 1) / kF32Cols,
                  (M + kF32Rows - 1) / kF32Rows);
  dequant_f32_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), M, K, N,
      ldw);
  return static_cast<int>(cudaGetLastError());
}
