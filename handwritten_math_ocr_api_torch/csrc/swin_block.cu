// A whole pre-norm Swin block in one launch.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/swin_block.py::fused_swin_block
// (_block_kernel). It computes models/swin.py::swin_block, the function
// that kernel's docstring names:
//   xn  = LN1(x), zero-padded to window multiples and rolled by -shift
//   per window and head: softmax(q k^T / sqrt(dh) + rel-bias + shift mask
//                        (-100 between regions)) v
//   x1  = x + (attn W_o + b_o)
//   out = x1 + fc2(gelu_tanh(fc1(LN2(x1))))
// Unlike the TPU kernel, which pads x before LN1, the padded tokens are
// zeros at the qkv input (their keys are b_k, their values b_v, and they
// are not masked), as in swin_block and torchvision. Rounding points follow
// the TPU kernel: LN outputs, qkv, the attention output, proj, x1, the
// GELU output and fc2 are rounded to the storage type; every product
// accumulates in float32; the four biases (qkv, proj, fc1, fc2) come in
// float32 and are added in float32, as the TPU kernel adds them; LN and
// softmax are float32.
//
// Bound on the H100: operations. Per token the block does about
// 24 C^2 flops against 4 C bytes in and out, so every stage of Swin-T is
// far above the card's ~295 bf16 flops per byte. This first version runs
// its products on the CUDA cores in float32, well below the tensor-core
// bound. Design: one block per (image, window) of ws*ws tokens. The block
// gathers its tokens straight from the unpadded map (the pad and the roll
// are index arithmetic), keeps every intermediate in shared memory as
// float32, and writes only the block's real tokens. Products read their
// left operand from shared memory and their weights from device memory
// (L2-resident: at most 4.7 MB a stage) as 16-byte vectors; each thread
// owns a 4-row by 8-column (bf16) tile. The qkv of a group of G heads and
// the MLP hidden layer in chunks of hc columns bound the scratch, so
// stage 3 (C = 384) fits in the 227 KB a block may use.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows of the left operand in a thread's tile

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// epi(m, n, sum_k A[m, k] W[k, col(n)]) for m < M, n < N. A: M x K floats
// in shared memory, row stride lda; lda and K multiples of 4. W: rows of
// ldw elements in device memory. col(n) = base + (n / seg) * seg_stride +
// n % seg: one run of columns, or the q, k and v runs of a head group.
template <typename T, typename Epi>
__device__ void mm(const float* A, int lda, int M, int K,
                   const T* __restrict__ W, int ldw, int base, int seg,
                   int seg_stride, int N, Epi epi) {
  constexpr int V = Vec<T>::N;
  const int ncv = N / V;
  const int nrg = (M + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < ncv * nrg; item += kThreads) {
    const int cv = item % ncv, rg = item / ncv;
    const int n0 = cv * V, m0 = rg * kRows;
    const T* w = W + base + (n0 / seg) * seg_stride + n0 % seg;
    const float* a[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = A + min(m0 + r, M - 1) * lda;
    float acc[kRows][V];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[r][j] = 0.0f;
    for (int k = 0; k < K; k += 4) {
      float wv[4][V];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        load_vec(w + static_cast<size_t>(k + kk) * ldw, wv[kk]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(a[r] + k);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float s = acc[r][j];
          s = fmaf(av.x, wv[0][j], s);
          s = fmaf(av.y, wv[1][j], s);
          s = fmaf(av.z, wv[2][j], s);
          acc[r][j] = fmaf(av.w, wv[3][j], s);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (m0 + r < M)
#pragma unroll
        for (int j = 0; j < V; ++j) epi(m0 + r, n0 + j, acc[r][j]);
  }
}

// dst[i] = round(LN(src[i]) * g + b) for the real tokens of the window
// (src_of[i] >= 0), zeros for the padded ones; one warp per token.
template <typename T, typename Load>
__device__ void token_layer_norm(Load load, const int* src_of, int N, int C,
                                 const float* __restrict__ g,
                                 const float* __restrict__ b, float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < N; i += kWarps) {
    float* row = dst + i * C;
    if (src_of[i] < 0) {
      for (int c = lane; c < C; c += 32) row[c] = 0.0f;
      continue;
    }
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float v = load(i, c);
      row[c] = v;
      s += v;
    }
    const float mean = warp_sum(s) / C;
    float q = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / C + 1e-5f);
    for (int c = lane; c < C; c += 32)
      row[c] = round_to<T>((row[c] - mean) * inv * g[c] + b[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swin_block_kernel(const T* __restrict__ x, const float* __restrict__ g1,
                  const float* __restrict__ be1, const T* __restrict__ w_qkv,
                  const float* __restrict__ b_qkv,
                  const float* __restrict__ table, const T* __restrict__ w_o,
                  const float* __restrict__ b_o, const float* __restrict__ g2,
                  const float* __restrict__ be2, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, T* __restrict__ out, int H,
                  int W,
                  int C, int nh, int hid, int ws, int shift_h, int shift_w,
                  int G, int hc) {
  extern __shared__ float smem[];
  const int N = ws * ws;
  const int dh = C / nh;
  const int Hp = (H + ws - 1) / ws * ws, Wp = (W + ws - 1) / ws * ws;
  const int nWw = Wp / ws, nW = (Hp / ws) * nWw;
  const int b = blockIdx.x / nW, win = blockIdx.x % nW;
  const int gq = G * dh;         // columns of q (or k, or v) of a head group
  const int ldq = 3 * gq + 1;    // +1: neighbouring keys in other banks
  int* src_of = reinterpret_cast<int*>(smem);  // token -> index in x, or -1
  int* region = src_of + N;                    // shift-mask region
  float* bufA = smem + ((2 * N + 3) & ~3);     // N x C
  float* bufB = bufA + N * C;                  // N x C
  float* scr = bufB + N * C;                   // qkv of a head group, or
  float* logits = scr + N * ldq;               // N x N; or an MLP chunk
  const T* xb = x + static_cast<size_t>(b) * H * W * C;
  T* ob = out + static_cast<size_t>(b) * H * W * C;

  for (int i = threadIdx.x; i < N; i += kThreads) {
    // (r, c) in the padded map rolled by -shift; (oh, ow) before the roll
    const int r = (win / nWw) * ws + i / ws, c = (win % nWw) * ws + i % ws;
    const int oh = (r + shift_h) % Hp, ow = (c + shift_w) % Wp;
    src_of[i] = (oh < H && ow < W) ? oh * W + ow : -1;
    const int rh = r < Hp - ws ? 0 : (r < Hp - shift_h ? 1 : 2);
    const int rw = c < Wp - ws ? 0 : (c < Wp - shift_w ? 1 : 2);
    region[i] = rh * 3 + rw;
  }
  __syncthreads();

  // LN1 on the real tokens; padded tokens are zeros
  token_layer_norm<T>(
      [&](int i, int c) {
        return to_f32(xb[static_cast<size_t>(src_of[i]) * C + c]);
      },
      src_of, N, C, g1, be1, bufA);
  __syncthreads();

  // windowed attention, G heads at a time; output (rounded) into bufB
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  const bool shifted = shift_h > 0 || shift_w > 0;
  const int span = 2 * ws - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h0 = 0; h0 < nh; h0 += G) {
    mm<T>(bufA, C, N, C, w_qkv, 3 * C, h0 * dh, gq, C, 3 * gq,
          [&](int m, int n, float acc) {
            const int part = n / gq;
            const int col = part * C + h0 * dh + n - part * gq;
            const float v = round_to<T>(acc + b_qkv[col]);
            scr[m * ldq + n] = part == 0 ? v * scale : v;
          });
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      const int h = h0 + g;
      const float* qg = scr + g * dh;
      const float* kg = scr + gq + g * dh;
      const float* vg = scr + 2 * gq + g * dh;
      for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
        const int i = idx / N, j = idx - i * N;
        const float* qi = qg + i * ldq;
        const float* kj = kg + j * ldq;
        float acc = 0.0f;
        for (int d = 0; d < dh; ++d) acc = fmaf(qi[d], kj[d], acc);
        const int rel = (i / ws - j / ws + ws - 1) * span +
                        (i % ws - j % ws + ws - 1);
        float v = acc + table[rel * nh + h];
        if (shifted && region[i] != region[j]) v += -100.0f;
        logits[idx] = v;
      }
      __syncthreads();
      for (int i = warp; i < N; i += kWarps) {
        float* row = logits + i * N;
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
      for (int idx = threadIdx.x; idx < N * dh; idx += kThreads) {
        const int i = idx / dh, d = idx - i * dh;
        const float* p = logits + i * N;
        float acc = 0.0f;
        for (int j = 0; j < N; ++j) acc = fmaf(p[j], vg[j * ldq + d], acc);
        bufB[i * C + h * dh + d] = round_to<T>(acc);
      }
      __syncthreads();
    }
  }

  // proj + residual: x1 into bufA and, for the real tokens, into out
  mm<T>(bufB, C, N, C, w_o, C, 0, C, 0, C, [&](int m, int n, float acc) {
    const int s = src_of[m];
    if (s < 0) return;
    const size_t at = static_cast<size_t>(s) * C + n;
    const float proj = round_to<T>(acc + b_o[n]);
    const T x1 = from_f32<T>(to_f32(xb[at]) + proj);
    ob[at] = x1;
    bufA[m * C + n] = to_f32(x1);
  });
  __syncthreads();

  // LN2 into bufB; bufA becomes the fc2 accumulator
  token_layer_norm<T>([&](int i, int c) { return bufA[i * C + c]; }, src_of,
                      N, C, g2, be2, bufB);
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) bufA[idx] = 0.0f;
  __syncthreads();

  // MLP in chunks of hc hidden columns
  for (int c0 = 0; c0 < hid; c0 += hc) {
    mm<T>(bufB, C, N, C, w1, hid, c0, hc, 0, hc,
          [&](int m, int n, float acc) {
            scr[m * hc + n] =
                round_to<T>(gelu_tanh(acc + b1[c0 + n]));
          });
    __syncthreads();
    mm<T>(scr, hc, N, hc, w2 + static_cast<size_t>(c0) * C, C, 0, C, 0, C,
          [&](int m, int n, float acc) { bufA[m * C + n] += acc; });
    __syncthreads();
  }

  // out = x1 + round(fc2 + b2) on the real tokens
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) {
    const int m = idx / C, n = idx - m * C;
    const int s = src_of[m];
    if (s < 0) continue;
    T* o = ob + static_cast<size_t>(s) * C + n;
    const float h2 = round_to<T>(bufA[idx] + b2[n]);
    *o = from_f32<T>(to_f32(*o) + h2);
  }
}

template <typename T>
int launch(const void* x, const void* g1, const void* be1,
           const void* w_qkv, const void* b_qkv, const void* table,
           const void* w_o, const void* b_o, const void* g2,
           const void* be2, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int B, int H, int W, int C, int nh,
           int hid, int ws, int shift_h, int shift_w, int G, int hc,
           int smem, void* stream) {
  cudaError_t err = allow_smem(swin_block_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = ((H + ws - 1) / ws) * ((W + ws - 1) / ws);
  using CT = const T*;
  using CF = const float*;
  swin_block_kernel<T><<<B * windows, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<CT>(x), static_cast<CF>(g1), static_cast<CF>(be1),
      static_cast<CT>(w_qkv), static_cast<CF>(b_qkv),
      static_cast<CF>(table), static_cast<CT>(w_o), static_cast<CF>(b_o),
      static_cast<CF>(g2), static_cast<CF>(be2), static_cast<CT>(w1),
      static_cast<CF>(b1), static_cast<CT>(w2), static_cast<CF>(b2),
      static_cast<T*>(out), H, W, C, nh, hid, ws, shift_h, shift_w, G, hc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SWIN_BLOCK_ENTRY(NAME, TYPE)                                         \
  extern "C" int NAME(const void* x, const void* g1, const void* be1,        \
                      const void* w_qkv, const void* b_qkv,                  \
                      const void* table, const void* w_o, const void* b_o,   \
                      const void* g2, const void* be2, const void* w1,       \
                      const void* b1, const void* w2, const void* b2,        \
                      void* out, int B, int H, int W, int C, int nh,         \
                      int hid, int ws, int shift_h, int shift_w, int G,      \
                      int hc, int smem, void* stream) {                      \
    return launch<TYPE>(x, g1, be1, w_qkv, b_qkv, table, w_o, b_o, g2, be2,  \
                        w1, b1, w2, b2, out, B, H, W, C, nh, hid, ws,        \
                        shift_h, shift_w, G, hc, smem, stream);              \
  }

SWIN_BLOCK_ENTRY(swin_block_bf16, __nv_bfloat16)
SWIN_BLOCK_ENTRY(swin_block_f32, float)
