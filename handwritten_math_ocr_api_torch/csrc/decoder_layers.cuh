// The decoder layers of one step for one row, shared by the decode-step
// kernels: fused_step.cu (B1, one position for the batch) and
// ragged_step.cu (B7, a position per row).
//
// One block of kThreads threads runs every post-norm layer of one
// row, the row in shared memory in float32:
//   per layer l:
//     q, k, v = x W_qkv + b_qkv;  k, v -> k_new[l, row], v_new[l, row]
//     x = LN1(x + (attn(q, self cache[:pos] + fresh row) W_out + b_out))
//     x = LN2(x + (attn(x W_cq + b_cq, cross K/V) W_co + b_co))
//     x = LN3(x + (relu(x W_ff1 + b_ff1) W_ff2 + b_ff2))
// with the TPU kernels' numerics: every matmul input rounded to the weight
// type and accumulated in float32, float32 biases, LayerNorm and softmax,
// the fresh K/V row rounded to the cache type before it joins attention at
// slot pos, and no slot after pos read (the TPU kernels' -inf mask). The
// caches are read only; the caller appends k_new and v_new.
//
// Weight rows stream from device memory (L2 after the first block reads
// them) as 16-byte vectors, each thread owning 8 (bf16) or 4 (float32)
// adjacent columns and a slice of the reduction, partial sums meeting in
// shared memory.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace decoder {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Sum over the block; every thread gets the total. scratch: kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call may still read scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? scratch[lane] : 0.0f);
}

// y[n] = bias[n] + sum_k x[k] W[k, n]; x (K floats) in shared memory,
// W (K, N) row-major in device memory, N a multiple of the vector width.
template <typename T>
__device__ void matvec(const float* x, const T* __restrict__ W,
                       const float* __restrict__ bias, float* y, int K,
                       int N, float* red) {
  constexpr int V = Vec<T>::N;
  const int ncv = N / V;
  const int kparts = ncv >= kThreads ? 1 : kThreads / ncv;
  const int kchunk = (K + kparts - 1) / kparts;
  for (int item = threadIdx.x; item < ncv * kparts; item += kThreads) {
    const int cv = item % ncv, kp = item / ncv;
    const int k0 = kp * kchunk, k1 = min(K, k0 + kchunk);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    for (int k = k0; k < k1; ++k) {
      float w[V];
      load_vec(W + static_cast<size_t>(k) * N + cv * V, w);
      const float xv = x[k];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(xv, w[j], acc[j]);
    }
    float* r = red + static_cast<size_t>(kp) * N + cv * V;
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = acc[j];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float s = 0.0f;
    for (int kp = 0; kp < kparts; ++kp) s += red[kp * N + n];
    y[n] = s + bias[n];
  }
  __syncthreads();
}

// x = LayerNorm(x + y) * g + b over D values in shared memory (eps 1e-5).
__device__ __forceinline__ void add_layer_norm(float* x, const float* y,
                                               const float* __restrict__ g,
                                               const float* __restrict__ b,
                                               int D, float* scratch) {
  float s = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = x[d] + y[d];
    x[d] = v;
    s += v;
  }
  const float mean = block_sum(s, scratch) / D;
  float q = 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float c = x[d] - mean;
    q += c * c;
  }
  const float inv = rsqrtf(block_sum(q, scratch) / D + 1e-5f);
  for (int d = threadIdx.x; d < D; d += kThreads)
    x[d] = (x[d] - mean) * inv * g[d] + b[d];
  __syncthreads();
}

// Multi-head single-query attention. q (D floats, pre-scaled) in shared
// memory; rows s < n_cache of K and V (row stride D) in device memory; if
// fresh_k is given, row n_cache is fresh_k / fresh_v (shared memory).
// out[d] (rounded to T) = sum_s softmax_s(q_h . k_s) v_s[d], h = d / dh.
template <typename T>
__device__ void attend(const float* q, const T* __restrict__ K,
                       const T* __restrict__ Vv, int n_cache,
                       const float* fresh_k, const float* fresh_v, int D,
                       int H, float* logits, int lstride, float* out,
                       float* red) {
  constexpr int V = Vec<T>::N;
  const int dh = D / H;
  const int n = n_cache + (fresh_k != nullptr ? 1 : 0);
  for (int item = threadIdx.x; item < n * H; item += kThreads) {
    const int s = item / H, h = item - s * H;
    const float* qh = q + h * dh;
    float acc = 0.0f;
    if (s < n_cache) {
      const T* kr = K + static_cast<size_t>(s) * D + h * dh;
      for (int d = 0; d < dh; d += V) {
        float kv[V];
        load_vec(kr + d, kv);
#pragma unroll
        for (int j = 0; j < V; ++j) acc = fmaf(qh[d + j], kv[j], acc);
      }
    } else {
      const float* kr = fresh_k + h * dh;
      for (int d = 0; d < dh; ++d) acc = fmaf(qh[d], kr[d], acc);
    }
    logits[h * lstride + s] = acc;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < H; h += kWarps) {
    float* row = logits + h * lstride;
    float mx = -INFINITY;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(row[s] - mx);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < n; s += 32) row[s] = row[s] / sum;
  }
  __syncthreads();
  // groups of D threads split the slots; partial sums meet in red
  const int groups = D >= kThreads ? 1 : kThreads / D;
  const int per = (n + groups - 1) / groups;
  for (int item = threadIdx.x; item < D * groups; item += kThreads) {
    const int d = item % D, g = item / D;
    const float* p = logits + (d / dh) * lstride;
    const int s1 = min(n, (g + 1) * per);
    float acc = 0.0f;
    for (int s = g * per; s < s1; ++s) {
      const float v = s < n_cache
                          ? to_f32(Vv[static_cast<size_t>(s) * D + d])
                          : fresh_v[d];
      acc = fmaf(p[s], v, acc);
    }
    red[g * D + d] = acc;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += red[g * D + d];
    out[d] = round_to<T>(s);
  }
  __syncthreads();
}

// The stacked weights of every layer (build_stacked's bundle): weights
// (L, K, N) in the storage type, biases (L, 1, N) and LayerNorm (L, 6, D)
// in float32.
template <typename T>
struct Weights {
  const T* w_qkv;
  const float* b_qkv;
  const T* w_out;
  const float* b_out;
  const T* w_cq;
  const float* b_cq;
  const T* w_co;
  const float* b_co;
  const T* w_ff1;
  const float* b_ff1;
  const T* w_ff2;
  const float* b_ff2;
  const float* ln;
};

// Floats of the partial-sum region: matvec's kparts x N and attend's
// groups x D.
template <typename T>
__host__ __device__ inline int red_floats(int D, int F) {
  const int a = kThreads * Vec<T>::N, b = 3 * D > F ? 3 * D : F;
  return a > b ? a : b;
}

// Shared memory of one block (the regions of Smem), in floats, for D, F,
// H and a logits row of lstride slots (at least the longest horizon + 1
// and L_enc).
template <typename T>
__host__ inline size_t smem_floats(int D, int F, int H, size_t lstride) {
  return 32 + D + std::max(D, F) + std::max(3 * D, F) + H * lstride +
         red_floats<T>(D, F);
}

// Scratch regions carved from the block's shared memory (smem_floats).
struct Smem {
  float* scratch;  // kWarps floats (32 kept)
  float* x;        // D: the row, float32
  float* xr;       // max(D, F): matmul input
  float* y;        // max(3D, F): matmul output
  float* logits;   // H x lstride
  float* red;      // partial sums
  __device__ Smem(float* smem, int D, int F, int H, int lstride) {
    scratch = smem;
    x = scratch + 32;
    xr = x + D;
    y = xr + max(D, F);
    logits = y + max(3 * D, F);
    red = logits + H * lstride;
  }
};

// Every layer of one row: s.x holds the layer-0 input (float32) on entry
// and the last layer's output on return. The row's caches are
// self_k/self_v + ((l * B + row) * Tc) * D and cross_k/cross_v +
// ((l * B + row) * L_enc) * D; it attends self slots [0, pos) and its
// fresh row at pos. Its fresh K/V rows go to k_new/v_new[(l * B + row)].
template <typename T>
__device__ void run_layers(const Weights<T>& w, const T* __restrict__ self_k,
                           const T* __restrict__ self_v,
                           const T* __restrict__ cross_k,
                           const T* __restrict__ cross_v,
                           T* __restrict__ k_new, T* __restrict__ v_new,
                           int L, int B, int row_index, int Tc, int D, int H,
                           int F, int L_enc, int pos, int lstride,
                           const Smem& s) {
  const int N3 = 3 * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D / H));
  float* x = s.x;
  float* xr = s.xr;
  float* y = s.y;
  for (int l = 0; l < L; ++l) {
    const float* lnl = w.ln + static_cast<size_t>(l) * 6 * D;
    const size_t row = static_cast<size_t>(l) * B + row_index;

    // self-attention over the cache prefix and the fresh row
    for (int d = threadIdx.x; d < D; d += kThreads) xr[d] = round_to<T>(x[d]);
    __syncthreads();
    matvec<T>(xr, w.w_qkv + static_cast<size_t>(l) * D * N3,
              w.b_qkv + static_cast<size_t>(l) * N3, y, D, N3, s.red);
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const T k = from_f32<T>(y[D + d]), v = from_f32<T>(y[2 * D + d]);
      k_new[row * D + d] = k;
      v_new[row * D + d] = v;
      y[d] *= scale;
      y[D + d] = to_f32(k);
      y[2 * D + d] = to_f32(v);
    }
    __syncthreads();
    attend<T>(y, self_k + row * Tc * D, self_v + row * Tc * D, pos, y + D,
              y + 2 * D, D, H, s.logits, lstride, xr, s.red);
    matvec<T>(xr, w.w_out + static_cast<size_t>(l) * D * D,
              w.b_out + static_cast<size_t>(l) * D, y, D, D, s.red);
    add_layer_norm(x, y, lnl, lnl + D, D, s.scratch);

    // cross-attention over the encoder K/V
    for (int d = threadIdx.x; d < D; d += kThreads) xr[d] = round_to<T>(x[d]);
    __syncthreads();
    matvec<T>(xr, w.w_cq + static_cast<size_t>(l) * D * D,
              w.b_cq + static_cast<size_t>(l) * D, y, D, D, s.red);
    for (int d = threadIdx.x; d < D; d += kThreads) y[d] *= scale;
    __syncthreads();
    attend<T>(y, cross_k + row * L_enc * D, cross_v + row * L_enc * D, L_enc,
              nullptr, nullptr, D, H, s.logits, lstride, xr, s.red);
    matvec<T>(xr, w.w_co + static_cast<size_t>(l) * D * D,
              w.b_co + static_cast<size_t>(l) * D, y, D, D, s.red);
    add_layer_norm(x, y, lnl + 2 * D, lnl + 3 * D, D, s.scratch);

    // ReLU FFN
    for (int d = threadIdx.x; d < D; d += kThreads) xr[d] = round_to<T>(x[d]);
    __syncthreads();
    matvec<T>(xr, w.w_ff1 + static_cast<size_t>(l) * D * F,
              w.b_ff1 + static_cast<size_t>(l) * F, y, D, F, s.red);
    for (int f = threadIdx.x; f < F; f += kThreads)
      xr[f] = round_to<T>(fmaxf(y[f], 0.0f));
    __syncthreads();
    matvec<T>(xr, w.w_ff2 + static_cast<size_t>(l) * F * D,
              w.b_ff2 + static_cast<size_t>(l) * D, y, F, D, s.red);
    add_layer_norm(x, y, lnl + 4 * D, lnl + 5 * D, D, s.scratch);
  }
}

}  // namespace decoder
