// The decoder layers of one step for one row, and the float32 output head,
// shared by the one-block-a-row decode-step kernels, which now serve B10
// and B12 only: whole_step.cu (B10) and whole_decode.cu (B12, every step
// of a decode). B1, B11 (fused_step.cu) and B7 (ragged_step.cu, a position
// per row) run the cluster layer code of decoder_cluster.cuh instead; both
// take their operand types from decoder_types.cuh.
//
// One block of kThreads threads runs every post-norm layer of one
// row, the row in shared memory in float32:
//   per layer l:
//     q, k, v = x W_qkv + b_qkv;  k, v -> k_new[l, row], v_new[l, row]
//     x = LN1(x + (attn(q, self cache[:pos] + fresh row) W_out + b_out))
//     x = LN2(x + (attn(x W_cq + b_cq, cross K/V) W_co + b_co))
//     x = LN3(x + (relu(x W_ff1 + b_ff1) W_ff2 + b_ff2))
// with the TPU kernels' numerics: every matmul input rounded to the
// matmul input type and accumulated in float32, float32 biases, LayerNorm
// and softmax, the fresh K/V row rounded to the cache type before it joins
// attention at slot pos (B12 attends it unrounded, in float32, as its TPU
// kernel does), and no slot after pos read (the TPU kernels' -inf mask).
// The fresh rows go where FreshRows says: to (L, B, D) outputs that the
// caller appends (B10 "v3"), or into the self cache at slot pos, in place
// (B10 "v4", B12). The self cache is batch-major
// (L, B, T, D) or time-major (L, T, B, D) (CacheLayout). Its pointers carry
// no __restrict__: B12 reads in one step the slot it wrote in the step
// before, which the read-only data path may not serve.
//
// Three types: W the weights, C the caches (and the step's activation
// dtype), X the matmul inputs. The bf16 and float32 bundles have
// W = C = X. The int8 bundle (quantize_stacked, the TPU kernels'
// "quantized" mode) has W = int8 with a float32 scale per output column,
// X = bf16 whatever C is (the TPU kernels' x.astype(bfloat16) @
// w.astype(bfloat16)), and the scale multiplies the float32 sum before
// the bias is added.
//
// Weight rows stream from device memory (L2 after the first block reads
// them) as 16-byte vectors, each thread owning 16 (int8), 8 (bf16) or 4
// (float32) adjacent columns and a slice of the reduction, partial sums
// meeting in shared memory.
#pragma once

#include <algorithm>
#include <type_traits>

#include "decoder_types.cuh"

namespace decoder {

// The kernels launch kThreads threads a block, declared as
// __launch_bounds__(kThreads, 1): with no minimum of blocks an SM, ptxas
// capped some entries at 64 registers and spilled (a bf16 entry among
// them); with one block an SM each entry fits in at most 128, unspilled.
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

// y[n] = (sum_k x[k] W[k, n]) * scale[n] + bias[n] (no scale if null);
// x (K floats) in shared memory, W (K, N) row-major in device memory, N a
// multiple of the vector width.
template <typename W>
__device__ void matvec(const float* x, const W* __restrict__ Wt,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, float* y, int K,
                       int N, float* red) {
  constexpr int V = Vec<W>::N;
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
      load_vec(Wt + static_cast<size_t>(k) * N + cv * V, w);
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
    y[n] = (scale != nullptr ? __fmul_rn(s, scale[n]) : s) + bias[n];
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
// memory; rows s < n_cache of K and V (row stride ``stride`` elements) in
// device memory; if fresh_k is given, row n_cache is fresh_k / fresh_v
// (shared memory). out[d] (rounded to X, the next matmul's input type) =
// sum_s softmax_s(q_h . k_s) v_s[d], h = d / dh. C is the cache type.
template <typename C, typename X>
__device__ void attend(const float* q, const C* K, const C* Vv,
                       size_t stride, int n_cache, const float* fresh_k,
                       const float* fresh_v, int D, int H, float* logits,
                       int lstride, float* out, float* red) {
  constexpr int V = Vec<C>::N;
  const int dh = D / H;
  const int n = n_cache + (fresh_k != nullptr ? 1 : 0);
  for (int item = threadIdx.x; item < n * H; item += kThreads) {
    const int s = item / H, h = item - s * H;
    const float* qh = q + h * dh;
    float acc = 0.0f;
    if (s < n_cache) {
      const C* kr = K + s * stride + h * dh;
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
      const float v =
          s < n_cache ? to_f32(Vv[s * stride + d]) : fresh_v[d];
      acc = fmaf(p[s], v, acc);
    }
    red[g * D + d] = acc;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += red[g * D + d];
    out[d] = round_to<X>(s);
  }
  __syncthreads();
}

// Layer l's matvec of a stacked weight: y = x W_l (* s_l) + b_l, K x N.
// The Linear comes by value, so no address of a kernel parameter is taken.
template <typename W>
__device__ __forceinline__ void layer_matvec(Linear<W> lin, int l,
                                             const float* x, float* y, int K,
                                             int N, float* red) {
  const size_t n = static_cast<size_t>(l) * N;
  matvec<W>(x, lin.w + n * K, lin.s != nullptr ? lin.s + n : nullptr,
            lin.b + n, y, K, N, red);
}

// Floats of the partial-sum region: matvec's kparts x N and attend's
// groups x D.
template <typename W>
__host__ __device__ inline int red_floats(int D, int F) {
  const int a = kThreads * Vec<W>::N, b = 3 * D > F ? 3 * D : F;
  return a > b ? a : b;
}

// Shared memory of one block (the regions of Smem), in floats, for D, F,
// H and a logits row of lstride slots (at least the longest horizon + 1
// and L_enc), with weights of type W.
template <typename W>
__host__ inline size_t smem_floats(int D, int F, int H, size_t lstride) {
  return 32 + D + std::max(D, F) + std::max(3 * D, F) + H * lstride +
         red_floats<W>(D, F);
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
// and the last layer's output on return. The row attends slots [0, pos) of
// its self cache (self_k/self_v laid out as ``self``) and its fresh row at
// pos, rounded to C first if ``round_fresh``, and every slot of its cross
// K/V (L, B, L_enc, D). Its fresh K/V rows, rounded to C, go to ``fresh``.
template <typename W, typename C>
__device__ void run_layers(const Weights<W>& w, const C* self_k,
                           const C* self_v, CacheLayout self,
                           const C* cross_k, const C* cross_v,
                           FreshRows<C> fresh, int L, int B, int row_index,
                           int D, int H, int F, int L_enc, int pos,
                           bool round_fresh, int lstride, const Smem& s) {
  using X = InputOf<W>;
  const int N3 = 3 * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D / H));
  const CacheLayout cross = batch_major(B, L_enc, D);
  float* x = s.x;
  float* xr = s.xr;
  float* y = s.y;
  for (int l = 0; l < L; ++l) {
    const float* lnl = w.ln + static_cast<size_t>(l) * 6 * D;
    const size_t self_at = l * self.layer + row_index * self.row;
    const size_t cross_at = l * cross.layer + row_index * cross.row;
    const size_t fresh_at = l * fresh.layer + row_index * fresh.row;

    // self-attention over the cache prefix and the fresh row
    for (int d = threadIdx.x; d < D; d += kThreads) xr[d] = round_to<X>(x[d]);
    __syncthreads();
    layer_matvec(w.qkv, l, xr, y, D, N3, s.red);
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const C k = from_f32<C>(y[D + d]), v = from_f32<C>(y[2 * D + d]);
      fresh.k[fresh_at + d] = k;
      fresh.v[fresh_at + d] = v;
      y[d] *= scale;
      if (round_fresh) {
        y[D + d] = to_f32(k);
        y[2 * D + d] = to_f32(v);
      }
    }
    __syncthreads();
    attend<C, X>(y, self_k + self_at, self_v + self_at, self.slot, pos,
                 y + D, y + 2 * D, D, H, s.logits, lstride, xr, s.red);
    layer_matvec(w.out, l, xr, y, D, D, s.red);
    add_layer_norm(x, y, lnl, lnl + D, D, s.scratch);

    // cross-attention over the encoder K/V
    for (int d = threadIdx.x; d < D; d += kThreads) xr[d] = round_to<X>(x[d]);
    __syncthreads();
    layer_matvec(w.cq, l, xr, y, D, D, s.red);
    for (int d = threadIdx.x; d < D; d += kThreads) y[d] *= scale;
    __syncthreads();
    attend<C, X>(y, cross_k + cross_at, cross_v + cross_at, cross.slot,
                 L_enc, nullptr, nullptr, D, H, s.logits, lstride, xr,
                 s.red);
    layer_matvec(w.co, l, xr, y, D, D, s.red);
    add_layer_norm(x, y, lnl + 2 * D, lnl + 3 * D, D, s.scratch);

    // ReLU FFN
    for (int d = threadIdx.x; d < D; d += kThreads) xr[d] = round_to<X>(x[d]);
    __syncthreads();
    layer_matvec(w.ff1, l, xr, y, D, F, s.red);
    for (int f = threadIdx.x; f < F; f += kThreads)
      xr[f] = round_to<X>(fmaxf(y[f], 0.0f));
    __syncthreads();
    layer_matvec(w.ff2, l, xr, y, F, D, s.red);
    add_layer_norm(x, y, lnl + 4 * D, lnl + 5 * D, D, s.scratch);
  }
}

// Floats of shared memory the head needs beyond smem_floats: its V outputs
// and its partial sums.
__host__ __device__ inline int head_floats(int V) {
  return V + (V > kThreads ? V : kThreads);
}

// y[n] = b[n] + sum_k x[k] W[k, n] for float32 W (D, V), any V; x and y in
// shared memory, red max(kThreads, V) floats.
__device__ inline void head(const float* x, const float* __restrict__ W,
                            const float* __restrict__ b, float* y, int D,
                            int V, float* red) {
  const int kparts = V >= kThreads ? 1 : kThreads / V;
  const int kchunk = (D + kparts - 1) / kparts;
  for (int item = threadIdx.x; item < V * kparts; item += kThreads) {
    const int n = item % V, kp = item / V;
    const int k1 = min(D, (kp + 1) * kchunk);
    float acc = 0.0f;
    for (int k = kp * kchunk; k < k1; ++k)
      acc = fmaf(x[k], W[static_cast<size_t>(k) * V + n], acc);
    red[kp * V + n] = acc;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < V; n += kThreads) {
    float s = 0.0f;
    for (int kp = 0; kp < kparts; ++kp) s += red[kp * V + n];
    y[n] = s + b[n];
  }
  __syncthreads();
}

// A row's greedy pick from its V float32 logits in shared memory: the
// first index of the max (jnp.argmax) and log(p_max + 1e-10) with
// p_max = exp(mv - (mv + log(sum exp(y - mv)))), the TPU kernels'
// expressions. Every thread returns the same pick.
struct Pick {
  int index;
  float logp;
};

__device__ inline Pick argmax_logp(const float* y, int V, float* scratch) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  float mv = -INFINITY;
  int mi = V;
  for (int n = threadIdx.x; n < V; n += kThreads) {
    if (y[n] > mv) {
      mv = y[n];
      mi = n;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, mv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, mi, o);
    if (ov > mv || (ov == mv && oi < mi)) {
      mv = ov;
      mi = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier pick may still read warp_v
  if (lane == 0) {
    warp_v[warp] = mv;
    warp_i[warp] = mi;
  }
  __syncthreads();
  mv = warp_v[0];
  mi = warp_i[0];
  for (int i = 1; i < kWarps; ++i) {
    if (warp_v[i] > mv || (warp_v[i] == mv && warp_i[i] < mi)) {
      mv = warp_v[i];
      mi = warp_i[i];
    }
  }
  float se = 0.0f;
  for (int n = threadIdx.x; n < V; n += kThreads) se += expf(y[n] - mv);
  se = block_sum(se, scratch);
  return {mi, logf(expf(mv - (mv + logf(se))) + 1e-10f)};
}

}  // namespace decoder
