// KV-cache append + single-query decode attention, one decoder layer, and
// the same attention without the append.
//
// Replaces two Pallas TPU kernels:
// - handwritten_math_ocr_api_tpu/ops/cache_attention.py::
//   cache_append_attention (_kernel). For each (batch, head) group g: write
//   k_new, v_new into row `pos` of the (T, Dh) caches, in place, then
//     out = softmax(q k_cache[0..pos]^T / sqrt(Dh)) v_cache[0..pos]
//   in float32;
// - handwritten_math_ocr_api_tpu/ops/decode_attention.py::decode_attention
//   (_kernel): the same attention over slots 0..pos of the caches as they
//   are, nothing written (kAppend false).
// Slots after `pos` are masked to -inf in the TPU kernels; they add exactly
// zero there, so this kernel does not read them at all.
//
// Bound on the H100: device memory. A step reads pos + 1 rows of K and of
// V and does 4 flops per element read, about 1 flop a byte: 19.2 KB a
// group at pos 149 (Dh 32, bf16), under a microsecond for the 128 groups
// of a served step. What a kernel this small has to avoid is latency: a
// warp that walks the rows one load after another waits for L2 or HBM some
// 70 times. Design: one block of 256 threads per group stages the whole
// prefix of K and V in shared memory with 16-byte cp.async copies, all in
// flight together, and waits once (a prefix longer than one 40 KB wave
// goes in several waves with an online softmax; no served shape needs a
// second). With the append, row `pos` is copied from k_new / v_new, not
// read back from the cache it is written to. Then each row is taken by
// Dh / (16 bytes) neighbouring threads, one 16-byte vector each, for its
// logit (a few shuffles) and, after one block reduction for the max, for
// its share of the weighted sum and of the softmax denominator; shuffles
// and one pass through shared memory add the rows' shares up, and the sum
// is divided by the denominator in float32 at the end. One launch per call.
// `pos` comes by value: the kernel needs no host round trip.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWaveBytes = 40 * 1024;  // K and V rows staged per wave

// Shared memory of a launch: the K and V rows of a wave, their logits, the
// warps' maxima, and the warps' partial sums (Dh values and a denominator).
__host__ __device__ inline size_t smem_bytes(int rows, int Dh, int itemsize) {
  return 2 * static_cast<size_t>(rows) * Dh * itemsize +
         (static_cast<size_t>(rows) + kWarps + kWarps * (Dh + 1)) *
             sizeof(float);
}

// nvec = Dh * sizeof(T) / 16, a power of two <= 32 (the wrapper checks);
// thread t takes row slot t / nvec and 16-byte vector t % nvec of a row.
template <typename T, bool kAppend>
__global__ void __launch_bounds__(kThreads)
cache_append_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_new,
                              const T* __restrict__ v_new,
                              T* __restrict__ k_cache,
                              T* __restrict__ v_cache, T* __restrict__ out,
                              int T_len, int Dh, int pos, int wave_rows) {
  constexpr int kVec = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);               // wave_rows x Dh
  T* vs = ks + static_cast<size_t>(wave_rows) * Dh;     // wave_rows x Dh
  float* p = reinterpret_cast<float*>(vs + static_cast<size_t>(wave_rows) *
                                               Dh);     // wave_rows logits
  float* red = p + wave_rows;                           // kWarps maxima
  float* part = red + kWarps;                           // kWarps x (Dh + 1)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = Dh / kVec;
  const int vec = tid & (nvec - 1), slot = tid / nvec;
  const int slots = kThreads / nvec;
  const int col = vec * kVec;
  const int g = blockIdx.x;
  const size_t row = static_cast<size_t>(g) * Dh;
  const size_t cache = static_cast<size_t>(g) * T_len * Dh;
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));

  // K and V rows [t0, t0 + rows) of the prefix into shared memory
  auto stage = [&](int t0, int rows) {
    for (int c = tid; c < rows * nvec; c += kThreads) {
      const int r = c / nvec, at = (c & (nvec - 1)) * kVec;
      const int t = t0 + r;
      const size_t src = cache + static_cast<size_t>(t) * Dh + at;
      if (kAppend && t == pos) {  // the new row, not read back
        cp_async16(ks + r * Dh + at, k_new + row + at);
        cp_async16(vs + r * Dh + at, v_new + row + at);
      } else {
        cp_async16(ks + r * Dh + at, k_cache + src);
        cp_async16(vs + r * Dh + at, v_cache + src);
      }
    }
  };
  stage(0, min(wave_rows, pos + 1));  // in flight before anything waits

  if (kAppend && tid < nvec) {
    const size_t at = cache + static_cast<size_t>(pos) * Dh + col;
    *reinterpret_cast<uint4*>(k_cache + at) =
        *reinterpret_cast<const uint4*>(k_new + row + col);
    *reinterpret_cast<uint4*>(v_cache + at) =
        *reinterpret_cast<const uint4*>(v_new + row + col);
  }
  float qv[kVec];
  load_vec(q + row + col, qv);
#pragma unroll
  for (int i = 0; i < kVec; ++i) qv[i] *= scale;

  float m_run = -INFINITY, den = 0.0f, acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;

  for (int t0 = 0; t0 <= pos; t0 += wave_rows) {
    const int rows = min(wave_rows, pos + 1 - t0);
    if (t0 > 0) stage(t0, rows);
    cp_async_wait_all();
    __syncthreads();

    // logits: the nvec threads of a row each take one vector, then a
    // butterfly over them leaves the row's logit in all of them (every lane
    // runs every pass: the shuffles take the whole warp)
    float mx = -INFINITY;
    for (int r0 = 0; r0 < rows; r0 += slots) {
      const int r = r0 + slot;
      float d = 0.0f;
      if (r < rows) {
        float kv[kVec];
        load_vec(ks + r * Dh + col, kv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) d = fmaf(qv[i], kv[i], d);
      }
      for (int o = 1; o < nvec; o <<= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if (r < rows) {
        if (vec == 0) p[r] = d;
        mx = fmaxf(mx, d);
      }
    }
    mx = warp_max(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    float m_new = m_run;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, red[w]);
    const float corr = expf(m_run - m_new);  // 0 on the first wave
    den *= corr;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= corr;
    m_run = m_new;

    // the weighted sum: the same (row slot, vector) split as the logits
    for (int r = slot; r < rows; r += slots) {
      const float e = expf(p[r] - m_new);
      float vv[kVec];
      load_vec(vs + r * Dh + col, vv);
      den += e;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(e, vv[i], acc[i]);
    }
    if (t0 + wave_rows <= pos) __syncthreads();  // the next wave reuses smem
  }

  // add up the row slots: lanes of one vector in a warp by shuffles, then
  // the warps through shared memory
  for (int o = nvec; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    den += __shfl_xor_sync(0xffffffffu, den, o);
  }
  float* mine = part + warp * (Dh + 1);
  if (lane < nvec) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) mine[col + i] = acc[i];
    if (lane == 0) mine[Dh] = den;
  }
  __syncthreads();
  for (int d = tid; d < Dh; d += kThreads) {
    float o = 0.0f, s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      o += part[w * (Dh + 1) + d];
      s += part[w * (Dh + 1) + Dh];
    }
    out[row + d] = from_f32<T>(o / s);
  }
}

template <typename T, bool kAppend>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
           void* v_cache, void* out, int G, int T_len, int Dh, int pos,
           void* stream) {
  const int row_bytes = Dh * static_cast<int>(sizeof(T));
  const int wave_rows = min(pos + 1, max(1, kWaveBytes / (2 * row_bytes)));
  const size_t smem = smem_bytes(wave_rows, Dh, sizeof(T));
  cudaError_t err =
      allow_smem(cache_append_attention_kernel<T, kAppend>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cache_append_attention_kernel<T, kAppend><<<G, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), static_cast<T*>(out), T_len, Dh, pos,
      wave_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cache_append_attention_bf16(const void* q, const void* k_new,
                                           const void* v_new, void* k_cache,
                                           void* v_cache, void* out, int G,
                                           int T_len, int Dh, int pos,
                                           void* stream) {
  return launch<__nv_bfloat16, true>(q, k_new, v_new, k_cache, v_cache, out,
                                     G, T_len, Dh, pos, stream);
}

extern "C" int cache_append_attention_f32(const void* q, const void* k_new,
                                          const void* v_new, void* k_cache,
                                          void* v_cache, void* out, int G,
                                          int T_len, int Dh, int pos,
                                          void* stream) {
  return launch<float, true>(q, k_new, v_new, k_cache, v_cache, out, G,
                             T_len, Dh, pos, stream);
}

// q, k, v, out: the caches are read only; k_new and v_new are not used.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out, int G,
                                     int T_len, int Dh, int pos,
                                     void* stream) {
  return launch<__nv_bfloat16, false>(q, nullptr, nullptr,
                                      const_cast<void*>(k),
                                      const_cast<void*>(v), out, G, T_len,
                                      Dh, pos, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* out, int G,
                                    int T_len, int Dh, int pos,
                                    void* stream) {
  return launch<float, false>(q, nullptr, nullptr, const_cast<void*>(k),
                              const_cast<void*>(v), out, G, T_len, Dh, pos,
                              stream);
}
