// Shared helpers of the port's CUDA kernels: float <-> storage type and
// warp reductions. Storage is bf16 (the serving dtype) or float32, and
// int8 for quantized weights; every kernel computes in float32.
#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float32 value to the storage type and back: the value a matmul
// input or an output takes after the TPU kernels' ``astype(dtype)``.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Sixteen bytes of storage type as floats: four float32, eight bf16 or
// sixteen int8 values (exact). The address must be 16-byte aligned.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  union {
    uint4 v;
    int8_t c[16];
  } u;
  u.v = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(u.c[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One 16-byte asynchronous copy from device to shared memory (L2 only, not
// L1). Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Wait for every copy this thread issued; a __syncthreads() after it makes
// all threads' copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close this thread's group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's committed groups are still
// in flight (the newest ones).
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// One 16-byte asynchronous copy of the first `bytes` (0-16) of gmem, the
// rest of the 16 bytes zero-filled (none read if 0; gmem must still be a
// valid address). Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// One 4-byte asynchronous copy (zero-filled if `bytes` is 0), both
// addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// Tensor-core helpers (mma.sync on bf16 with float32 sums), shared by the
// cluster decoder step (decoder_cluster.cuh), the dequant matmul, window
// attention (window_attend.cuh) and the products of mma_pass.cuh.
namespace tc {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_u32(p)));
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

// Four signed int8 values (bytes 0-3 of w) to two bf16 pairs, exactly
// (|w| <= 128): lo = (byte 0, byte 1), hi = (byte 2, byte 3), the first of
// each in the low half. Each byte, biased to unsigned, becomes the low
// mantissa byte of 2^23 (one byte permute), 2^23 + 128 is subtracted in
// float32 (exact), and the bf16 is the float's high half (exact for an
// integer of at most 8 significant bits): 11 instructions for 4 values.
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t base = 0x4B000000u;  // 2^23 as float32
  const float f0 = __uint_as_float(__byte_perm(u, base, 0x7650)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, base, 0x7651)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, base, 0x7652)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, base, 0x7653)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

}  // namespace tc

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The clusters of a kernel's shape and shared memory that fit on the card
// at once (0: none), queried once for each. The table holds every
// (kernel, cluster, shared memory) the port launches (the cluster step
// kernels try up to five row groups a launch): a query not kept costs the
// host a cudaOccupancyMaxActiveClusters call at each launch. Host threads
// launch at once (a server's executor and scheduler threads), so the table
// is read and written under its lock; the query runs outside it, and an
// entry that another thread added meanwhile is not added twice.
constexpr int kActiveKeys = 256;
__host__ inline cudaError_t active_clusters(const void* kernel,
                                           const cudaLaunchConfig_t& cfg,
                                           int* active) {
  struct Key {
    const void* kernel;
    int cs, smem;
  };
  static std::mutex lock;
  static Key keys[kActiveKeys];
  static int values[kActiveKeys], used = 0;
  const int cs = static_cast<int>(cfg.attrs[0].val.clusterDim.x);
  const int smem = static_cast<int>(cfg.dynamicSmemBytes);
  auto find = [&]() {
    for (int i = 0; i < used; ++i)
      if (keys[i].kernel == kernel && keys[i].cs == cs &&
          keys[i].smem == smem)
        return i;
    return -1;
  };
  {
    std::lock_guard<std::mutex> guard(lock);
    const int i = find();
    if (i >= 0) {
      *active = values[i];
      return cudaSuccess;
    }
  }
  const cudaError_t err = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  if (err == cudaSuccess) {
    std::lock_guard<std::mutex> guard(lock);
    if (find() < 0 && used < kActiveKeys) {
      keys[used] = {kernel, cs, smem};
      values[used++] = *active;
    }
  }
  return err;
}
