// Beam search's cache reorder: a row gather of the self K and V caches.
//
// Replaces the Pallas TPU kernel
// handwritten_math_ocr_api_tpu/ops/beam_reorder.py::beam_cache_gather.
// For every layer l and output row r, positions [0, t_ext) of
//   k_out[l, r] = k_in[l, src[r]],  v_out[l, r] = v_in[l, src[r]]
// into other memory than the input: an in-place gather would overwrite a
// parent row that a later row still reads. The wrapper checks src against
// [0, R) before the launch.
//
// Bound on the H100: bytes, a pure copy (each output byte read once and
// written once, no arithmetic). Design: one block per (row, layer) pair
// copies that row's contiguous t_ext x D run of K and of V as 16-byte
// vectors, neighbouring threads on neighbouring addresses. The kernel
// moves bytes and does not look at them, so one entry serves every type.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
beam_gather_kernel(const uint4* __restrict__ k_in,
                   const uint4* __restrict__ v_in,
                   const int* __restrict__ src, uint4* __restrict__ k_out,
                   uint4* __restrict__ v_out, int R, int T_in, int T_out,
                   int t_ext, int row16) {
  const int r = blockIdx.x, l = blockIdx.y;
  const int s = src[r];
  if (s < 0 || s >= R) return;  // refused by the wrapper; never read
  const size_t in = (static_cast<size_t>(l) * R + s) * T_in * row16;
  const size_t out = (static_cast<size_t>(l) * R + r) * T_out * row16;
  const int n = t_ext * row16;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    k_out[out + i] = k_in[in + i];
    v_out[out + i] = v_in[in + i];
  }
}

}  // namespace

// k_in, v_in (L, R, T_in, row_bytes); k_out, v_out (L, R, T_out,
// row_bytes); row_bytes a multiple of 16, every pointer 16-byte aligned.
extern "C" int beam_cache_gather(const void* k_in, const void* v_in,
                                 const void* src, void* k_out, void* v_out,
                                 int L, int R, int T_in, int T_out, int t_ext,
                                 int row_bytes, void* stream) {
  const dim3 grid(R, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  beam_gather_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint4*>(k_in), static_cast<const uint4*>(v_in),
      static_cast<const int*>(src), static_cast<uint4*>(k_out),
      static_cast<uint4*>(v_out), R, T_in, T_out, t_ext, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
