// Device admission's pull: at the head of each step of a continuous
// segment, take at most one staged request from a host mailbox and install
// it into its slot.
//
// Replaces no Pallas kernel. It is the counterpart of the in-loop
// ``io_callback`` of handwritten_math_ocr_api_tpu/decode/continuous.py
// (``decode_segment``'s ``admit_pull``): there the running segment asks
// the host for one staged admission each step; here the host publishes
// staged admissions into a mailbox in mapped pinned host memory
// (cudaHostAllocMapped), and this kernel, launched by the host at the head
// of every step, reads it from the card. A request staged while segments
// are already queued on the stream is taken by the first of them that
// runs after its publication.
//
// The mailbox is a ring of ``cap`` entries of eight int64 fields, each
// field with one writer:
//   [0] seq     host: published last; entry i holds seq i + 1 (mod cap)
//   [1] pool    host: the staging pool row of its cross K/V
//   [2] slot    host: the decode slot it fills
//   [3] cancel  host: equal to seq when the entry was cancelled
//   [4] done    kernel: the seq it consumed, written last
//   [5] seg     kernel: the segment that took it, -1 if it was skipped
//   [6] step    kernel: the step of that segment
// and a read position ``cursor`` in device memory that only this kernel
// writes. No field is written by both sides, so no CPU-GPU atomics are
// needed (mapped memory gives none on an x86 PCIe host). The host writes
// an entry only after the staging copy into the pool has finished (it
// waits on the copy's event), with seq last; x86 keeps its stores in
// order. Thread 0 reads seq with volatile loads, and a system-scope fence
// orders the entry's other fields and the pool rows after it. The installs
// finish (a block barrier and a system fence) before the record is
// written, and the record is complete when the kernel is: the host reads it
// after the segment report's event.
//
// An install writes the slot's cross K/V rows of every layer from the pool
// row, resets its small state (prev = SOS, pos 0, active, not finished,
// tokens PAD, log-prob sum and count 0), clears its pushdown state (the
// ``con_*`` rows, where the decoder is constrained) and records the
// entry's seq as the slot's occupant (the host's cancel deactivates a slot
// only while the cancelled entry occupies it).
//
// Bound on the H100: latency. The work is one read of a few host words
// over PCIe (about a microsecond) and, when an entry is taken, a copy of
// 2 x L x L_enc x D values (245,760 bytes for the shipped model in bf16),
// which one block of 512 threads moves as 16-byte vectors. One block: the
// decision is one thread's, and a grid would need a second launch to share
// it.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kFields = 8;

__global__ void __launch_bounds__(kThreads)
admission_pull_kernel(volatile long long* mail, int cap, long long* cursor,
                      int max_scan, const uint4* __restrict__ pool_k,
                      const uint4* __restrict__ pool_v,
                      uint4* __restrict__ cross_k,
                      uint4* __restrict__ cross_v, int L, int S, int P,
                      int row16, int* prev, int* pos, bool* active,
                      bool* finished, int* tokens, int T, float* lp_sum,
                      int* count, int* con_stack, int depth, int* con_ptr,
                      int* con_mode, bool* con_needs, bool* con_sup,
                      long long* occupant, int seg, int step, int sos,
                      int pad) {
  __shared__ long long s_seq;
  __shared__ int s_pool, s_slot;
  if (threadIdx.x == 0) {
    long long c = *cursor;
    long long taken = -1;
    for (int k = 0; k < max_scan; ++k) {
      volatile long long* e = mail + (c % cap) * kFields;
      const long long seq = e[0];
      if (seq != c + 1) break;  // not published yet
      __threadfence_system();   // the entry's fields after its seq
      const int p = static_cast<int>(e[1]), slot = static_cast<int>(e[2]);
      ++c;
      if (e[3] == seq || p < 0 || p >= P || slot < 0 || slot >= S) {
        e[5] = -1;  // cancelled (or out of range): skipped
        e[6] = step;
        __threadfence_system();
        e[4] = seq;
        continue;
      }
      taken = seq;
      s_pool = p;
      s_slot = slot;
      break;
    }
    *cursor = c;
    s_seq = taken;
  }
  __syncthreads();
  const long long seq = s_seq;
  if (seq < 0) return;
  const int p = s_pool, slot = s_slot;
  const int n = L * row16;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int l = i / row16, j = i - l * row16;
    const size_t src = (static_cast<size_t>(p) * L + l) * row16 + j;
    const size_t dst = (static_cast<size_t>(l) * S + slot) * row16 + j;
    cross_k[dst] = __ldcg(pool_k + src);
    cross_v[dst] = __ldcg(pool_v + src);
  }
  for (int t = threadIdx.x; t < T; t += kThreads)
    tokens[static_cast<size_t>(slot) * T + t] = pad;
  if (con_stack != nullptr)
    for (int d = threadIdx.x; d < depth; d += kThreads)
      con_stack[static_cast<size_t>(slot) * depth + d] = 0;
  if (threadIdx.x == 0) {
    prev[slot] = sos;
    pos[slot] = 0;
    active[slot] = true;
    finished[slot] = false;
    lp_sum[slot] = 0.0f;
    count[slot] = 0;
    if (con_stack != nullptr) {
      con_ptr[slot] = 0;
      con_mode[slot] = 0;
      con_needs[slot] = false;
      con_sup[slot] = false;
    }
    occupant[slot] = seq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();  // the installs before the record
    volatile long long* e = mail + ((seq - 1) % cap) * kFields;
    e[5] = seg;
    e[6] = step;
    __threadfence_system();
    e[4] = seq;
  }
}

}  // namespace

// The mailbox: ``bytes`` of pinned host memory mapped into the card's
// address space, zeroed; its host and device addresses written to the two
// out pointers.
extern "C" int admission_mailbox_alloc(size_t bytes, void* host_out,
                                       void* dev_out) {
  void* host = nullptr;
  cudaError_t err = cudaHostAlloc(&host, bytes, cudaHostAllocMapped);
  if (err != cudaSuccess) return static_cast<int>(err);
  memset(host, 0, bytes);
  void* dev = nullptr;
  err = cudaHostGetDevicePointer(&dev, host, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(host);
    return static_cast<int>(err);
  }
  *static_cast<void**>(host_out) = host;
  *static_cast<void**>(dev_out) = dev;
  return 0;
}

extern "C" int admission_mailbox_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

// mail: the mailbox's device address (cap x 8 int64); cursor: int64 on
// the card; pool_k, pool_v (P, L, row_bytes); cross_k, cross_v (L, S,
// row_bytes), row_bytes a multiple of 16 and every pointer 16-byte
// aligned; the small state (S,) and tokens (S, T); the con_* rows (S,
// depth) and (S,), or con_stack null for an unconstrained decoder;
// occupant (S,) int64. max_scan: the most entries looked at (0: none).
extern "C" int admission_pull(void* mail, int cap, void* cursor, int max_scan,
                              const void* pool_k, const void* pool_v,
                              void* cross_k, void* cross_v, int L, int S,
                              int P, int row_bytes, void* prev, void* pos,
                              void* active, void* finished, void* tokens,
                              int T, void* lp_sum, void* count,
                              void* con_stack, int depth, void* con_ptr,
                              void* con_mode, void* con_needs, void* con_sup,
                              void* occupant, int seg, int step, int sos,
                              int pad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  admission_pull_kernel<<<1, kThreads, 0, st>>>(
      static_cast<volatile long long*>(mail), cap,
      static_cast<long long*>(cursor), max_scan,
      static_cast<const uint4*>(pool_k), static_cast<const uint4*>(pool_v),
      static_cast<uint4*>(cross_k), static_cast<uint4*>(cross_v), L, S, P,
      row_bytes / 16, static_cast<int*>(prev), static_cast<int*>(pos),
      static_cast<bool*>(active), static_cast<bool*>(finished),
      static_cast<int*>(tokens), T, static_cast<float*>(lp_sum),
      static_cast<int*>(count), static_cast<int*>(con_stack), depth,
      static_cast<int*>(con_ptr), static_cast<int*>(con_mode),
      static_cast<bool*>(con_needs), static_cast<bool*>(con_sup),
      static_cast<long long*>(occupant), seg, step, sos, pad);
  return static_cast<int>(cudaGetLastError());
}
