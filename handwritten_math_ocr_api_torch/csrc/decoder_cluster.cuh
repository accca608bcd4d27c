// The decoder layers of one step for a group of rows, spread over a
// thread-block cluster: the layer code of every decoder-step kernel,
// fused_step.cu (B1 and B11), ragged_step.cu (B7), whole_step.cu (B10) and
// whole_decode.cu (B12), with the embedding prologue and the float32 head
// epilogue (Step::embed, Step::head) of B7, B10 and B12, and B12's loop of
// steps (Step<W, C, true>: Step::pick and the ring carried over steps); and
// the host's plan of a launch (make_shape, the tensor maps, the launch
// configuration) at the end of the file.
//
// Numerics (the TPU kernels'). Three types: W the weights, C the caches
// (and the step's activation dtype), X = InputOf<W> the matmul inputs. The
// bf16 and float32 bundles have W = C = X. The int8 bundle
// (quantize_stacked, the TPU kernels' "quantized" mode) has W = int8 with
// a float32 scale per output column, X = bf16 whatever C is (the TPU
// kernels' x.astype(bfloat16) @ w.astype(bfloat16)), and the scale
// multiplies the float32 sum before the bias is added. The activation rows
// stay float32 across the sublayers; every matmul input is rounded to X and
// accumulated in float32; biases, LayerNorm (eps 1e-5) and the attention
// logits and softmax are float32; the fresh K/V row is rounded to C before
// it joins attention at slot pos (B12 attends it unrounded, in float32, as
// its TPU kernel's lnew = q * k_new does; only the stored row is rounded),
// and no slot after pos is read (the TPU kernels' -inf mask).
//
// Each row of a group has its own slot (Step::positions): B7's come from
// device memory, B1's, B10's and B11's are the launch's one pos, B12's the
// step it has reached. The host plans a launch for the Shape's pos (B7 and
// B12: the last slot, the worst case); a row attends its slots [0, pos[r])
// and its fresh row at pos[r].
//
// A cluster of Cs blocks takes a group of up to kGroupMax rows. Every block
// keeps the group's activation rows (float32) in its own shared memory and
// computes, for every row at once, its own columns of each of a layer's six
// products, so each weight byte of a step is read by one block a group
// (the qkv and cq columns of a head by the Cs / H blocks that share it):
//   per layer l (post-norm):
//     q, k, v = x W_qkv + b_qkv;  k, v -> the fresh rows, rounded to C
//     x = LN1(x + (attn(q, self cache[:pos] + fresh row) W_out + b_out))
//     x = LN2(x + (attn(x W_cq + b_cq, cross K/V) W_co + b_co))
//     x = LN3(x + (relu(x W_ff1 + b_ff1) W_ff2 + b_ff2))
// Heads: block b owns hpb = H / Cs heads from head b / bph * hpb (or
// shares one head with the other bph = Cs / H blocks) and, of each, the
// rows [b % bph * Mg / bph, + Mg / bph): its (row, head) attention items.
// It computes the q columns of its heads, the k and v columns of the KV
// heads they read (and the cross-attention q columns) itself, so
// attention follows the qkv and cq products with no exchange. The self
// caches and the packed qkv weight (D, D + 2 kvd) hold Hkv KV heads of dh
// lanes, kvd = Hkv dh: Hkv = H (MHA), or one KV head that every query
// head reads (MQA, Step's kMqa; one head a block). Under MQA every block
// computes the same 2 dh k and v columns (D and D + kvd on), stages its
// rows' boxes of the one head, and only the blocks of head 0 write a
// row's fresh K/V. Grouped attention with 1 < Hkv < H is refused
// (make_shape), as the TPU kernels take MHA and MQA only. The out, co,
// ff1 and ff2 products split their columns evenly: block b computes
// columns [b n, (b + 1) n), n = N / Cs. After those, and after
// attention, the blocks push what the others need into
// their shared memory (distributed shared memory, 8- or 16-byte remote
// stores) and meet at one cluster barrier: an attention item's output goes
// to every block's out/co input (xo), ff1's activations to every block's
// ff2 input (xh), out/co/ff2's columns to every block's residual buffer
// (yfull); each block then adds the residual and takes LayerNorm over the
// group's whole rows itself (Mg x D floats: cheaper than another
// exchange), which gives its qkv/cq/ff1 input (xa). Six cluster barriers a
// layer. No buffer is written remotely while its block may read it: xo,
// xh and yfull are each read only between the barrier after their writes
// and the next barrier, and the next writes to them come after that one.
//
// Copies: every sublayer's weight columns come by TMA tensor copies (one
// box of up to 256 rows a column segment; tensor maps built by the host)
// and its bias, scale and, after out, co and ff2, the LayerNorm pair that
// follows by TMA bulk copies, into a ring of stages, each completing on
// its own mbarrier; the qkv stage also brings the block's items'
// self-cache slots before their row's slot (as many as shared memory
// holds, one box an item's K or V; B1's, B10's and B11's self-cache maps
// end at slot pos, so the part of a box at or past pos is filled with
// zeros; B7's and B12's span all the cache's slots, so it holds later
// slots; neither is read, and in a single step a row at slot 0 copies
// none) and the cq stage their cross K/V, so attention reads shared
// memory. The self caches are batch-major (L, B, T, kvd), or time-major
// (L, T, B, D) for B10's "v4" (Shape::time_major: a 4-D map over
// (D, B, T, L), an item's box (dh, 1, slots, 1)).
// The copies of the next stages - 1 sublayers are in flight while one
// computes. Thread 0 declares a stage's bytes (mbarrier.arrive.expect_tx),
// then one thread an op issues its few copies. Weight segments whose rows
// are 32, 64 or 128 bytes land swizzled (the TMA's 32B/64B/128B patterns)
// and are read with the same XOR, so ldmatrix meets no bank conflict.
//
// Attention: an item's slots split over up to kWarps / items warps; a
// warp's lanes split its slots (dh / 16-byte vectors a slot) in one pass
// with an online softmax, and the warps' partial states meet in shared
// memory; see Numerics above.
//
// Products: for bf16 inputs (the bf16 bundle, and the int8 bundle, whose
// inputs round to bf16) on the tensor cores, mma.sync.m16n8k16 with
// float32 accumulation: A (the group's rows, rounded to X) by ldmatrix,
// rows past the group's end clamped to its last row (computed, never
// stored); B from the weight stage, by ldmatrix.trans in bf16, or int8
// bytes converted to bf16 in registers (exact: |w| <= 127). The reduction
// is split in up to kWarps parts and a warp runs up to kTilesPerWarp
// output tiles of one part interleaved (short dependent mma chains, the A
// fragment loaded once a k-step); the partial tiles meet in shared
// memory. The int8 column scale multiplies the float32 sum before the
// bias. The float32 bundle: FMA on the CUDA cores in the same column
// split (no TF32).
//
// What bounds it: each phase is a short chain of dependent instructions on
// one block's 8 warps (one block an SM), so its latency, not the bytes,
// sets a step's time. The kernel keeps that chain short: a block's shape
// constants, each product's split and each warp's tiles are computed once
// into small tables in shared memory (start()), the few divisions left
// use precomputed reciprocals (Div), and no Step member lives in local
// memory (with 227 KB of shared memory an SM keeps little L1 for it).
#pragma once

#include <algorithm>
#include <atomic>
#include <cstring>
#include <mutex>

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the type only)

#include "decoder_types.cuh"

namespace cluster_step {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupMax = 16;   // rows of one mma M tile
constexpr int kMaxStages = 3;   // the ring's stages (the refills need <= 6)
constexpr int kSublayers = 6;   // products a layer
constexpr int kU = 4;           // slots a lane loads together in attention
constexpr int kTilesPerWarp = 4;  // output tiles a warp of a product runs
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper
constexpr int kBox = 256;       // a tensor copy's largest box dimension

// The tensor maps of a launch: the six stacked weights (L, K, N), boxes of
// (min(K, kBox) rows, a block's column segment); the self caches
// (L, B, pos, kvd: the slots before pos of (L, B, T, kvd) caches, or
// (L, pos, B, D) of time-major ones) and the cross K/V (L, B, L_enc, D),
// boxes of (the staged slots, a head's dh values).
struct Maps {
  CUtensorMap w[6];
  CUtensorMap self_k, self_v, cross_k, cross_v;
};

template <typename W>
using InputOf = decoder::InputOf<W>;

// Sizes of one launch: the model, the step, and the cluster's shape.
struct Shape {
  int L, B, D, H, F, L_enc, pos;  // B: the rows the launch computes
  int Hkv;        // KV heads of the self caches: H (MHA) or 1 (MQA)
  int Mg;         // rows of a group (<= kGroupMax)
  int Cs;         // blocks of a cluster
  int stages;     // stages of the ring
  int cap_self;   // self-cache slots an item stages in shared memory
  int cap_cross;  // cross K/V slots an item stages
  int hres;        // B12: columns of the head a block keeps resident, else 0
  int time_major;  // the self caches are (L, T, B, D) (B10 "v4")
  int pool;        // rows of the caches (B7 with n_chunks: more than B)
  int seg_ring;    // B7's ring mode: the segment ring's rows S, else 0
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// Tensor copies land on 128-byte boundaries, swizzled ones on 1024-byte
// boundaries (the span of their pattern).
__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) & ~static_cast<size_t>(127);
}
__host__ __device__ inline size_t align1024(size_t b) {
  return (b + 1023) & ~static_cast<size_t>(1023);
}

// The TMA swizzle of a weight segment with rows of `row_bytes`: log2 of
// its 16-byte chunks a row for rows of 32, 64 or 128 bytes (the
// CU_TENSOR_MAP_SWIZZLE_32B/64B/128B patterns), else 0 (none). Rows read
// by ldmatrix at a stride of 32-128 bytes would otherwise meet in 2-8 way
// bank conflicts.
__host__ __device__ inline int swizzle_bits(int row_bytes) {
  return row_bytes == 32 ? 1 : row_bytes == 64 ? 2 : row_bytes == 128 ? 3 : 0;
}

// Byte offset `off` (from a 1024-byte aligned base) under a swizzle of
// `bits`: the 16-byte chunk index XOR the 128-byte line index, both taken
// mod 2^bits.
__host__ __device__ inline int swz(int off, int bits) {
  return off ^ (((off >> 7) & ((1 << bits) - 1)) << 4);
}

// Padding of a weight or matmul-input row, in elements: 16 bytes for the
// mma path (ldmatrix), none for float32.
template <typename T>
__host__ __device__ constexpr int pad_of() {
  return std::is_same_v<T, float> ? 0 : static_cast<int>(16 / sizeof(T));
}

// The work split of a Shape: heads a block (hpb) and blocks a head (bph),
// rows of a block's items (rpb), items a block (ipb), and per product p
// (qkv, out, cq, co, ff1, ff2) its K, its column segments (3 for qkv: the
// q columns of the block's heads, the k and v columns of their KV heads)
// and a segment's columns.
struct Split {
  int hpb, bph, rpb, ipb, dh;
  __host__ __device__ explicit Split(const Shape& s) {
    hpb = s.H >= s.Cs ? s.H / s.Cs : 1;
    bph = s.Cs >= s.H ? s.Cs / s.H : 1;
    rpb = s.Mg / bph;
    ipb = hpb * rpb;
    dh = s.D / s.H;
  }
  __host__ __device__ int k(const Shape& s, int p) const {
    return p == 5 ? s.F : s.D;
  }
  __host__ __device__ int segs(int p) const { return p == 0 ? 3 : 1; }
  __host__ __device__ int seg_cols(const Shape& s, int p) const {
    return p == 0 || p == 2 ? hpb * dh : (p == 4 ? s.F : s.D) / s.Cs;
  }
  __host__ __device__ int cols(const Shape& s, int p) const {
    return segs(p) * seg_cols(s, p);
  }
  // all columns of product p (its weight's row length: D + 2 kvd for qkv)
  __host__ __device__ int n_all(const Shape& s, int p) const {
    return p == 0 ? s.D + 2 * s.Hkv * dh : p == 4 ? s.F : s.D;
  }
  // first column of segment i of block `rank`: of qkv's k and v segments,
  // the block's first head's KV head (head / (H / Hkv)) in the k or v block
  __host__ __device__ int col0(const Shape& s, int p, int i, int rank) const {
    const int head = rank / bph * hpb;
    if (p == 0 && i > 0)
      return s.D + (i - 1) * s.Hkv * dh + head / (s.H / s.Hkv) * dh;
    if (p == 0 || p == 2) return head * dh;
    return rank * seg_cols(s, p);
  }
};

// Exact a / d for 0 <= a < 2^16 and 1 <= d < 2^16: the high word of
// a * ceil(2^32 / d) (d = 1 kept apart). The kernel's indices are small,
// and a division by a value known only at run time otherwise costs a
// chain of some twenty dependent instructions.
struct Div {
  unsigned m;
  int d;
  __device__ void set(int d_) {
    d = d_;
    m = d_ > 1 ? static_cast<unsigned>((0x100000000ull + d_ - 1) / d_) : 0u;
  }
  __device__ int q(int a) const {
    return d > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(a), m))
                 : a;
  }
};

// Product p's constants for this block (Step::start() fills them): K, its
// columns n in segs segments of sc (of nall in the weight's row), a
// segment's elements in the stage and its row bytes and swizzle, the
// weight boxes (boxes of kb rows), the copy ops and bytes of its stage,
// the mma split (tiles, reduction parts of kchunk k-steps, items), and
// each segment's first column.
struct ProdTab {
  int K, n, nall, sc, segs, seg_e, row_b, bits, boxes, kb, ops;
  int tiles, kparts, kchunk, items;
  int col0[3];
  unsigned bytes;
  Div dn, dsc;
};

// A warp's mma items of a product: k-steps [k0, k1) and, of its `my`
// tiles, each one's segment offset (elements), first column there and
// partial-sum slot.
struct WarpTab {
  int k0, k1, my;
  int off[kTilesPerWarp];
  int ct[kTilesPerWarp];
  int red[kTilesPerWarp];  // each tile's partial in red
};

// A local attention item: its row in the group (-1 past the group's end)
// and its head.
struct ItemTab {
  int r, h;
};
constexpr int kMaxItems = 32;

__host__ __device__ inline size_t table_bytes() {
  return sizeof(ProdTab) * kSublayers + sizeof(WarpTab) * kSublayers * kWarps +
         sizeof(ItemTab) * kMaxItems;
}

// Byte offsets of a block's shared-memory regions. A stage of the ring
// holds a weight slice (wbytes: its column segments one after another,
// each K dense rows), then its bias and scale (nmax floats each) and a
// LayerNorm pair (2 D floats); after the ring, the items' staged
// self-cache and cross K/V slots (K then V of each item, kv_self and
// kv_cross bytes each).
template <typename W, typename C>
struct Layout {
  size_t x, xa, xo, xh, yfull, ys, red, iq, part, stats, rpos, hstat, tabs,
      head, dec, bars, ring, stage, wbytes, kvs, kvc, kv_self, kv_cross, end;
  int nmax;
  __host__ __device__ explicit Layout(const Shape& s) {
    using X = InputOf<W>;
    const Split sp(s);
    const int tiles = kWarps * kTilesPerWarp;  // partial tiles at most
    int stage_bytes = 0;
    nmax = 0;
    for (int p = 0; p < kSublayers; ++p) {
      const int n = sp.cols(s, p);
      nmax = n > nmax ? n : nmax;
      const int b = sp.segs(p) * static_cast<int>(align1024(
                        sp.k(s, p) * sp.seg_cols(s, p) * sizeof(W)));
      stage_bytes = b > stage_bytes ? b : stage_bytes;
    }
    const size_t lda = s.D + pad_of<X>(), ldh = s.F + pad_of<X>();
    size_t at = 0;
    // before x: each row's slot, and in ring mode its segment start
    rpos = at;
    at = align16(at + sizeof(int) * kGroupMax * (s.seg_ring > 0 ? 2 : 1));
    x = at;      at = align16(at + sizeof(float) * s.Mg * s.D);
    xa = at;     at = align16(at + sizeof(X) * s.Mg * lda);
    xo = at;     at = align16(at + sizeof(X) * s.Mg * lda);
    xh = at;     at = align16(at + sizeof(X) * s.Mg * ldh);
    yfull = at;  at = align16(at + sizeof(float) * s.Mg * s.D);
    ys = at;     at = align16(at + sizeof(float) * s.Mg * nmax);
    red = at;    at = align16(at + sizeof(float) * 128 * tiles);
    iq = at;     at = align16(at + sizeof(float) * sp.ipb * 3 * sp.dh);
    part = at;   at = align16(at + sizeof(float) * kWarps * (sp.dh + 2));
    stats = at;  at = align16(at + sizeof(float) * 2 * kWarps);
    hstat = at;  at = align16(at + sizeof(float) * 3 * s.Cs * s.Mg);
    tabs = at;   at = align16(at + table_bytes());
    // B12 only: the resident head segment (D rows of hres columns, then
    // its biases) and each row's decode state (prev token, lp, cnt)
    head = at;   at = align16(at + sizeof(float) * s.hres * (s.D + 1));
    dec = at;    at = align16(at + (s.hres > 0 ? 12 * kGroupMax : 0));
    bars = at;   at = align1024(at + 8 * kMaxStages);
    ring = at;
    wbytes = align1024(stage_bytes);
    stage = align1024(wbytes + sizeof(float) * (2 * nmax + 2 * s.D));
    kv_self = align128(sizeof(C) * sp.dh * s.cap_self);
    kv_cross = align128(sizeof(C) * sp.dh * s.cap_cross);
    kvs = ring + s.stages * stage;
    kvc = kvs + 2 * sp.ipb * kv_self;
    end = kvc + 2 * sp.ipb * kv_cross;
  }
};

using tc::smem_u32;
using tc::ldmatrix_x4;
using tc::ldmatrix_x2_trans;
using tc::mma_bf16;
using tc::pack_bf16;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive on the barrier, declaring `bytes` of bulk copies this thread is
// about to issue for the phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of the given parity to complete. A phase that never
// completes (a copy count gone wrong) traps after some seconds instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  for (long long i = 0;; ++i) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1ll << 26)) __trap();
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to this block's shared memory, completing
// on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// TMA tensor copies of one box at the given coordinates (innermost
// first) into this block's shared memory, completing on bar.
__device__ __forceinline__ void tensor_copy3(void* dst, const CUtensorMap* map,
                                             int c0, int c1, int c2,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tensor_copy4(void* dst, const CUtensorMap* map,
                                             int c0, int c1, int c2, int c3,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// The B fragment of k-step k0 (16 rows) and n-tile c0 (8 columns) of a
// weight segment (1024-byte aligned, rows of row_b bytes, swizzled by
// `bits`) (lane = 4 gq + tq: b0 rows k0 + 2 tq, + 1, b1 rows k0 + 2 tq + 8,
// + 9, column c0 + gq).
__device__ __forceinline__ void load_b(const __nv_bfloat16* seg, int row_b,
                                       int bits, int k0, int c0, int lane,
                                       uint32_t& b0, uint32_t& b1) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(seg);
  ldmatrix_x2_trans(b0, b1,
                    base + swz((k0 + (lane & 15)) * row_b + c0 * 2, bits));
}

__device__ __forceinline__ void load_b(const int8_t* seg, int row_b, int bits,
                                       int k0, int c0, int lane, uint32_t& b0,
                                       uint32_t& b1) {
  const int at = (k0 + 2 * (lane & 3)) * row_b + c0 + (lane >> 2);
  const auto w = [&](int dk) {
    return static_cast<float>(seg[swz(at + dk * row_b, bits)]);
  };
  b0 = pack_bf16(w(0), w(1));
  b1 = pack_bf16(w(8), w(9));
}

// Four float32 values to four X values at dst (8 or 16 bytes, aligned).
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// Four X values from src to dst (8 or 16 bytes, aligned).
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

// Sixteen bytes of C as floats (Vec<C>::N values).
template <typename C>
__device__ __forceinline__ void raw_to_f32(const uint4& r, float* out) {
  if constexpr (std::is_same_v<C, float>) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// One step's layers for the group of rows [row0, row0 + rows) of one
// cluster. The kernel calls positions() and start(), fills x (float32) and
// xa (x rounded to X) for the group's rows (B7, B10: embed()) and meets
// the cluster once before run(); on return x holds the last layer's output
// (B7, B10: head() then computes the logits). Sublayer g = kSublayers l + p
// uses stage g % stages; its copies are issued as sublayer
// g - (stages - 1) starts (start() issues those of 0 .. stages - 2).
//
// kDecode: B12's loop of steps in one launch (whole_decode.cu). The ring
// runs on over the steps (run() carries its stage and parity), so the next
// step's first stages - 1 sublayers are in flight during this step's last
// sublayers and its head; the head's weights stay resident in shared
// memory (Shape::hres) for the whole decode. A row that has finished is
// dead (rpos -1) from its next step on: its items read nothing (items[].r
// -1, the stage bytes counted again, count_bytes()), and it writes no
// cache slot. The fresh K/V row joins attention in float32 (B12's rule),
// and its stores are fenced against the async proxy: the next step's TMA
// copies read them. No slot-0 rule: a stage issued during step t for step
// t + 1 copies every live item's box (at step 0 a box of slots never read).
//
// kMqa: the self caches hold one KV head (Shape::Hkv 1, kvd = dh) that
// every item reads (kv_head); of the blocks that hold a row, the one of
// head 0 writes its fresh K/V. A compile-time switch, so that the MHA
// kernels' code stays as it was (B1 and B7 only).
//
// kRing: B7's segment-ring mode (with_ring(), before positions()). Row r
// attends three extents under one softmax: its cache slots [0, seg[r])
// (the staged prefix valid below min(cap_self, seg[r])), the ring rows
// t - seg[r] of slots [seg[r], pos[r]) (plain 16-byte loads from device
// memory: the ring is small and stays in L2), and its fresh row at pos[r].
// A row whose seg[r] lies outside [0, pos[r]], or whose pos[r] - seg[r] is
// S or more, is dead. A compile-time switch too, so that the other kernels
// keep their code (B7 only).
template <typename W, typename C, bool kDecode = false, bool kMqa = false,
          bool kRing = false>
struct Step {
  using X = InputOf<W>;
  static constexpr int kVec = Vec<C>::N;

  decoder::Weights<W> w;
  const C* self_k;
  const C* self_v;
  decoder::CacheLayout self;
  const C* cross_k;
  const C* cross_v;
  decoder::FreshRows<C> fresh;
  const Maps* maps;
  Shape s;
  Split sp;
  cg::cluster_group cluster;
  int rank, row0, rows, log_cs, i0, i1;
  int lw_self, lw_cross;  // log2 of the warps an attention item takes
  Div ddh, dg4;
  float *x, *yfull, *ys, *red, *iq, *part, *stats, *hstat;
  X *xa, *xo, *xh;
  uint64_t* bars;
  ProdTab* pt;
  WarpTab* wtab;
  ItemTab* items;
  unsigned char* ring;
  C *kvs, *kvc;  // the items' staged self-cache prefix and cross K/V
  size_t stage, wbytes, kv_self, kv_cross;
  int nmax;
  // the float32 head (B7, B10, B12; hw null for B1 and B11): w_head
  // (D, hV) and b_head, this block's hn columns from hc0, staged at a row
  // stride of hc
  const float* hw = nullptr;
  const float* hb = nullptr;
  int hV = 0, hc = 0, hc0 = 0, hn = 0;
  float* hres;  // B12: the resident head segment (Layout::head)
  int* dec;     // B12: the decode state (Layout::dec)
  decoder::SegmentRing<C> sring;  // kRing: the segment ring

  __device__ Step(const decoder::Weights<W>& w_, const C* sk, const C* sv,
                  decoder::CacheLayout self_, const C* ck, const C* cv,
                  decoder::FreshRows<C> fresh_, const Maps* maps_,
                  const Shape& s_, unsigned char* smem, int row0_)
      : w(w_), self_k(sk), self_v(sv), self(self_), cross_k(ck), cross_v(cv),
        fresh(fresh_), maps(maps_), s(s_), sp(s_),
        cluster(cg::this_cluster()) {
    const Layout<W, C> lay(s);
    rank = static_cast<int>(cluster.block_rank());
    row0 = row0_;
    rows = min(s.Mg, s.B - row0);
    log_cs = __ffs(s.Cs) - 1;  // Cs is a power of two
    i0 = rank % sp.bph * sp.rpb;
    i1 = min(rows, i0 + sp.rpb);
    ddh.set(sp.dh);
    dg4.set(sp.dh / 4);
    lw_self = item_warps_log(s.pos + 1);
    lw_cross = item_warps_log(s.L_enc);
    x = reinterpret_cast<float*>(smem + lay.x);
    xa = reinterpret_cast<X*>(smem + lay.xa);
    xo = reinterpret_cast<X*>(smem + lay.xo);
    xh = reinterpret_cast<X*>(smem + lay.xh);
    yfull = reinterpret_cast<float*>(smem + lay.yfull);
    ys = reinterpret_cast<float*>(smem + lay.ys);
    red = reinterpret_cast<float*>(smem + lay.red);
    iq = reinterpret_cast<float*>(smem + lay.iq);
    part = reinterpret_cast<float*>(smem + lay.part);
    stats = reinterpret_cast<float*>(smem + lay.stats);
    hstat = reinterpret_cast<float*>(smem + lay.hstat);
    hres = reinterpret_cast<float*>(smem + lay.head);
    dec = reinterpret_cast<int*>(smem + lay.dec);
    bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
    pt = reinterpret_cast<ProdTab*>(smem + lay.tabs);
    wtab = reinterpret_cast<WarpTab*>(pt + kSublayers);
    items = reinterpret_cast<ItemTab*>(wtab + kSublayers * kWarps);
    ring = smem + lay.ring;
    kvs = reinterpret_cast<C*>(smem + lay.kvs);
    kvc = reinterpret_cast<C*>(smem + lay.kvc);
    stage = lay.stage;
    wbytes = lay.wbytes;
    kv_self = lay.kv_self;
    kv_cross = lay.kv_cross;
    nmax = lay.nmax;
  }

  // the self caches' KV head of query head h
  __device__ static int kv_head(int h) { return kMqa ? 0 : h; }

  // log2 of the warps an attention item over `slots` slots takes: the
  // spare warps, at most one a 16 slots, a power of two (so that a round's
  // items tile the warps)
  __device__ int item_warps_log(int slots) const {
    int wpi = min(sp.ipb < kWarps ? kWarps / sp.ipb : 1, (slots + 15) / 16);
    while (wpi & (wpi - 1)) wpi &= wpi - 1;
    return __ffs(max(wpi, 1)) - 1;
  }

  __device__ decoder::Linear<W> linear(int p) const {
    switch (p) {
      case 0: return w.qkv;
      case 1: return w.out;
      case 2: return w.cq;
      case 3: return w.co;
      case 4: return w.ff1;
      default: return w.ff2;
    }
  }

  // each row's slot, -1 for a dead row (positions()): the kGroupMax ints
  // just before x, so that no pointer of its own stays live
  __device__ int* rpos() const {
    return reinterpret_cast<int*>(x) - kGroupMax;
  }
  // kRing: each row's segment start (positions()), the kGroupMax ints
  // before rpos()
  __device__ int* rseg() const { return rpos() - kGroupMax; }

  // kRing, before positions(): the segment ring
  __device__ void with_ring(const decoder::SegmentRing<C>& r) { sring = r; }

  __device__ unsigned char* stage_at(int st) const { return ring + st * stage; }
  __device__ float* extras_at(int st) const {  // bias, scale, LN pair
    return reinterpret_cast<float*>(stage_at(st) + wbytes);
  }

  // The tables, the barriers, each product's stage bytes (the same in
  // every layer), and the first stages - 1 stages' copies.
  __device__ void start() {
    const int tid = threadIdx.x;
    if (tid < kSublayers) {
      const int p = tid;
      ProdTab& t = pt[p];
      t.K = sp.k(s, p);
      t.segs = sp.segs(p);
      t.sc = sp.seg_cols(s, p);
      t.n = t.segs * t.sc;
      t.nall = sp.n_all(s, p);
      t.row_b = t.sc * sizeof(W);
      t.bits = swizzle_bits(t.row_b);
      t.seg_e = static_cast<int>(
          align1024(static_cast<size_t>(t.K) * t.row_b) / sizeof(W));
      t.kb = t.K < kBox ? t.K : kBox;
      t.boxes = t.K / t.kb;
      // each item's K and V boxes: the self cache's only from pos 1
      const bool kv = p == 0 ? s.pos > 0 && s.cap_self > 0
                             : p == 2 && s.cap_cross > 0;
      t.ops = t.segs * t.boxes + t.segs * (linear(p).s != nullptr ? 2 : 1) +
              (p & 1) + (kv ? 2 * sp.ipb : 0);
      // the reduction split in the most parts (a power of two up to
      // kWarps) that keeps a warp's tiles at most kTilesPerWarp and two
      // k-steps a part: shorter dependent mma chains a warp
      t.tiles = t.n / 8;
      t.kparts = 1;
      while (t.kparts < kWarps &&
             t.tiles * 2 * t.kparts <= kWarps * kTilesPerWarp &&
             t.K / 16 >= 4 * t.kparts)
        t.kparts *= 2;
      t.kchunk = (t.K / 16 + t.kparts - 1) / t.kparts;
      t.items = t.tiles * t.kparts;
      for (int i = 0; i < 3; ++i)
        t.col0[i] = i < t.segs ? sp.col0(s, p, i, rank) : 0;
      t.dn.set(t.n);
      t.dsc.set(t.sc);
    }
    if (tid < kMaxItems) {
      const int li = tid;
      const int r = i0 + li % sp.rpb;
      items[li].r = li < sp.ipb && r < rows && rpos()[r] >= 0 ? r : -1;
      items[li].h = rank / sp.bph * sp.hpb + li / sp.rpb;
    }
    if (tid == 0) {
      for (int i = 0; i < s.stages; ++i) mbar_init(bars + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (tid < sizeof(Maps) / sizeof(CUtensorMap)) {
      const CUtensorMap* m = &maps->w[0] + tid;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(m))
                   : "memory");
    }
    __syncthreads();
    for (int e = tid; e < kSublayers * kWarps; e += kThreads) {
      // warp wi: reduction part wi % kparts, tiles wi / kparts + i
      // (kWarps / kparts); partial tile kp tiles + tile in red
      const ProdTab& t = pt[e / kWarps];
      const int wi = e % kWarps, tps = t.sc / 8;
      const int kp = wi % t.kparts, step = kWarps / t.kparts;
      WarpTab& wt = wtab[e];
      wt.k0 = kp * t.kchunk;
      wt.k1 = min(t.K / 16, wt.k0 + t.kchunk);
      wt.my = 0;
      for (int tile = wi / t.kparts; tile < t.tiles; tile += step) {
        const int i = wt.my++;
        wt.off[i] = tile / tps * t.seg_e;
        wt.ct[i] = tile % tps * 8;
        wt.red[i] = kp * t.tiles + tile;
      }
    }
    count_bytes();
    if constexpr (kDecode) copy_head(hres);
    __syncthreads();
    if (tid == 0)
      for (int g = 0; g < s.stages - 1; ++g) expect(g, g);
    __syncthreads();
    for (int g = 0; g < s.stages - 1; ++g) issue(g, g);
  }

  // Each product's stage bytes (the same in every layer) from the items'
  // rows: a warp a product.
  __device__ void count_bytes() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int p = warp; p < kSublayers; p += kWarps) {
      unsigned bytes = 0;
      for (int i = lane; i < pt[p].ops; i += 32) bytes += op(p, 0, 0, i, false);
      for (int o = 16; o > 0; o >>= 1)
        bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
      if (lane == 0) pt[p].bytes = bytes;
    }
  }

  // Copy op i of product p of layer l into stage st (if `go`); returns its
  // bytes. Ops: the weight boxes (segment, box of kb rows), then the bias
  // and scale segments, the LayerNorm pair after out / co / ff2, and for
  // qkv (cq) each item's self-cache (cross K/V) box, K then V. A tensor
  // copy completes its whole box's bytes, the zeros past the map's end
  // included.
  __device__ unsigned op(int p, int l, int st, int i, bool go) const {
    const ProdTab& t = pt[p];
    uint64_t* bar = bars + st;
    const int nw = t.segs * t.boxes;
    if (i < nw) {
      int seg = 0, box = i;
      while (box >= t.boxes) {
        box -= t.boxes;
        ++seg;
      }
      if (go)
        tensor_copy3(stage_at(st) + static_cast<size_t>(seg) * t.seg_e *
                                        sizeof(W) +
                         static_cast<size_t>(box) * t.kb * t.row_b,
                     &maps->w[p], t.col0[seg], box * t.kb, l, bar);
      return t.kb * t.row_b;
    }
    i -= nw;
    const decoder::Linear<W> lin = linear(p);
    const int n_s = lin.s != nullptr ? t.segs : 0;
    if (i < t.segs + n_s) {
      const bool sc_op = i >= t.segs;
      const int seg = sc_op ? i - t.segs : i;
      const float* src = (sc_op ? lin.s : lin.b) +
                         static_cast<size_t>(l) * t.nall +
                         t.col0[seg];
      if (go)
        bulk_copy(extras_at(st) + (sc_op ? nmax : 0) + seg * t.sc, src,
                  t.sc * sizeof(float), bar);
      return t.sc * sizeof(float);
    }
    i -= t.segs + n_s;
    if (p & 1) {
      if (go)
        bulk_copy(extras_at(st) + 2 * nmax,
                  w.ln + (static_cast<size_t>(l) * 6 + p - 1) * s.D,
                  2 * s.D * sizeof(float), bar);
      return 2 * s.D * sizeof(float);
    }
    const int cap = p == 0 ? s.cap_self : s.cap_cross;
    const int kv = i & 1, li = i >> 1;
    if (items[li].r < 0) return 0;
    const int r = items[li].r, h = items[li].h;
    // a row at slot 0 (ring mode: whose segment starts there): none (a
    // decode's stage may be for the next step)
    if (!kDecode && p == 0 && (kRing ? rseg()[r] : rpos()[r]) == 0) return 0;
    if (go) {
      if (p == 0)
        tensor_copy4(reinterpret_cast<unsigned char*>(kvs) +
                         (2 * li + kv) * kv_self,
                     kv ? &maps->self_v : &maps->self_k,
                     kv_head(h) * sp.dh,
                     s.time_major ? row0 + r : 0,
                     s.time_major ? 0 : row0 + r, l, bar);
      else
        tensor_copy4(reinterpret_cast<unsigned char*>(kvc) +
                         (2 * li + kv) * kv_cross,
                     kv ? &maps->cross_v : &maps->cross_k, h * sp.dh, 0,
                     row0 + r, l, bar);
    }
    return cap * sp.dh * sizeof(C);
  }

  // Declare sublayer g's copy bytes to stage st's barrier (one thread,
  // before any of them is issued), and issue them (one op a thread). The
  // cache buffers are free when they are refilled: layer l's self-cache
  // copies go out with its qkv stage, as sublayer 6 l - (stages - 1) >=
  // 6 (l - 1) + 1 starts, after layer l - 1's self-attention; its cross
  // copies with its cq stage, after layer l - 1's cross-attention
  // (stages <= 6).
  // A decode's sublayers past the step's last are the next step's first.
  __device__ void expect(int g, int st) {
    if (kDecode && g >= kSublayers * s.L) g -= kSublayers * s.L;
    if (g < kSublayers * s.L)
      mbar_arrive_expect(bars + st, pt[g % kSublayers].bytes);
  }
  __device__ void issue(int g, int st) {
    if (kDecode && g >= kSublayers * s.L) g -= kSublayers * s.L;
    if (!kDecode && g == kSublayers * s.L && hw != nullptr)
      copy_head(reinterpret_cast<float*>(stage_at(st)));
    if (g >= kSublayers * s.L) return;
    const int p = g % kSublayers;
    if (static_cast<int>(threadIdx.x) < pt[p].ops)
      op(p, g / kSublayers, st, threadIdx.x, true);
  }

  // ys[r][c] = (sum_k a[r][k] W[k][c]) * scale + bias over the block's n
  // columns of sublayer g (stage st, its barrier's phase parity ph), for
  // the group's rows [r0, r1); a has row stride lda elements.
  __device__ void product(int g, int st, int ph, const X* a, int lda, int r0,
                          int r1) {
    const int p = g % kSublayers;
    const ProdTab& t = pt[p];
    const int K = t.K, n = t.n, sc = t.sc, row_b = t.row_b, bits = t.bits;
    // the stage refilled next was last read by sublayer g - 1: every thread
    // is past it (and past its barrier's wait) at this barrier
    const int st_next = st == 0 ? s.stages - 1 : st - 1;
    if (threadIdx.x == 0) expect(g + s.stages - 1, st_next);
    __syncthreads();
    issue(g + s.stages - 1, st_next);
    mbar_wait(bars + st, ph);
    const W* ws = reinterpret_cast<const W*>(stage_at(st));
    const float* bias = extras_at(st);
    const float* scale = linear(p).s != nullptr ? bias + nmax : nullptr;
    const int tid = threadIdx.x, nr = r1 - r0;
    if (nr > 0) {
      if constexpr (std::is_same_v<X, float>) {
        // float32: FMA, the reduction split where outputs are few
        const int outs = nr * n;
        const int kparts = outs >= kThreads ? 1 : kThreads / outs;
        const int kchunk = (K + kparts - 1) / kparts;
        for (int item = tid; item < outs * kparts; item += kThreads) {
          const int o = item % outs, kp = item / outs;
          const int r = r0 + o / n, c = o % n;
          const unsigned char* wc =
              reinterpret_cast<const unsigned char*>(ws + c / sc * t.seg_e);
          const int cb = c % sc * static_cast<int>(sizeof(W));
          const int k1 = min(K, (kp + 1) * kchunk);
          float acc = 0.0f;
          for (int k = kp * kchunk; k < k1; ++k)
            acc = fmaf(a[r * lda + k],
                       *reinterpret_cast<const W*>(
                           wc + swz(k * row_b + cb, bits)),
                       acc);
          red[item] = acc;
        }
        __syncthreads();
        for (int o = tid; o < outs; o += kThreads) {
          float acc = 0.0f;
          for (int kp = 0; kp < kparts; ++kp) acc += red[kp * outs + o];
          const int c = o % n;
          ys[(r0 + o / n) * n + c] =
              (scale != nullptr ? __fmul_rn(acc, scale[c]) : acc) + bias[c];
        }
      } else {
        // a warp takes up to kTilesPerWarp tiles of one reduction part
        // (wtab) and runs their k-steps interleaved, the A fragment loaded
        // once a step
        const int lane = tid & 31, warp = tid >> 5;
        const WarpTab& wt = wtab[p * kWarps + warp];
        const int my = wt.my, k0 = wt.k0, k1 = wt.k1;
        const int ar = min(lane & 15, rows - 1);  // clamped past the group
        const X* arow = a + ar * lda + (lane >> 4) * 8;
        const W* wp[kTilesPerWarp];
        int ct[kTilesPerWarp], slot[kTilesPerWarp];
        float acc[kTilesPerWarp][4];
#pragma unroll
        for (int i = 0; i < kTilesPerWarp; ++i) {
          wp[i] = ws + (i < my ? wt.off[i] : 0);
          ct[i] = i < my ? wt.ct[i] : 0;
          slot[i] = i < my ? wt.red[i] : 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
        }
        for (int kk = k0; kk < k1 && my > 0; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, arow + kk * 16);
#pragma unroll
          for (int i = 0; i < kTilesPerWarp; ++i) {
            if (i < my) {
              uint32_t b0, b1;
              load_b(wp[i], row_b, bits, kk * 16, ct[i], lane, b0, b1);
              mma_bf16(acc[i], af, b0, b1);
            }
          }
        }
        const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
        for (int i = 0; i < kTilesPerWarp; ++i) {
          if (i < my) {
            float* rt = red + slot[i] * 128;  // the 16 x 8 tile
            rt[gq * 8 + 2 * tq] = acc[i][0];
            rt[gq * 8 + 2 * tq + 1] = acc[i][1];
            rt[(gq + 8) * 8 + 2 * tq] = acc[i][2];
            rt[(gq + 8) * 8 + 2 * tq + 1] = acc[i][3];
          }
        }
        __syncthreads();
        const int tiles = t.tiles, kparts = t.kparts;
        for (int o = tid; o < nr * n; o += kThreads) {
          const int rr = t.dn.q(o), c = o - rr * n, r = r0 + rr;
          float sum = 0.0f;
          for (int kp = 0; kp < kparts; ++kp)
            sum += red[(kp * tiles + (c >> 3)) * 128 + r * 8 + (c & 7)];
          ys[r * n + c] =
              (scale != nullptr ? __fmul_rn(sum, scale[c]) : sum) + bias[c];
        }
      }
    }
    __syncthreads();
  }

  // The qkv (parts 0-2) or cq (part 0) columns of ys into this block's
  // items: q scaled; k and v rounded to C and written to the fresh rows of
  // layer l.
  __device__ void take_items(int l, int p, float scale) {
    const ProdTab& t = pt[p];
    const int dh = sp.dh, sc = t.sc, n = t.n;
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const int part = t.dsc.q(c), e = c - part * sc;
      const int hh = ddh.q(e), d = e - hh * dh;
      for (int r = i0; r < i1; ++r) {
        const int li = hh * sp.rpb + (r - i0);
        float v = ys[r * n + c];
        if (part == 0) {
          v *= scale;
        } else {
          const int h = items[li].h;
          C* dst = (part == 1 ? fresh.k : fresh.v) + l * fresh.layer +
                   (row0 + r) * fresh.row + kv_head(h) * dh + d;
          if constexpr (kDecode) {
            // a finished row writes nothing; the fresh row joins
            // attention unrounded
            if (rpos()[r] >= 0) *dst = from_f32<C>(v);
          } else {
            // a dead row's fresh rows are NaN
            const C cv = from_f32<C>(
                rpos()[r] < 0 ? __int_as_float(0x7fffffff) : v);
            if (!kMqa || h == 0) *dst = cv;  // MQA: one writer a row
            v = to_f32(cv);
          }
        }
        iq[(li * 3 + part) * dh + d] = v;
      }
    }
    // the next step's tensor copies (the async proxy) read these slots
    if (kDecode && p == 0)
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    __syncthreads();
  }

  // ys's n columns of product p to every block's yfull (the residual's
  // summand): a thread a (block, 4-column chunk), over the rows.
  __device__ void push_rows(int p) {
    const ProdTab& t = pt[p];
    const int n = t.n, c0 = t.col0[0], nq = n >> 2;
    for (int i = threadIdx.x; i < (nq << log_cs); i += kThreads) {
      const int dst = i & (s.Cs - 1), cc = (i >> log_cs) * 4;
      float* to = cluster.map_shared_rank(yfull, dst) + c0 + cc;
      for (int r = 0; r < rows; ++r) store4(to + r * s.D, ys + r * n + cc);
    }
  }

  // relu(ys) of ff1 rounded to X into every block's xh (ff2's input).
  __device__ void push_hidden() {
    const ProdTab& t = pt[4];
    const int n = t.n, c0 = t.col0[0], nq = n >> 2;
    const int ldh = s.F + pad_of<X>();
    for (int i = threadIdx.x; i < (nq << log_cs); i += kThreads) {
      const int dst = i & (s.Cs - 1), cc = (i >> log_cs) * 4;
      X* to = cluster.map_shared_rank(xh, dst) + c0 + cc;
      for (int r = 0; r < rows; ++r) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = fmaxf(ys[r * n + cc + j], 0.0f);
        store4(to + r * ldh, v);
      }
    }
  }

  // x = LayerNorm(x + yfull) * g + b for the group's rows, and xa = x
  // rounded to X; g and b (D floats each) in shared memory. A row is split
  // over kWarps / rows warps where the rows are fewer than the warps, their
  // sums (of x and of x^2: var = E[x^2] - mean^2) meeting in shared memory.
  __device__ void add_norm(const float* g, const float* b) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int D = s.D, lda = D + pad_of<X>();
    // warps a row: a power of two (kWarps / rows for fewer rows)
    const int wpr = rows < kWarps ? kWarps / rows : 1;
    const int lw = __ffs(wpr) - 1, j = warp & (wpr - 1);
    for (int r = warp >> lw; r < rows; r += kWarps >> lw) {
      float* xr = x + r * D;
      const float* yr = yfull + r * D;
      float s1 = 0.0f, s2 = 0.0f;
      for (int d = j * 32 + lane; d < D; d += 32 * wpr) {
        const float v = xr[d] + yr[d];
        xr[d] = v;
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (wpr > 1) {  // rows <= kWarps / wpr: one pass of the loop
        if (lane == 0) {
          stats[2 * warp] = s1;
          stats[2 * warp + 1] = s2;
        }
        __syncthreads();
        s1 = 0.0f;
        s2 = 0.0f;
        for (int i = 0; i < wpr; ++i) {
          s1 += stats[2 * (warp - j + i)];
          s2 += stats[2 * (warp - j + i) + 1];
        }
      }
      const float mean = s1 / D;
      const float inv = rsqrtf(fmaxf(s2 / D - mean * mean, 0.0f) + 1e-5f);
      for (int d = j * 32 + lane; d < D; d += 32 * wpr) {
        const float v = (xr[d] - mean) * inv * g[d] + b[d];
        xr[d] = v;
        xa[r * lda + d] = from_f32<X>(v);
      }
    }
    if (wpr > 1 && (warp >> lw) >= rows) __syncthreads();  // idle warps
  }

  // This block's attention items of layer l: self-attention over slots
  // [0, pos) of the self cache (kRing: [0, seg) of the cache and
  // [seg, pos) of the segment ring) and the fresh row at pos, or
  // cross-attention over the L_enc slots of the cross K/V; slots staged in
  // shared memory are read there, the rest from device memory. An item
  // takes kWarps / ipb warps where the items are fewer than the warps (at
  // most one a 16 slots),
  // each a contiguous share of its slots: a warp's lanes split its slots
  // (dh / 16-byte vectors a slot) in one pass with an online softmax, the
  // warps' partial states (max, denominator, weighted sum) meet in shared
  // memory, and the item's first warp writes its output, rounded to X,
  // into this block's xo; then all threads copy the block's outputs to
  // the other blocks' xo.
  __device__ void attend(int l, bool self_attn) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int dh = sp.dh;
    const int nvec = dh / kVec, spi = 32 / nvec;
    const int v = lane & (nvec - 1), sub = lane / nvec;
    const int lda = s.D + pad_of<X>();
    const int lw = self_attn ? lw_self : lw_cross, wpi = 1 << lw;
    const int j = warp & (wpi - 1);
    float* mine = part + warp * (dh + 2);  // acc[dh], m, den
    for (int base = 0; base < sp.ipb; base += kWarps >> lw) {
      const int li = base + (warp >> lw);
      const int r = li < sp.ipb ? items[li].r : -1;
      const int h = li < sp.ipb ? items[li].h : 0;
      const bool real = r >= 0;
      if (real) {
        const float* qv = iq + li * 3 * dh;
        const float* fk = qv + dh;
        const float* fv = qv + 2 * dh;
        const C *K, *V, *Ks;
        size_t stride, kv_stride;
        int n_cache, n, cap;
        if (self_attn) {
          const size_t at =
              l * self.layer + (row0 + r) * self.row + kv_head(h) * dh;
          K = self_k + at;
          V = self_v + at;
          stride = self.slot;
          n_cache = rpos()[r];
          n = n_cache + 1;
          cap = s.cap_self;
          Ks = kvs + 2 * li * kv_self / sizeof(C);
          kv_stride = kv_self / sizeof(C);
        } else {
          const size_t at = (static_cast<size_t>(l) * s.pool + row0 + r) *
                                s.L_enc * s.D + h * dh;
          K = cross_k + at;
          V = cross_v + at;
          stride = s.D;
          n_cache = s.L_enc;
          n = s.L_enc;
          cap = s.cap_cross;
          Ks = kvc + 2 * li * kv_cross / sizeof(C);
          kv_stride = kv_cross / sizeof(C);
        }
        const C* Vs = Ks + kv_stride;
        // the slots before the fresh row; kRing: n_cache of them from the
        // cache, the rest from the ring (Kr, Vr at slot n_cache)
        const int n_old = n_cache;
        const C *Kr = nullptr, *Vr = nullptr;
        if constexpr (kRing) {
          if (self_attn) {
            n_cache = rseg()[r];
            const size_t at = l * sring.layer + (row0 + r) * sring.row +
                              kv_head(h) * dh;
            Kr = sring.k + at;
            Vr = sring.v + at;
          }
        }
        const int per = (n + wpi - 1) >> lw;
        const int t0 = min(n, j * per), t1 = min(n, t0 + per);
        float q[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) q[e] = qv[v * kVec + e];

        // kU slots a lane at a time; the nvec lanes of a slot each take one
        // 16-byte vector, a butterfly gives them the slot's logit; each
        // lane keeps the running max m, the denominator and its vector's
        // weighted sum of its slots
        float m = -INFINITY, den = 0.0f, acc[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
        for (int s0 = t0; s0 < t1; s0 += spi * kU) {
          uint4 rk[kU], rv[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int t = s0 + u * spi + sub;
            if (t < t1 && t < n_old) {
              if (kRing && t >= n_cache) {
                const size_t at = (t - n_cache) * sring.slot + v * kVec;
                rk[u] = *reinterpret_cast<const uint4*>(Kr + at);
                rv[u] = *reinterpret_cast<const uint4*>(Vr + at);
              } else if (t < cap) {
                const size_t at = static_cast<size_t>(t) * dh + v * kVec;
                rk[u] = *reinterpret_cast<const uint4*>(Ks + at);
                rv[u] = *reinterpret_cast<const uint4*>(Vs + at);
              } else {
                const size_t at = t * stride + v * kVec;
                rk[u] = *reinterpret_cast<const uint4*>(K + at);
                rv[u] = *reinterpret_cast<const uint4*>(V + at);
              }
            }
          }
          float lgt[kU];
          float cm = -INFINITY;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int t = s0 + u * spi + sub;
            float kv[kVec];
            if (t < n_old) {
              raw_to_f32<C>(rk[u], kv);
            } else {
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                kv[e] = t < n ? fk[v * kVec + e] : 0.0f;
            }
            float d = 0.0f;
#pragma unroll
            for (int e = 0; e < kVec; ++e) d = fmaf(q[e], kv[e], d);
            for (int o = 1; o < nvec; o <<= 1)
              d += __shfl_xor_sync(0xffffffffu, d, o);
            lgt[u] = t < t1 ? d : -INFINITY;
            cm = fmaxf(cm, lgt[u]);
          }
          if (cm == -INFINITY) continue;  // none of this lane's slots
          const float mn = fmaxf(m, cm);
          const float corr = expf(m - mn);  // 0 while m is -inf
          den *= corr;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] *= corr;
          m = mn;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int t = s0 + u * spi + sub;
            if (t < t1) {
              float vv[kVec];
              if (t < n_old) {
                raw_to_f32<C>(rv[u], vv);
              } else {
#pragma unroll
                for (int e = 0; e < kVec; ++e) vv[e] = fv[v * kVec + e];
              }
              const float ex = expf(lgt[u] - m);
              den += ex;
#pragma unroll
              for (int e = 0; e < kVec; ++e) acc[e] = fmaf(ex, vv[e], acc[e]);
            }
          }
        }
        // merge the slot lanes of each vector (an empty lane has m = -inf)
        for (int o = nvec; o < 32; o <<= 1) {
          const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
          const float d2 = __shfl_xor_sync(0xffffffffu, den, o);
          const float mn = fmaxf(m, m2);
          const float c1 = m == -INFINITY ? 0.0f : expf(m - mn);
          const float c2 = m2 == -INFINITY ? 0.0f : expf(m2 - mn);
          den = den * c1 + d2 * c2;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float a2 = __shfl_xor_sync(0xffffffffu, acc[e], o);
            acc[e] = acc[e] * c1 + a2 * c2;
          }
          m = mn;
        }
        if (sub == 0) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) mine[v * kVec + e] = acc[e];
        }
        if (lane == 0) {
          mine[dh] = m;
          mine[dh + 1] = den;
        }
      }
      if (wpi > 1) __syncthreads(); else __syncwarp();
      if (real && j == 0) {
        // the item's wpi partial states -> its output, staged in mine
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kWarps; ++i)
          if (i < wpi) mx = fmaxf(mx, mine[i * (dh + 2) + dh]);
        float wgt[kWarps];  // wpi <= kWarps
        float total = 0.0f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) {
          const float mi = i < wpi ? mine[i * (dh + 2) + dh] : -INFINITY;
          wgt[i] = mi == -INFINITY ? 0.0f : expf(mi - mx);
          if (i < wpi) total += mine[i * (dh + 2) + dh + 1] * wgt[i];
        }
        const float inv = 1.0f / total;
        for (int d = lane; d < dh; d += 32) {
          float o = 0.0f;
#pragma unroll
          for (int i = 0; i < kWarps; ++i)
            if (i < wpi) o += mine[i * (dh + 2) + d] * wgt[i];
          xo[r * lda + h * dh + d] = from_f32<X>(o * inv);
        }
      }
      // `part` is the next round's (no barrier after the last round: the
      // one below covers it)
      if (base + (kWarps >> lw) < sp.ipb) {
        if (wpi > 1) __syncthreads(); else __syncwarp();
      }
    }
    // this block's item outputs (in its own xo) to the other blocks: a
    // thread a (block, item, 4 values)
    __syncthreads();
    const int g4 = dh / 4, n4 = sp.ipb * g4;
    for (int i = threadIdx.x; i < (n4 << log_cs); i += kThreads) {
      const int dst = i & (s.Cs - 1), e = i >> log_cs;
      const int li = dg4.q(e), at = (e - li * g4) * 4;
      const int r = items[li].r;
      if (dst == rank || r < 0) continue;
      const int o = r * lda + items[li].h * dh + at;
      copy4(cluster.map_shared_rank(xo, dst) + o, xo + o);
    }
  }

  // Each row's slot, before start(): pos[row0 + r] from device memory (B7),
  // or the launch's s.pos for every row (B1, B10, B11: pos null). A row of
  // B7 or B10 (prev given) whose slot lies outside [0, Tc) or whose prev
  // token outside [0, V) is dead (-1): it reads no table or
  // cache, its attention items are skipped, and its outputs are NaN (nxt
  // -1); its products compute on whatever its rows hold, which reaches no
  // other row. kRing: also a row whose segment start seg[row0 + r] lies
  // outside [pos - (S - 1), pos]; rseg() takes each row's start (0 for a
  // dead row).
  __device__ void positions(const int* pos, const int* prev, int Tc,
                            int V) {
    const int r = threadIdx.x;
    if (r < s.Mg) {
      int p = s.pos;
      if (prev != nullptr) {
        p = -1;
        if (r < rows) {
          const int q = pos != nullptr ? pos[row0 + r] : s.pos;
          const int tok = prev[row0 + r];
          if (q >= 0 && q < Tc && tok >= 0 && tok < V) p = q;
        }
      }
      if constexpr (kRing) {
        const int g = p >= 0 ? sring.seg[row0 + r] : 0;
        if (g < 0 || g > p || p - g >= s.seg_ring) p = -1;
        rseg()[r] = p >= 0 ? g : 0;
      }
      rpos()[r] = p;
    }
    __syncthreads();
  }

  // The prologue of B7, B10 and B12, after start(): x =
  // round_to<C>(emb[tok[r]] + pos_emb[min(pos[r], Tpos - 1)]) from the
  // float32 tables for the group's live rows (zero for a dead one), and
  // xa = x rounded to X: a slot past the position table of Tpos rows takes
  // its last row, as the reference's gather clamps the index. tok: the
  // group's previous tokens (device or shared memory).
  __device__ void embed(const int* tok, const float* emb,
                        const float* pos_emb, int Tpos) {
    const int D = s.D, lda = D + pad_of<X>();
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D, p = rpos()[r];
      const float v =
          p < 0 ? 0.0f
                : round_to<C>(emb[static_cast<size_t>(tok[r]) * D + d] +
                              pos_emb[static_cast<size_t>(min(p, Tpos - 1)) *
                                          D +
                                      d]);
      x[i] = v;
      xa[r * lda + d] = from_f32<X>(v);
    }
  }

  // The float32 head of B7, B10 and B12 (before start()): w_head (D, V) and
  // b_head (V), split over the cluster's blocks in segments of
  // ceil(V / Cs) columns (B12: Shape::hres).
  __device__ void with_head(const float* w_head, const float* b_head, int V) {
    hw = w_head;
    hb = b_head;
    hV = V;
    hc = (V + s.Cs - 1) / s.Cs;
    hc0 = min(V, rank * hc);
    hn = min(V, hc0 + hc) - hc0;
  }

  // This block's head segment (its hn columns of w_head, rows at a stride
  // of hc floats, then its b_head values) to wh by 4-byte cp.async
  // (w_head's 4 V-byte rows need not be 16-byte aligned, which a tensor
  // copy would), waited for in head_logits(): into a ring stage, issued by
  // every thread as the last sublayer starts (or after it with a one-stage
  // ring), or for B12 once into its resident segment (start()).
  __device__ void copy_head(float* wh) {
    for (int e = threadIdx.x; e < s.D * hn; e += kThreads) {
      const int k = e / hn, j = e - k * hn;
      cp_async4_zfill(wh + k * hc + j,
                      hw + static_cast<size_t>(k) * hV + hc0 + j, 4);
    }
    for (int j = threadIdx.x; j < hn; j += kThreads)
      cp_async4_zfill(wh + s.D * hc + j, hb + hc0 + j, 4);
  }

  // The head's first part, after run(): each block computes its columns of
  // the group's logits, x W_head + b_head in float32 FMA, the reduction
  // split where outputs are few, into ys (rows x hn).
  __device__ void head_logits() {
    const int tid = threadIdx.x;
    if (!kDecode && s.stages == 1)
      copy_head(reinterpret_cast<float*>(stage_at(0)));
    cp_async_wait_all();
    __syncthreads();
    const float* wh = kDecode ? hres
                              : reinterpret_cast<const float*>(stage_at(
                                    (kSublayers * s.L) % s.stages));
    const float* bh = wh + s.D * hc;
    const int D = s.D, outs = rows * hn;
    float* hl = ys;  // the block's logits, rows x hn
    if (outs > 0) {
      const int kparts = outs >= kThreads ? 1 : kThreads / outs;
      const int kchunk = (D + kparts - 1) / kparts;
      for (int item = tid; item < outs * kparts; item += kThreads) {
        const int o = item % outs, kp = item / outs;
        const int r = o / hn, c = o - r * hn;
        const int k1 = min(D, (kp + 1) * kchunk);
        float acc = 0.0f;
        for (int k = kp * kchunk; k < k1; ++k)
          acc = fmaf(x[r * D + k], wh[k * hc + c], acc);
        red[item] = acc;
      }
      __syncthreads();
      for (int o = tid; o < outs; o += kThreads) {
        float sum = 0.0f;
        for (int kp = 0; kp < kparts; ++kp) sum += red[kp * outs + o];
        hl[o] = sum + bh[o % hn];
      }
    }
    __syncthreads();
  }

  // Each row's (max, its first index, sum exp(l - max)) over this block's
  // columns (ys) to the hstat of block 0, or of every block (`all`).
  __device__ void head_triples(bool all) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float* hl = ys;
    for (int r = warp; r < rows; r += kWarps) {
      float m = -INFINITY;
      int mi = hV;
      for (int c = lane; c < hn; c += 32) {
        const float v = hl[r * hn + c];
        if (v > m) {
          m = v;
          mi = hc0 + c;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m, o);
        const int oi = __shfl_xor_sync(0xffffffffu, mi, o);
        if (om > m || (om == m && oi < mi)) {
          m = om;
          mi = oi;
        }
      }
      float se = 0.0f;
      if (m > -INFINITY)
        for (int c = lane; c < hn; c += 32) se += expf(hl[r * hn + c] - m);
      se = warp_sum(se);
      if (lane < (all ? s.Cs : 1)) {
        float* to =
            cluster.map_shared_rank(hstat, lane) + (rank * s.Mg + r) * 3;
        to[0] = m;
        to[1] = se;
        to[2] = __int_as_float(mi);
      }
    }
  }

  // Row r's pick from the blocks' triples in this block's hstat, merged as
  // an online softmax (the lower index on a tie: the first index of the
  // max): its index and log(p_max + 1e-10) with _argmax_head's
  // expressions.
  __device__ void merge(int r, int& index, float& lp) const {
    float mv = -INFINITY;
    int mi = hV;
    for (int b = 0; b < s.Cs; ++b) {
      const float* t = hstat + (b * s.Mg + r) * 3;
      const int i = __float_as_int(t[2]);
      if (t[0] > mv || (t[0] == mv && i < mi)) {
        mv = t[0];
        mi = i;
      }
    }
    float se = 0.0f;
    for (int b = 0; b < s.Cs; ++b) {
      const float* t = hstat + (b * s.Mg + r) * 3;
      if (t[0] > -INFINITY) se += t[1] * expf(t[0] - mv);
    }
    index = mi;
    lp = logf(expf(mv - (mv + logf(se))) + 1e-10f);
  }

  // The epilogue of B7 and B10, after run(): the group's logits
  // (head_logits). With `logits`, each block writes its columns (NaN in a
  // dead row). Else each block reduces its columns of a row to a triple,
  // and block 0 merges the blocks' triples after one more cluster barrier
  // and writes nxt and the log-probability (nxt -1 and NaN in a dead row).
  __device__ void head(float* logits, int* nxt, float* logp) {
    head_logits();
    const float nan = __int_as_float(0x7fffffff);
    if (logits != nullptr) {
      for (int o = threadIdx.x; o < rows * hn; o += kThreads) {
        const int r = o / hn, c = o - r * hn;
        logits[static_cast<size_t>(row0 + r) * hV + hc0 + c] =
            rpos()[r] < 0 ? nan : ys[o];
      }
      return;
    }
    head_triples(false);
    cluster.sync();
    if (rank == 0 && static_cast<int>(threadIdx.x) < rows) {
      const int r = threadIdx.x;
      int mi;
      float lp;
      merge(r, mi, lp);
      const bool dead = rpos()[r] < 0;
      nxt[row0 + r] = dead ? -1 : mi;
      logp[row0 + r] = dead ? nan : lp;
    }
  }

  // B12's decode state in shared memory (Layout::dec): each row's
  // previous token, log-prob sum and count.
  __device__ int* prev_tok() const { return dec; }
  __device__ float* lp_sum() const {
    return reinterpret_cast<float*>(dec + kGroupMax);
  }
  __device__ int* count() const { return dec + 2 * kGroupMax; }

  // B12, before start(): every row of the group at slot 0, fed sos_id.
  __device__ void begin_decode(int sos_id) {
    const int r = threadIdx.x;
    if (r < kGroupMax) {
      rpos()[r] = r < rows ? 0 : -1;
      prev_tok()[r] = sos_id;
      lp_sum()[r] = 0.0f;
      count()[r] = 0;
    }
    __syncthreads();
  }

  // B12's epilogue of step t, after run(): the head's triples go to every
  // block, so that after one cluster barrier each block merges them alike
  // and keeps the same decode state. Each live row takes its pick (block 0
  // writes it to tokens, row stride T_out) and adds its log-probability;
  // one that picks eos_id finishes (its count stays), the others count it
  // and move to slot t + 1. A finished row gets pad_id. Then the items of
  // the rows that finished are dropped and the stage bytes counted again.
  // Returns whether a row of the group is still live (the same in every
  // block).
  __device__ bool pick(int t, int T_out, int eos_id, int pad_id,
                       int* tokens) {
    head_logits();
    head_triples(true);
    cluster.sync();
    const int tid = threadIdx.x;
    if (tid < rows) {
      const int r = tid;
      int tok = pad_id;
      if (rpos()[r] >= 0) {
        float lp;
        merge(r, tok, lp);
        lp_sum()[r] += lp;
        if (tok == eos_id) {
          rpos()[r] = -1;
        } else {
          count()[r] += 1;
          prev_tok()[r] = tok;
          rpos()[r] = t + 1;
        }
      }
      if (rank == 0) tokens[static_cast<size_t>(row0 + r) * T_out + t] = tok;
    }
    __syncthreads();
    bool live = false;
    for (int r = 0; r < rows; ++r) live = live || rpos()[r] >= 0;
    if (live && t + 1 < T_out) {
      if (tid < sp.ipb && items[tid].r >= 0 && rpos()[items[tid].r] < 0)
        items[tid].r = -1;
      __syncthreads();
      count_bytes();
      __syncthreads();
    }
    return live;
  }

  // Every layer; see the file's head. One loop over the sublayers, so
  // that each phase's code appears once in the kernel.
  __device__ void run() {
    int st = 0, ph = 0;
    run(st, ph);
  }

  // run() from the ring's stage st and its barrier's parity ph, which it
  // leaves at the next step's first sublayer (B12 carries them over steps).
  __device__ void run(int& st, int& ph) {
    const float scale = 1.0f / sqrtf(static_cast<float>(sp.dh));
    const int lda = s.D + pad_of<X>(), ldh = s.F + pad_of<X>();
    for (int g = 0; g < kSublayers * s.L; ++g) {
      const int l = g / kSublayers, p = g - l * kSublayers;
      const bool heads = p == 0 || p == 2;  // qkv, cq: this block's heads
      product(g, st, ph, p == 5 ? xh : (p & 1) ? xo : xa,
              p == 5 ? ldh : lda, heads ? i0 : 0, heads ? i1 : rows);
      if (heads) {
        take_items(l, p, scale);
        attend(l, p == 0);
      } else if (p == 4) {
        push_hidden();
      } else {
        push_rows(p);
      }
      cluster.sync();
      if (p & 1) {  // out, co, ff2: residual and LayerNorm
        const float* ln = extras_at(st) + 2 * nmax;
        add_norm(ln, ln + s.D);
      }
      if (++st == s.stages) {
        st = 0;
        ph ^= 1;
      }
    }
    __syncthreads();
  }

  // B12, before the block exits: wait for the stages the ring issued for
  // a step that does not come (the next stages - 1 sublayers), so that no
  // copy lands in shared memory after it.
  __device__ void drain(int st, int ph) {
    for (int i = 0; i < s.stages - 1; ++i) {
      mbar_wait(bars + st, ph);
      if (++st == s.stages) {
        st = 0;
        ph ^= 1;
      }
    }
  }
};

// ---------------------------------------------------------------------
// The host's plan of a launch, shared by the cluster kernels (B1 and B11
// in fused_step.cu, B7 in ragged_step.cu, B10 in whole_step.cu, B12 in
// whole_decode.cu): the Shape a kernel takes, its tensor maps, and its
// launch configuration.

// Blocks of a cluster: the portable size, the fastest of 4, 8 and 16 on an
// H100 at 1 and 16 rows (PERF.md, the decoder step's cluster shapes).
constexpr int kClusterBlocks = 8;
// What an entry returns for a model or batch the kernel does not take.
constexpr int kRefused = -1;

// The largest count of an item's slots (rows of `row` bytes, K and V) that
// `bytes` of shared memory hold for `items` items, at most `most`.
inline int slots_in(size_t bytes, int items, int row, int most) {
  const size_t each = bytes / (2 * static_cast<size_t>(items));
  int n = static_cast<int>(std::min<size_t>(most, each / row));
  while (n > 0 && align128(static_cast<size_t>(n) * row) > each) --n;
  return n;
}

// The Shape of a launch with Mg rows a group and kClusterBlocks blocks a
// cluster (stages 0 if the kernel does not take it: the heads an even
// split over the blocks or the blocks over the heads, each block's
// columns of every product a multiple of 8, or 16 for int8, and at most
// kBox, a block's columns of a product at most 8 kTilesPerWarp a warp, K
// of every product at most kBox or a multiple of it, a head's row 2^k
// 16-byte vectors, shared memory for the activations and one stage). The
// ring takes as many stages as fit up to kMaxStages, at least two if one
// stage would leave the cache unstaged; what is left stages the items'
// cross K/V slots, then their self-cache slots (up to Tc - 1, and kBox,
// slots). Hkv: the self caches' KV heads, H (MHA) or 1 (MQA, one head a
// block: H <= Cs); grouped attention (1 < Hkv < H) is not taken. hres:
// B12's resident head columns a block (before the staging); time_major:
// the self caches are (L, T, B, D) (B10 "v4"); seg_ring: B7's ring rows S
// in ring mode (the rows' segment starts take shared memory), else 0. The
// caches' rows (pool) are B's; a launch over fewer rows than its caches
// hold (B7's n_chunks) sets pool after.
// This is the one statement of the shapes the kernel takes.
template <typename W, typename C>
Shape make_shape(int L, int B, int Tc, int D, int H, int Hkv, int F,
                 int L_enc, int pos, int Mg, int hres = 0,
                 int time_major = 0, int seg_ring = 0) {
  const int Cs = kClusterBlocks;
  Shape s{L,  B,  D, H, F,    L_enc,      pos, Hkv,
          Mg, Cs, 0, 0, 0, hres, time_major, B,   seg_ring};
  const int cols = std::max(8, 16 / static_cast<int>(sizeof(W)));
  const int dh = H > 0 ? D / H : 0;
  const int nvec = dh * static_cast<int>(sizeof(C)) / 16;
  const int bph = Cs >= H ? Cs / std::max(H, 1) : 1;
  const bool ok =
      B >= 1 && L >= 1 && H >= 1 && D % H == 0 && L_enc >= 1 && pos >= 0 &&
      seg_ring >= 0 &&
      (Hkv == H || (Hkv == 1 && H <= Cs && !time_major)) &&
      pos < Tc && Mg >= 1 && Mg <= kGroupMax &&
      (Cs % H == 0 || H % Cs == 0) && Mg % bph == 0 &&
      (dh * sizeof(C)) % 16 == 0 && nvec <= 32 && (nvec & (nvec - 1)) == 0 &&
      dh % cols == 0 && D % (Cs * cols) == 0 && F % (Cs * cols) == 0 &&
      D % 16 == 0 && F % 16 == 0 && F / Cs <= kBox && D / Cs <= kBox &&
      dh <= kBox && (D <= kBox || D % kBox == 0) &&
      (F <= kBox || F % kBox == 0);
  if (!ok) return s;
  const Split split(s);
  if (split.ipb > kMaxItems) return s;
  for (int p = 0; p < kSublayers; ++p)
    if (split.cols(s, p) > 8 * kTilesPerWarp * kThreads / 32) return s;
  const int items = Split(s).ipb;
  const int row = dh * static_cast<int>(sizeof(C));
  const int most_self = std::min(std::max(Tc - 1, 0), kBox);
  const int most_cross = std::min(L_enc, kBox);
  const size_t want =
      2 * items * (align128(static_cast<size_t>(row) * most_self) +
                   align128(static_cast<size_t>(row) * most_cross));
  int fit = 0;
  for (int n = 1; n <= kMaxStages; ++n) {
    s.stages = n;
    if (Layout<W, C>(s).end + 1024 <= kSmemMax) fit = n;
  }
  if (fit == 0) {
    s.stages = 0;
    return s;
  }
  s.stages = fit;
  for (int n = fit; n >= std::min(2, fit); --n) {  // the most stages that
    s.stages = n;                                  // stage every slot
    if (Layout<W, C>(s).end + 1024 + want <= kSmemMax) break;
  }
  const size_t room = kSmemMax - 1024 - Layout<W, C>(s).end;
  s.cap_cross = slots_in(room, items, row, most_cross);
  s.cap_self = slots_in(
      room - 2 * items * align128(static_cast<size_t>(row) * s.cap_cross),
      items, row, most_self);
  return s;
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// the driver library).
inline cudaError_t encoder(Encode* out) {
  static std::atomic<Encode> fn{nullptr};  // threads that race store the same
  Encode f = fn.load();
  if (f == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    f = reinterpret_cast<Encode>(p);
    fn.store(f);
  }
  *out = f;
  return cudaSuccess;
}

// cuTensorMapEncodeTiled needs the context current in the calling
// thread. The runtime makes it current at a thread's first call
// that touches the device, and a launch whose every earlier step the
// caches answered makes none: a host thread whose first CUDA work is a
// launch of these kernels (a server's executor thread) has no context
// there, and the encode fails. So each thread binds it once.
inline cudaError_t bind_context() {
  thread_local bool bound = false;
  if (bound) return cudaSuccess;
  const cudaError_t err = cudaFree(nullptr);
  bound = err == cudaSuccess;
  return err;
}

template <typename T>
CUtensorMapDataType tma_type() {
  if constexpr (std::is_same_v<T, float>) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if constexpr (std::is_same_v<T, int8_t>) return CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The tensor map of a tensor of T at ptr (dims innermost first; byte
// strides of dims 1.. in `strides`, or dense if null) copied in boxes of
// `box`. A map with `keep` is encoded once and kept (a decode's steps use
// the same weights and cross K/V); the self-cache maps end at pos, which
// every step moves, and are encoded for each launch. The kept maps are
// read and written under their lock (host threads launch at once); the
// encode runs outside it.
template <typename T>
cudaError_t tensor_map(CUtensorMap* out, const void* ptr, int rank,
                       const uint64_t* dims, const uint32_t* box,
                       int swizzle_bits, const uint64_t* strides = nullptr,
                       bool keep = true) {
  struct Key {
    const void* ptr;
    uint64_t dims[4];
    uint32_t box[4];
    int rank, swizzle;
  };
  static std::mutex lock;
  static Key keys[64];
  static CUtensorMap maps[64];
  static int used = 0, next = 0;
  Key key;
  std::memset(&key, 0, sizeof(key));  // padding too: keys compare as bytes
  key.ptr = ptr;
  key.rank = rank;
  key.swizzle = swizzle_bits;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
  }
  if (keep) {
    std::lock_guard<std::mutex> guard(lock);
    for (int i = 0; i < used; ++i) {
      if (std::memcmp(&keys[i], &key, sizeof(Key)) == 0) {
        *out = maps[i];
        return cudaSuccess;
      }
    }
  }
  Encode fn;
  cudaError_t err = encoder(&fn);
  if (err == cudaSuccess) err = bind_context();
  if (err != cudaSuccess) return err;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], estride[4];
  cuuint64_t stride = sizeof(T);
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = strides != nullptr ? strides[i - 1] : stride;
    stride *= dims[i];
  }
  if (fn(out, tma_type<T>(), rank, const_cast<void*>(ptr), gdim, gstride,
         bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle_bits == 1   ? CU_TENSOR_MAP_SWIZZLE_32B
         : swizzle_bits == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
         : swizzle_bits == 3 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_NONE,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (!keep) return cudaSuccess;
  std::lock_guard<std::mutex> guard(lock);
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % 64;
  used = std::max(used, next == 0 ? 64 : next);
  return cudaSuccess;
}

// The launch's tensor maps: the six weights, the self caches' first
// self_slots slots of their Tc (B1, B10 and B11: the slots before pos, at
// least one, which a step at pos 0 never copies; encoded for each launch;
// B7 and B12: all Tc, kept with keep_self), batch-major or, with
// s.time_major, over (D, B, slots, L), and the cross K/V.
template <typename W, typename C>
cudaError_t make_maps(const Shape& s, int Tc, int self_slots, bool keep_self,
                      const void* const* wp, const void* self_k,
                      const void* self_v, const void* cross_k,
                      const void* cross_v, Maps* maps) {
  const Split sp(s);
  for (int p = 0; p < kSublayers; ++p) {
    const int K = sp.k(s, p);
    const uint64_t dims[3] = {static_cast<uint64_t>(sp.n_all(s, p)),
                              static_cast<uint64_t>(K),
                              static_cast<uint64_t>(s.L)};
    const uint32_t box[3] = {static_cast<uint32_t>(sp.seg_cols(s, p)),
                             static_cast<uint32_t>(
                                 std::min(K, kBox)),
                             1};
    const cudaError_t err = tensor_map<W>(
        &maps->w[p], wp[3 * p], 3, dims, box,
        swizzle_bits(sp.seg_cols(s, p) * sizeof(W)));
    if (err != cudaSuccess) return err;
  }
  const uint64_t kvd = static_cast<uint64_t>(s.Hkv) * sp.dh;
  const uint64_t row = kvd * sizeof(C);
  const uint64_t slots = static_cast<uint64_t>(self_slots);
  const uint64_t B = static_cast<uint64_t>(s.pool);
  const uint64_t self_dims[4] = {kvd,
                                 s.time_major ? B : slots,
                                 s.time_major ? slots : B,
                                 static_cast<uint64_t>(s.L)};
  // batch-major (L, B, Tc, kvd): slot, row, layer; time-major
  // (L, Tc, B, D): row, slot, layer
  const uint64_t self_strides[3] = {row, s.time_major ? row * B : row * Tc,
                                    row * Tc * B};
  const uint64_t cross_dims[4] = {static_cast<uint64_t>(s.D),
                                  static_cast<uint64_t>(s.L_enc),
                                  static_cast<uint64_t>(s.pool),
                                  static_cast<uint64_t>(s.L)};
  const uint32_t cap = static_cast<uint32_t>(std::max(s.cap_self, 1));
  const uint32_t self_box[4] = {static_cast<uint32_t>(sp.dh),
                                s.time_major ? 1u : cap,
                                s.time_major ? cap : 1u, 1};
  const uint32_t cross_box[4] = {
      static_cast<uint32_t>(sp.dh),
      static_cast<uint32_t>(std::max(s.cap_cross, 1)), 1, 1};
  cudaError_t err = tensor_map<C>(&maps->self_k, self_k, 4, self_dims,
                                  self_box, 0, self_strides, keep_self);
  if (err == cudaSuccess)
    err = tensor_map<C>(&maps->self_v, self_v, 4, self_dims, self_box, 0,
                        self_strides, keep_self);
  if (err == cudaSuccess)
    err = tensor_map<C>(&maps->cross_k, cross_k, 4, cross_dims, cross_box, 0);
  if (err == cudaSuccess)
    err = tensor_map<C>(&maps->cross_v, cross_v, 4, cross_dims, cross_box, 0);
  return err;
}

// The launch configuration of a Shape, and in *active the clusters of its
// shape that fit on the card at once.
template <typename W, typename C>
cudaError_t configure(const void* kernel, const Shape& s,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      cudaStream_t st, int* active) {
  static std::mutex lock;  // host threads launch at once
  static const void* opted_in[16];
  static int n_opted = 0;
  {
    std::lock_guard<std::mutex> guard(lock);
    if (std::find(opted_in, opted_in + n_opted, kernel) ==
        opted_in + n_opted) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kSmemMax));
      if (err != cudaSuccess) return err;
      if (n_opted < 16) opted_in[n_opted++] = kernel;
    }
  }
  const int groups = (s.B + s.Mg - 1) / s.Mg;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(s.Cs * groups));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<W, C>(s).end + 1024;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(s.Cs);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return active_clusters(kernel, cfg, active);
}

// The Shape of a step for B rows: the fewest rows a group (so the most
// clusters) whose groups all fit on the card at once, 16 if none does.
// stages 0: no shape the kernel takes.
template <typename W, typename C>
cudaError_t choose_shape(const void* kernel, int L, int B, int Tc, int D,
                         int H, int Hkv, int F, int L_enc, int pos,
                         Shape* out, int hres = 0, int time_major = 0,
                         int seg_ring = 0) {
  Shape last{};
  for (int Mg = 1; Mg <= kGroupMax; Mg *= 2) {
    const Shape s = make_shape<W, C>(L, B, Tc, D, H, Hkv, F, L_enc, pos, Mg,
                                     hres, time_major, seg_ring);
    if (s.stages < 1) continue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int active = 0;
    const cudaError_t err =
        configure<W, C>(kernel, s, cfg, attr, nullptr, &active);
    if (err != cudaSuccess) return err;
    last = s;
    if ((B + Mg - 1) / Mg <= active) break;
  }
  *out = last;
  return cudaSuccess;
}

// Whether the float32 head of V columns fits a Shape (Step::head): a
// block's segment of ceil(V / Cs) columns of w_head and b_head in one
// stage (B12 keeps it resident instead, in Layout::head), its logits in
// ys and their partial sums in red.
template <typename W, typename C>
bool head_fits(const Shape& s, int V) {
  const Layout<W, C> lay(s);
  const int hc = (V + s.Cs - 1) / s.Cs;
  const bool staged =
      s.hres > 0 ||
      sizeof(float) * (static_cast<size_t>(s.D) + 1) * hc <= lay.stage;
  return V >= 1 && hc <= lay.nmax && staged &&
         s.Mg * hc + kThreads <= 128 * kWarps * kTilesPerWarp;
}

// The columns of the head of V columns a block keeps (its segment).
inline int head_cols(int V) {
  return (V + kClusterBlocks - 1) / kClusterBlocks;
}

// The launch geometry of a step for B rows at the last slot (with the
// float32 head of V columns, or none if V is 0; resident in shared memory
// with `resident`, as B12 keeps it): out[0..7] = blocks a cluster,
// clusters, rows a group, shared memory bytes a block, stages of the ring,
// clusters the card holds at once, self-cache and cross K/V slots an item
// stages. Returns the error a launch would (kRefused for a shape the
// kernel does not take).
template <typename W, typename C>
int geometry(const void* kernel, int B, int Tc, int D, int H, int Hkv,
             int F, int L_enc, int V, int* out, bool resident = false) {
  Shape s;
  cudaError_t err = choose_shape<W, C>(kernel, 1, B, Tc, D, H, Hkv, F,
                                       L_enc, Tc - 1, &s,
                                       resident ? head_cols(V) : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.stages < 1 || (V > 0 && !head_fits<W, C>(s, V))) return kRefused;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  err = configure<W, C>(kernel, s, cfg, attr, nullptr, &active);
  out[0] = s.Cs;
  out[1] = (s.B + s.Mg - 1) / s.Mg;
  out[2] = s.Mg;
  out[3] = static_cast<int>(cfg.dynamicSmemBytes);
  out[4] = s.stages;
  out[5] = active;
  out[6] = s.cap_self;
  out[7] = s.cap_cross;
  return static_cast<int>(err);
}

// The cluster kernels, by their id in the one geometry entry
// (cluster_geometry, fused_step.cu). Each source file defines its own
// lookup: its kernel for an int8 or a float bundle over float32 or bf16
// caches (B1 and B7: and MQA's, one KV head), or nullptr where it has no
// entry for that pair.
enum Kernel { kFusedStep, kRaggedStep, kWholeStep, kWholeDecode };
const void* fused_step_kernel(bool int8, bool f32, bool mqa);
const void* ragged_step_kernel(bool int8, bool f32, bool mqa);
const void* whole_step_kernel(bool int8, bool f32);
const void* whole_decode_kernel(bool int8, bool f32);

}  // namespace cluster_step
