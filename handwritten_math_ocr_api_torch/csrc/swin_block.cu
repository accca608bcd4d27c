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
// far above the card's ~295 bf16 flops per byte: the bound is the tensor
// cores' rate. mma.sync reaches about half of it on this card, and a
// block's serial phases (LN, the products' weight waits, attention, the
// exchanges' barriers) keep this kernel several times above that
// (PERF.md, kernel_ab.py encoder).
//
// bf16 (swin_block_mma_kernel): every product on the tensor cores.
// A window (49 tokens, 64 rows of an m16 product) is one thread-block
// cluster of `cs` blocks (the host's plan: 1, 2 or 4, the smallest whose
// grid covers half the SMs; stage 3 of Swin-T at 16 images is 48 windows
// on clusters of 2, 96 blocks). Each block of the cluster owns nh / cs
// heads for qkv and attention, C / cs output columns of proj and fc2, and
// a share of every chunk of fc1's hidden columns. A block has 8 warps where
// two blocks fit an SM, else 16 (warp rows WR 2 or 4 by 4 columns). The
// products are mma_pass.cuh's (mma.sync m16n8k16, bf16 in, float32 sums in
// registers; weight k-tiles in a 3-tile shared-memory ring by cp.async, a
// pass's first tiles issued while the block still does its previous work:
// the next qkv product's or proj's during the qkv epilogue and attention,
// fc1's during the x1 exchange and LN2, fc2's during the GELU epilogue).
// Activations live in shared memory as bf16, rows padded by 16 bytes:
// LN1(x) (xn), the attention output (ao), the q, k, v of the block's heads,
// and two buffers of a hidden chunk. Attention is window_attend.cuh's on
// the tensor cores, B2's, a warp a (head, 16 query rows), with the relative
// bias (the block's heads' table columns staged in shared memory) and the
// shift mask added to the float32 logits: keys past the window's 49 tokens
// (the product's padding to 64) get -inf, while a padded token of the map
// (outside H x W) is a real key with k = b_k and v = b_v. Rows are
// exchanged through distributed shared memory, each block copying what it
// made into every other block of the cluster by 16-byte stores, then one
// cluster barrier: the heads' outputs (before proj), x1's column slices
// (before LN2, which every block then takes on all 64 rows), and each
// hidden chunk's GELU columns (before its fc2). fc2 sums over the hidden
// chunks in registers and is written once, with the residual, for the
// window's real tokens. GELU is x / (1 + exp(-2u)), tanh's form rewritten.
// Shared memory is two (64, C + 8) bf16 buffers, the larger of the heads'
// qkv and the two hidden chunks, and the ring: 93 KB a block at stage 1,
// 169 KB at stage 2, 218 KB at stage 3 (two blocks a window).
//
// float32 (swin_block_kernel): the CUDA-core version (no TF32), one block
// per (image, window), every intermediate float32 in shared memory; the
// products read 16-byte weight vectors from device memory and give each
// thread a 4-row by 4-column tile; the qkv of G heads and the MLP in
// chunks of hc hidden columns bound the scratch.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_pass.cuh"
#include "window_attend.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kRefused = -1;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// The same function as x * sigmoid(2 u) = x / (1 + exp(-2 u)), u the tanh
// argument: one exponential and one division in place of tanhf, to within
// a few float32 ulps (the bf16 kernel's MLP epilogue).
__device__ __forceinline__ float gelu_tanh_fast(float x) {
  const float k2 = -1.5957691216057308f;  // -2 sqrt(2 / pi)
  return x / (1.0f + __expf(k2 * (x + 0.044715f * x * x * x)));
}

// ---------------------------------------------------------------- bf16 --

constexpr int kRows = 64;   // a window's tokens, padded to m16 tiles
constexpr int kStages = 3;  // tiles of the weight ring

struct BlockArgs {
  const bf16* x;
  const float *g1, *be1;
  const bf16* w_qkv;
  const float *b_qkv, *table;
  const bf16* w_o;
  const float *b_o, *g2, *be2;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  bf16* out;
  int H, W, C, nh, hid, ws, shift_h, shift_w;
  int cs;   // blocks of a cluster (one window)
  int hg;   // heads of a qkv product
  int hcc;  // hidden columns of an MLP chunk, over the cluster
};

// Byte offsets of a block's shared memory (the wrapper's smem_plan sums
// the same sizes).
struct Layout {
  int lc, lq, lh;  // row strides (elements) of xn/ao, the heads' qkv, a chunk
  int lr;          // row stride of the weight ring: the widest pass + 8
  size_t xn, ao, scr, ring, ints, tab, end;
  __host__ __device__ Layout(int C, int dh, int hg, int hcc, int cs,
                             int ws) {
    const int hpb = C / dh / cs;
    const int widest = 3 * hg * dh > C / cs ? 3 * hg * dh : C / cs;
    lr = (widest > hcc / cs ? widest : hcc / cs) + 8;
    lc = C + 8;
    lq = 3 * hpb * dh + 8;
    lh = hcc + 8;
    const size_t c_buf = sizeof(bf16) * kRows * lc;
    const size_t qkv = sizeof(bf16) * kRows * lq;
    const size_t hid = 2 * sizeof(bf16) * kRows * lh;
    xn = 0;
    ao = xn + c_buf;
    scr = ao + c_buf;
    ring = scr + (qkv > hid ? qkv : hid);
    ints = ring + sizeof(bf16) * kStages * mp::kKt * lr;
    tab = ints + 3 * sizeof(int) * kRows;
    end = tab + sizeof(float) * (2 * ws - 1) * (2 * ws - 1) * hpb;
  }
};

// WR warp rows (4 WR warps a block): 2 where two blocks fit an SM, else 4.
template <int DH, int NT, int WR>
__global__ void __launch_bounds__(mp::kThreads<WR>,
                                  WR == 2 && NT == 4 ? 2 : 1)
swin_block_mma_kernel(const BlockArgs a) {
  constexpr int kMT = kRows / (16 * WR);  // m16 tiles a warp
  constexpr int kMmaThreads = mp::kThreads<WR>;
  constexpr int kMmaWarps = kMmaThreads / 32;
  constexpr int NC = mp::kCopies<NT, WR>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, ws = a.ws, N = ws * ws, cs = a.cs, hg = a.hg;
  const int rank = static_cast<int>(cluster.block_rank());
  const int hpb = a.nh / cs, Cb = C / cs, hcb = a.hcc / cs;
  const int T2 = (2 * ws - 1) * (2 * ws - 1);
  const Layout lay(C, DH, hg, a.hcc, cs, ws);
  const int lc = lay.lc, lq = lay.lq, lh = lay.lh;
  bf16* xn = reinterpret_cast<bf16*>(smem + lay.xn);  // LN1, then x1
  bf16* ao = reinterpret_cast<bf16*>(smem + lay.ao);  // attention, then LN2
  bf16* scr = reinterpret_cast<bf16*>(smem + lay.scr);  // qkv, or 2 chunks
  const mp::Ring<kStages> ring{reinterpret_cast<bf16*>(smem + lay.ring),
                               lay.lr};
  int* src_of = reinterpret_cast<int*>(smem + lay.ints);  // index in x, or -1
  int* tr = src_of + kRows;      // (i / ws) * (2 ws - 1) + i % ws
  int* region = tr + kRows;      // shift-mask region
  float* tab = reinterpret_cast<float*>(smem + lay.tab);  // [head][rel]

  const int H = a.H, W = a.W;
  const int Hp = (H + ws - 1) / ws * ws, Wp = (W + ws - 1) / ws * ws;
  const int nWw = Wp / ws, nW = (Hp / ws) * nWw;
  const int window = blockIdx.x / cs;
  const int b = window / nW, win = window % nW;
  const bf16* xb = a.x + static_cast<size_t>(b) * H * W * C;
  bf16* ob = a.out + static_cast<size_t>(b) * H * W * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const auto qkv_pass = [&](int g0) {  // q, k, v of heads g0 .. g0 + hg
    return mp::Pass{a.w_qkv, 3 * C, (rank * hpb + g0) * DH, hg * DH, C, C,
                    3 * hg * DH};
  };
  const mp::Pass proj{a.w_o, C, rank * Cb, Cb, 0, C, Cb};
  const auto fc1_pass = [&](int c) {
    return mp::Pass{a.w1, a.hid, c * a.hcc + rank * hcb, hcb, 0, C, hcb};
  };
  const auto fc2_pass = [&](int c) {
    return mp::Pass{a.w2 + static_cast<size_t>(c) * a.hcc * C, C, rank * Cb,
                    Cb, 0, a.hcc, Cb};
  };
  // copies this block's columns [col0, col0 + ncols) of the 64 rows of
  // `buf` (ld elements a row, written by this block) to the same place in
  // every other block of the cluster through distributed shared memory,
  // 16 bytes a store; a cluster barrier follows each call
  const auto share = [&](bf16* buf, int ld, int col0, int ncols) {
    if (cs == 1) return;
    __syncthreads();
    const int vr = ncols / 8;
    for (int e = threadIdx.x; e < kRows * vr; e += kMmaThreads) {
      const int at = (e / vr) * ld + col0 + 8 * (e % vr);
      const uint4 v = *reinterpret_cast<const uint4*>(buf + at);
      for (int d = 1; d < cs; ++d)
        *reinterpret_cast<uint4*>(
            cluster.map_shared_rank(buf, (rank + d) % cs) + at) = v;
    }
  };

  for (int i = threadIdx.x; i < kRows; i += kMmaThreads) {
    int src = -1, reg = 0, t = 0;
    if (i < N) {
      // (r, c) in the padded map rolled by -shift; (oh, ow) before the roll
      const int r = (win / nWw) * ws + i / ws, c = (win % nWw) * ws + i % ws;
      const int oh = (r + a.shift_h) % Hp, ow = (c + a.shift_w) % Wp;
      src = (oh < H && ow < W) ? oh * W + ow : -1;
      const int rh = r < Hp - ws ? 0 : (r < Hp - a.shift_h ? 1 : 2);
      const int rw = c < Wp - ws ? 0 : (c < Wp - a.shift_w ? 1 : 2);
      reg = rh * 3 + rw;
      t = (i / ws) * (2 * ws - 1) + i % ws;
    }
    src_of[i] = src;
    region[i] = reg;
    tr[i] = t;
  }
  for (int i = threadIdx.x; i < T2 * hpb; i += kMmaThreads)
    tab[i] = a.table[(i % T2) * a.nh + rank * hpb + i / T2];
  __syncthreads();

  // the window's rows of x into xn (padded tokens and rows past N zero),
  // all in flight at once, then the first qkv product's first tiles
  const int cv = C / 8;  // 16-byte vectors a row
  for (int e = threadIdx.x; e < kRows * cv; e += kMmaThreads) {
    const int i = e / cv, v = e - i * cv;
    const int s = src_of[i];
    bf16* to = xn + i * lc + 8 * v;
    if (s < 0)
      *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
    else
      cp_async16(to, xb + static_cast<size_t>(s) * C + 8 * v);
  }
  cp_async_commit();
  mp::Stream<NC> next = mp::begin<NC, WR>(ring, qkv_pass(0));
  cp_async_wait<kStages - 1>();  // x's rows (the oldest group)
  __syncthreads();
  for (int i = warp; i < kRows; i += kMmaWarps)
    if (src_of[i] >= 0) mp::ln_row(xn + i * lc, xn + i * lc, C, a.g1, a.be1);
  cluster.sync();  // xn complete; every block of the cluster is running

  // q, k and v of the block's heads, hg heads a product, into scr (all
  // q, then all k, then all v)
  float acc[kMT][NT][4];
  for (int g0 = 0; g0 < hpb; g0 += hg) {
    const int n = 3 * hg * DH;
    mp::zero(acc);
    mp::run<WR>(ring, next, n, xn, lc, acc);
    next = mp::begin<NC, WR>(ring, g0 + hg < hpb ? qkv_pass(g0 + hg) : proj);
    mp::for_pairs<WR>(n, acc, [&](int r, int c, float v0, float v1) {
      const int part = c / (hg * DH), at = g0 * DH + c - part * hg * DH;
      const int col = part * C + rank * hpb * DH + at;
      *reinterpret_cast<uint32_t*>(scr + r * lq + part * hpb * DH + at) =
          tc::pack_bf16(v0 + __ldg(a.b_qkv + col),
                        v1 + __ldg(a.b_qkv + col + 1));
    });
  }
  __syncthreads();

  // attention, a warp a (head, 16 query rows); the heads' outputs into
  // every block's ao
  const bool shifted = a.shift_h > 0 || a.shift_w > 0;
  const int rel0 = (ws - 1) * (2 * ws - 1) + ws - 1;
  for (int item = warp; item < 4 * hpb; item += kMmaWarps) {
    const int g = item >> 2, m16 = item & 3;
    const float* tb = tab + g * T2 + rel0;
    float o[DH / 8][4], inv0, inv1;
    wattn::attend_rows<DH>(
        scr + g * DH, scr + (hpb + g) * DH, scr + (2 * hpb + g) * DH, lq, N,
        m16,
        [&](int, int, int row, int col) {
          if (row >= N) return 0.0f;
          const float v = tb[tr[row] - tr[col]];
          return shifted && region[row] != region[col] ? v - 100.0f : v;
        },
        o, inv0, inv1);
    const int row0 = m16 * 16 + (lane >> 2);
    const int c0 = (rank * hpb + g) * DH + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(ao + row0 * lc + c0 + 8 * j) =
          tc::pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
      *reinterpret_cast<uint32_t*>(ao + (row0 + 8) * lc + c0 + 8 * j) =
          tc::pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
  }
  share(ao, lc, rank * hpb * DH, hpb * DH);
  cluster.sync();  // ao complete in every block

  // proj + residual: the block's columns of x1 into every block's xn (LN1's
  // output is read no more: every block passed its qkv products). The
  // residual's x pairs are loaded first, all in flight together.
  mp::zero(acc);
  mp::run<WR>(ring, next, Cb, ao, lc, acc);
  next = mp::begin<NC, WR>(ring, fc1_pass(0));
  {
    uint32_t xr[kMT][NT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = src_of[mp::pair_row<WR, kMT>(i, h)];
          xr[i][j][h] = 0;
          if (j < Cb / 32 && s >= 0)
            xr[i][j][h] = __ldg(reinterpret_cast<const unsigned int*>(
                xb + static_cast<size_t>(s) * C + rank * Cb +
                mp::pair_col<WR>(Cb, j)));
        }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (j < Cb / 32) {
            const int row = mp::pair_row<WR, kMT>(i, h);
            const int col = rank * Cb + mp::pair_col<WR>(Cb, j);
            __nv_bfloat162 x2;
            *reinterpret_cast<uint32_t*>(&x2) = xr[i][j][h];
            const float2 xv = __bfloat1622float2(x2);
            *reinterpret_cast<uint32_t*>(xn + row * lc + col) =
                tc::pack_bf16(xv.x + round_to<bf16>(acc[i][j][2 * h] +
                                                    __ldg(a.b_o + col)),
                              xv.y + round_to<bf16>(acc[i][j][2 * h + 1] +
                                                    __ldg(a.b_o + col + 1)));
          }
  }
  share(xn, lc, rank * Cb, Cb);
  cluster.sync();  // x1 complete in every block

  // LN2 of every row into ao (this block's proj read it before the barrier)
  for (int i = warp; i < kRows; i += kMmaWarps)
    mp::ln_row(xn + i * lc, ao + i * lc, C, a.g2, a.be2);

  // MLP in chunks of hcc hidden columns: the block's share of fc1 into
  // every block's chunk buffer, then fc2 of the block's columns over the
  // whole chunk, summed in registers over the chunks
  float acc2[kMT][NT][4];
  mp::zero(acc2);
  const int chunks = a.hid / a.hcc;
  for (int c = 0; c < chunks; ++c) {
    bf16* hb = scr + (c & 1) * kRows * lh;
    float acc1[kMT][4][4];  // hcb <= 128: fewer registers beside acc2's
    mp::zero(acc1);
    mp::run<WR>(ring, next, hcb, ao, lc, acc1);
    next = mp::begin<NC, WR>(ring, fc2_pass(c));
    const int col0 = c * a.hcc + rank * hcb;
    mp::for_pairs<WR>(hcb, acc1, [&](int r, int n, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(hb + r * lh + rank * hcb + n) =
          tc::pack_bf16(gelu_tanh_fast(v0 + __ldg(a.b1 + col0 + n)),
                        gelu_tanh_fast(v1 + __ldg(a.b1 + col0 + n + 1)));
    });
    share(hb, lh, rank * hcb, hcb);
    cluster.sync();  // chunk c complete in every block
    mp::run<WR>(ring, next, Cb, hb, lh, acc2);
    if (c + 1 < chunks) next = mp::begin<NC, WR>(ring, fc1_pass(c + 1));
  }

  // out = x1 + round(fc2 + b2) on the real tokens, the block's columns
  mp::for_pairs<WR>(Cb, acc2, [&](int r, int n, float v0, float v1) {
    const int s = src_of[r];
    if (s < 0) return;
    const int col = rank * Cb + n;
    const float2 x1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(xn + r * lc + col));
    *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(s) * C + col) =
        tc::pack_bf16(x1.x + round_to<bf16>(v0 + __ldg(a.b2 + col)),
                      x1.y + round_to<bf16>(v1 + __ldg(a.b2 + col + 1)));
  });
}

// The launch configuration of the bf16 kernel and the clusters of it that
// fit on the card at once.
template <int DH, int NT, int WR>
cudaError_t configure_mma(const BlockArgs& a, int B, int smem,
                          cudaStream_t st, cudaLaunchConfig_t& cfg,
                          cudaLaunchAttribute& attr, int* active) {
  const void* kernel =
      reinterpret_cast<const void*>(swin_block_mma_kernel<DH, NT, WR>);
  cudaError_t err = allow_smem(swin_block_mma_kernel<DH, NT, WR>, smem);
  if (err != cudaSuccess) return err;
  const int windows =
      ((a.H + a.ws - 1) / a.ws) * ((a.W + a.ws - 1) / a.ws);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(B * windows * a.cs));
  cfg.blockDim = dim3(mp::kThreads<WR>);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(a.cs);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return active_clusters(kernel, cfg, active);
}

template <int DH, int NT, int WR>
int launch_mma(const BlockArgs& a, int B, int smem, cudaStream_t st,
               int* active_out) {
  const Layout lay(a.C, DH, a.hg, a.hcc, a.cs, a.ws);
  if (lay.end > static_cast<size_t>(smem)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t err =
      configure_mma<DH, NT, WR>(a, B, smem, st, cfg, attr, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active_out != nullptr) {
    *active_out = active;
    return 0;
  }
  if (active < 1) return kRefused;  // no cluster of this shape fits
  err = cudaLaunchKernelEx(&cfg, swin_block_mma_kernel<DH, NT, WR>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// launch_mma for the head dim, n8 tiles a warp and warp rows (dh 16, 32 or
// 64; nt 4 with wr 2 or 4, or nt 8 with wr 4); with active_out set, only
// the clusters that fit, no launch
int dispatch_mma(const BlockArgs& a, int B, int nt, int wr, int smem,
                 cudaStream_t st, int* active_out) {
  if (a.nh < 1 || a.cs < 1 || a.hg < 1 || a.hcc < 1 || a.C % a.nh ||
      a.nh % a.cs || (a.nh / a.cs) % a.hg || a.ws * a.ws > kRows ||
      a.hid % a.hcc || a.hcc % (32 * a.cs))
    return cudaErrorInvalidValue;
  const int dh = a.C / a.nh, cb = a.C / a.cs;
  if (cb % 32 || cb > 32 * nt || 3 * a.hg * dh > 32 * nt ||
      a.hcc / a.cs > 128)
    return cudaErrorInvalidValue;
#define SWIN_MMA_CASE(D, T, R)                                 \
  if (dh == D && nt == T && wr == R)                           \
    return launch_mma<D, T, R>(a, B, smem, st, active_out);
  SWIN_MMA_CASE(16, 4, 2)
  SWIN_MMA_CASE(16, 4, 4)
  SWIN_MMA_CASE(16, 8, 4)
  SWIN_MMA_CASE(32, 4, 2)
  SWIN_MMA_CASE(32, 4, 4)
  SWIN_MMA_CASE(32, 8, 4)
  SWIN_MMA_CASE(64, 4, 2)
  SWIN_MMA_CASE(64, 4, 4)
  SWIN_MMA_CASE(64, 8, 4)
#undef SWIN_MMA_CASE
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------- float32 --

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 4;  // rows of the left operand in a thread's tile

// epi(m, n, sum_k A[m, k] W[k, col(n)]) for m < M, n < N. A: M x K floats
// in shared memory, row stride lda; lda and K multiples of 4. W: rows of
// ldw floats in device memory. col(n) = base + (n / seg) * seg_stride +
// n % seg: one run of columns, or the q, k and v runs of a head group.
template <typename Epi>
__device__ void mm(const float* A, int lda, int M, int K,
                   const float* __restrict__ W, int ldw, int base, int seg,
                   int seg_stride, int N, Epi epi) {
  constexpr int V = 4;
  const int ncv = N / V;
  const int nrg = (M + kTileRows - 1) / kTileRows;
  for (int item = threadIdx.x; item < ncv * nrg; item += kThreads) {
    const int cv = item % ncv, rg = item / ncv;
    const int n0 = cv * V, m0 = rg * kTileRows;
    const float* w = W + base + (n0 / seg) * seg_stride + n0 % seg;
    const float* a[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) a[r] = A + min(m0 + r, M - 1) * lda;
    float acc[kTileRows][V];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[r][j] = 0.0f;
    for (int k = 0; k < K; k += 4) {
      float wv[4][V];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        load_vec(w + static_cast<size_t>(k + kk) * ldw, wv[kk]);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
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
    for (int r = 0; r < kTileRows; ++r)
      if (m0 + r < M)
#pragma unroll
        for (int j = 0; j < V; ++j) epi(m0 + r, n0 + j, acc[r][j]);
  }
}

// dst[i] = LN(src[i]) * g + b for the real tokens of the window
// (src_of[i] >= 0), zeros for the padded ones; one warp per token.
template <typename Load>
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
      row[c] = (row[c] - mean) * inv * g[c] + b[c];
  }
}

__global__ void __launch_bounds__(kThreads)
swin_block_kernel(const float* __restrict__ x, const float* __restrict__ g1,
                  const float* __restrict__ be1,
                  const float* __restrict__ w_qkv,
                  const float* __restrict__ b_qkv,
                  const float* __restrict__ table,
                  const float* __restrict__ w_o,
                  const float* __restrict__ b_o, const float* __restrict__ g2,
                  const float* __restrict__ be2, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out,
                  int H, int W, int C, int nh, int hid, int ws, int shift_h,
                  int shift_w, int G, int hc) {
  extern __shared__ float fsmem[];
  const int N = ws * ws;
  const int dh = C / nh;
  const int Hp = (H + ws - 1) / ws * ws, Wp = (W + ws - 1) / ws * ws;
  const int nWw = Wp / ws, nW = (Hp / ws) * nWw;
  const int b = blockIdx.x / nW, win = blockIdx.x % nW;
  const int gq = G * dh;         // columns of q (or k, or v) of a head group
  const int ldq = 3 * gq + 1;    // +1: neighbouring keys in other banks
  int* src_of = reinterpret_cast<int*>(fsmem);  // token -> index in x, or -1
  int* region = src_of + N;                     // shift-mask region
  float* bufA = fsmem + ((2 * N + 3) & ~3);     // N x C
  float* bufB = bufA + N * C;                  // N x C
  float* scr = bufB + N * C;                   // qkv of a head group, or
  float* logits = scr + N * ldq;               // N x N; or an MLP chunk
  const float* xb = x + static_cast<size_t>(b) * H * W * C;
  float* ob = out + static_cast<size_t>(b) * H * W * C;

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
  token_layer_norm(
      [&](int i, int c) { return xb[static_cast<size_t>(src_of[i]) * C + c]; },
      src_of, N, C, g1, be1, bufA);
  __syncthreads();

  // windowed attention, G heads at a time; output into bufB
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  const bool shifted = shift_h > 0 || shift_w > 0;
  const int span = 2 * ws - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h0 = 0; h0 < nh; h0 += G) {
    mm(bufA, C, N, C, w_qkv, 3 * C, h0 * dh, gq, C, 3 * gq,
       [&](int m, int n, float acc) {
         const int part = n / gq;
         const int col = part * C + h0 * dh + n - part * gq;
         const float v = acc + b_qkv[col];
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
        bufB[i * C + h * dh + d] = acc;
      }
      __syncthreads();
    }
  }

  // proj + residual: x1 into bufA and, for the real tokens, into out
  mm(bufB, C, N, C, w_o, C, 0, C, 0, C, [&](int m, int n, float acc) {
    const int s = src_of[m];
    if (s < 0) return;
    const size_t at = static_cast<size_t>(s) * C + n;
    const float x1 = xb[at] + (acc + b_o[n]);
    ob[at] = x1;
    bufA[m * C + n] = x1;
  });
  __syncthreads();

  // LN2 into bufB; bufA becomes the fc2 accumulator
  token_layer_norm([&](int i, int c) { return bufA[i * C + c]; }, src_of, N,
                   C, g2, be2, bufB);
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) bufA[idx] = 0.0f;
  __syncthreads();

  // MLP in chunks of hc hidden columns
  for (int c0 = 0; c0 < hid; c0 += hc) {
    mm(bufB, C, N, C, w1, hid, c0, hc, 0, hc, [&](int m, int n, float acc) {
      scr[m * hc + n] = gelu_tanh(acc + b1[c0 + n]);
    });
    __syncthreads();
    mm(scr, hc, N, hc, w2 + static_cast<size_t>(c0) * C, C, 0, C, 0, C,
       [&](int m, int n, float acc) { bufA[m * C + n] += acc; });
    __syncthreads();
  }

  // out = x1 + (fc2 + b2) on the real tokens
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) {
    const int m = idx / C, n = idx - m * C;
    const int s = src_of[m];
    if (s < 0) continue;
    float* o = ob + static_cast<size_t>(s) * C + n;
    *o += bufA[idx] + b2[n];
  }
}

}  // namespace

// bf16: x, norm1 (2), w_qkv, b_qkv, table, w_out, b_out, norm2 (2), fc1
// (2), fc2 (2), out, B, H, W, C, heads, hidden, ws, shift_h, shift_w, the
// wrapper's plan (blocks a cluster, n8 tiles a warp, warp rows, heads a qkv
// product, hidden columns a chunk, shared memory bytes), stream. Returns 0, a
// cudaError, or kRefused (-1) where no cluster of the plan fits on the
// card.
extern "C" int swin_block_bf16(
    const void* x, const void* g1, const void* be1, const void* w_qkv,
    const void* b_qkv, const void* table, const void* w_o, const void* b_o,
    const void* g2, const void* be2, const void* w1, const void* b1,
    const void* w2, const void* b2, void* out, int B, int H, int W, int C,
    int nh, int hid, int ws, int shift_h, int shift_w, int cs, int nt,
    int wr, int hg, int hcc, int smem, void* stream) {
  using CB = const bf16*;
  using CF = const float*;
  const BlockArgs a{static_cast<CB>(x),     static_cast<CF>(g1),
                    static_cast<CF>(be1),   static_cast<CB>(w_qkv),
                    static_cast<CF>(b_qkv), static_cast<CF>(table),
                    static_cast<CB>(w_o),   static_cast<CF>(b_o),
                    static_cast<CF>(g2),    static_cast<CF>(be2),
                    static_cast<CB>(w1),    static_cast<CF>(b1),
                    static_cast<CB>(w2),    static_cast<CF>(b2),
                    static_cast<bf16*>(out), H, W, C, nh, hid, ws, shift_h,
                    shift_w, cs, hg, hcc};
  return dispatch_mma(a, B, nt, wr, smem, static_cast<cudaStream_t>(stream),
                      nullptr);
}

// The clusters of the bf16 kernel's plan that fit on the card at once, in
// *out (H, W and the pointers play no part).
extern "C" int swin_block_active_clusters(int C, int nh, int hid, int ws,
                                          int cs, int nt, int wr, int hg,
                                          int hcc, int smem, int* out) {
  BlockArgs a{};
  a.H = a.W = ws;
  a.C = C;
  a.nh = nh;
  a.hid = hid;
  a.ws = ws;
  a.cs = cs;
  a.hg = hg;
  a.hcc = hcc;
  *out = 0;
  return dispatch_mma(a, 1, nt, wr, smem, nullptr, out);
}

// float32: the same operands, then B, H, W, C, heads, hidden, ws, shift_h,
// shift_w, heads a qkv group, hidden columns a chunk, shared memory bytes,
// stream.
extern "C" int swin_block_f32(const void* x, const void* g1, const void* be1,
                              const void* w_qkv, const void* b_qkv,
                              const void* table, const void* w_o,
                              const void* b_o, const void* g2,
                              const void* be2, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out,
                              int B, int H, int W, int C, int nh, int hid,
                              int ws, int shift_h, int shift_w, int G, int hc,
                              int smem, void* stream) {
  cudaError_t err = allow_smem(swin_block_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = ((H + ws - 1) / ws) * ((W + ws - 1) / ws);
  using CF = const float*;
  swin_block_kernel<<<B * windows, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<CF>(x), static_cast<CF>(g1), static_cast<CF>(be1),
      static_cast<CF>(w_qkv), static_cast<CF>(b_qkv), static_cast<CF>(table),
      static_cast<CF>(w_o), static_cast<CF>(b_o), static_cast<CF>(g2),
      static_cast<CF>(be2), static_cast<CF>(w1), static_cast<CF>(b1),
      static_cast<CF>(w2), static_cast<CF>(b2), static_cast<float*>(out), H,
      W, C, nh, hid, ws, shift_h, shift_w, G, hc);
  return static_cast<int>(cudaGetLastError());
}
