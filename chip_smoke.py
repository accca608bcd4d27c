#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printed on its own lines:

1. the device (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of the CUDA kernels in ``handwritten_math_ocr_api_torch/csrc``
   with ``nvcc``, and its seconds;
3. each of the eight kernels against its plain PyTorch version on the
   card, in bf16, at the shapes the served paths give it (a 10-image
   request padded to the 16-row batch bucket; beam search at beam 5 on the
   10 images, 50 rows): window attention, patch merging, cache-append
   attention and decode attention at every stage or slot they serve; the
   fused decoder step at pos 0, 74 and 149; the whole Swin block at stages
   1-3, unshifted and shifted; the ragged step at pos 0, 74, 149 and a
   ragged position vector, in both head modes (and in float32, where its
   argmax must be equal); the beam cache reorder over the whole cache and
   a prefix (exactly equal). Each with its time, the plain version's time,
   the time of one PyTorch library call computing the same function where
   there is one (else null), and the least time the card could take (its
   bound, and whether bytes or operations set it);
4. served decoding at full width and depth on both routes of the engine:
   the ``serving_model_r4`` configuration (Swin-T, d_model 256, 8 decoder
   layers, vocab 138; its ``model_config.json`` and ``vocab.json``) with
   seeded random weights (nonzero biases and norms). The routes are
   ``DecodeEngine()`` (the JAX ``use_pallas=True`` configuration) and
   ``DecodeEngine(use_fused=True, pallas_encoder_block=True)``. On each,
   greedy: ``predict_batch`` on 10 seeded images and ``predict_single`` on
   one; then beam search: ``predict_batch`` of the 10 images with
   ``beam_size=5``. Each path with every kernel's launch count set to 0
   before and checked against the route's shape after; the encoder memory
   and the tokens against the route's plain path on the card (bf16, and
   float32 where tokens must be equal; the fused beam's float32 tokens also
   equal to the default beam's); images per second and the device's idle
   share;
5. a ``kernels`` JSON line, the ``nvidia-smi`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

It imports torch, numpy and the port only, reads no checkpoint and no image
file, and exits non-zero on any failure, or when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
DEVICE = "cuda"
MODEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "serving_model_r4")  # its JSON files only
N_IMAGES = 10
BEAM = 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor rate
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# kernel vs plain, both bf16 on the card: the two differ in float32
# summation order and so by one or two bf16 roundings of the output
# (2^-8 relative each)
KERNEL_ATOL = 2e-2
KERNEL_RTOL = 2e-2
# encoder memory, kernel path vs plain path on the card. bf16: each of the
# 15 kernel launches may round its outputs one bf16 step (2^-8 relative)
# away from the plain version, and 12 blocks carry that on; the bound is 5%
# of the largest |value| (the first run on an H100 measured 0.9%).
# float32: summation order only.
MEMORY_BF16_REL = 0.05
MEMORY_F32_ATOL = 1e-3
# fused decoder step, kernel vs plain in bf16: 8 layers of matmul inputs
# rounded to bf16, any of which may round one step (2^-8 relative) apart
# when the float32 sums before it differ in order; runs on an H100
# measured up to 0.018 on LayerNorm outputs of order 1
STEP_ATOL = 5e-2
STEP_RTOL = 2e-2
# the decoder steps in float32, kernel vs plain: summation order only,
# through 8 layers of LayerNorm
F32_STEP_ATOL = 1e-3


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ops_s(flops: float, f32_flops: float = 0.0) -> float:
    """Seconds of the operations at the peak rate of their type: bf16
    products on the tensor cores, float32 ones outside them."""
    return flops / BF16_FLOPS_PER_S + f32_flops / F32_FLOPS_PER_S


def bound_ms(nbytes: float, flops: float, f32_flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops_s(flops, f32_flops)) * 1e3


def bound_by(nbytes: float, flops: float, f32_flops: float = 0.0) -> str:
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops_s(flops, f32_flops)
            else "operations")


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def assert_close(name, got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
    import torch

    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if bool((diff > limit).any()):
        raise AssertionError(
            f"{name}: max abs err {diff.max().item():.3g} beyond "
            f"atol {atol} + rtol {rtol}")


class Entry:
    """One kernel's line of the ``kernels`` JSON, summed over the launches
    of one pass of the served path (an encode, or a decode step).
    ``launches`` sums the counted runs of both routes; ``launches_by_route``
    gives each."""

    def __init__(self, name, source, replaces, unit):
        self.d = {"name": name, "route": "cuda", "source": source,
                  "replaces": replaces, "launches": 0,
                  "launches_by_route": {}, "max_abs_err": 0.0,
                  "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bound_by": "bytes", "library_ms": None, "unit": unit}
        self.nbytes = 0.0
        self.flops = 0.0
        self.f32_flops = 0.0

    def add(self, times: int, err, ms, plain, lib, nbytes, flops,
            f32_flops=0.0):
        d = self.d
        d["max_abs_err"] = max(d["max_abs_err"], err)
        d["ms"] += times * ms
        d["plain_ms"] += times * plain
        if lib is not None:
            d["library_ms"] = (d["library_ms"] or 0.0) + times * lib
        self.nbytes += times * nbytes
        self.flops += times * flops
        self.f32_flops += times * f32_flops
        d["bound_ms"] = bound_ms(self.nbytes, self.flops, self.f32_flops)
        d["bound_by"] = bound_by(self.nbytes, self.flops, self.f32_flops)


def stage_shapes(cfg, batch):
    """Per Swin stage: (H, W, C, heads, depth, padded H, padded W)."""
    sc = cfg.swin
    ws = sc.window_size
    h, w = cfg.img_h // sc.patch_size, cfg.img_w // sc.patch_size
    out = []
    for i, depth in enumerate(sc.depths):
        c = sc.embed_dim * 2 ** i
        ph, pw = -(-h // ws) * ws, -(-w // ws) * ws
        out.append((h, w, c, sc.num_heads[i], depth, ph, pw))
        h, w = h // 2, w // 2
    return out


def check_kernels(cfg, params, batch):
    """Phase 3: every kernel against its plain version at the served
    shapes. Returns the kernels' JSON entries."""
    import torch
    import torch.nn.functional as F

    from handwritten_math_ocr_api_torch.models import swin
    from handwritten_math_ocr_api_torch.ops import cache_attention as ca
    from handwritten_math_ocr_api_torch.ops import patch_merging as pm
    from handwritten_math_ocr_api_torch.ops import window_attention as wa

    dev = torch.device(DEVICE)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    ws = cfg.swin.window_size
    N = ws * ws
    win = Entry("window_attention", "handwritten_math_ocr_api_torch/csrc/"
                "window_attention.cu",
                "handwritten_math_ocr_api_tpu/ops/window_attention.py:52",
                f"one encode: {sum(cfg.swin.depths)} launches at "
                f"{len(cfg.swin.depths)} stage shapes")
    merge = Entry("patch_merging", "handwritten_math_ocr_api_torch/csrc/"
                  "patch_merging.cu",
                  "handwritten_math_ocr_api_tpu/ops/patch_merging.py:41",
                  f"one encode: {len(cfg.swin.depths) - 1} launches")
    cache = Entry("cache_append_attention", "handwritten_math_ocr_api_torch/"
                  "csrc/cache_attention.cu",
                  "handwritten_math_ocr_api_tpu/ops/cache_attention.py:56",
                  "one launch at the last slot (pos = T - 1)")
    decode = Entry("decode_attention", "handwritten_math_ocr_api_torch/"
                   "csrc/cache_attention.cu",
                   "handwritten_math_ocr_api_tpu/ops/decode_attention.py:45",
                   "one launch at the last slot (pos = T - 1), at the cache "
                   "attention's shapes (no served path calls it)")

    for i, (h, w, c, nh, depth, ph, pw) in enumerate(stage_shapes(cfg, batch)):
        dh = c // nh
        nW = (ph // ws) * (pw // ws)
        p_attn = params["encoder"]["stages"][i]["blocks"][-1]["attn"]
        shift_h = 0 if ws >= ph else ws // 2
        shift_w = 0 if ws >= pw else ws // 2
        mask = swin.attention_mask(p_attn, ws, nh, ph, pw, shift_h, shift_w)
        mask = mask.expand(nW, nh, N, N).contiguous()
        q, k, v = (randn(batch, nW, nh, N, dh) for _ in range(3))
        got = wa.window_attention_core(q, k, v, mask)
        want = wa.window_attention_core_plain(q, k, v, mask)
        torch.cuda.synchronize()
        assert_close(f"window_attention stage {i + 1}", got, want)
        ms = cuda_ms(lambda: wa.window_attention_core(q, k, v, mask))
        plain = cuda_ms(lambda: wa.window_attention_core_plain(q, k, v, mask))
        q4, k4, v4 = (t.reshape(batch, nW * nh, N, dh) for t in (q, k, v))
        m4 = mask.reshape(1, nW * nh, N, N).to(bf16)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4))
        G = batch * nW * nh
        nbytes = 4 * G * N * dh * 2 + nW * nh * N * N * 4
        flops = 4 * G * N * N * dh
        win.add(depth, max_err(got, want), ms, plain, lib, nbytes, flops)
        log(f"kernel window_attention stage {i + 1}: q {tuple(q.shape)} "
            f"max_abs_err {max_err(got, want):.3g} ms {ms:.4f} "
            f"plain_ms {plain:.4f} sdpa_ms {lib:.4f} "
            f"bound_ms {bound_ms(nbytes, flops):.4f} x{depth}")

        if i == len(cfg.swin.depths) - 1:
            continue
        p_merge = params["encoder"]["merges"][i]
        x = randn(batch, h, w, c)
        got = pm.fused_patch_merging(p_merge, x)
        want = pm.patch_merging_plain(p_merge, x)
        torch.cuda.synchronize()
        assert_close(f"patch_merging {i + 1}", got, want)
        ms = cuda_ms(lambda: pm.fused_patch_merging(p_merge, x))
        plain = cuda_ms(lambda: pm.patch_merging_plain(p_merge, x))
        M = batch * (h // 2) * (w // 2)
        nbytes = (x.numel() * 2 + 8 * c * c * 2 + 2 * 4 * c * 4
                  + M * 2 * c * 2)
        flops = 2 * M * 4 * c * 2 * c
        merge.add(1, max_err(got, want), ms, plain, None, nbytes, flops)
        log(f"kernel patch_merging {i + 1}: x {tuple(x.shape)} "
            f"max_abs_err {max_err(got, want):.3g} ms {ms:.4f} "
            f"plain_ms {plain:.4f} bound_ms {bound_ms(nbytes, flops):.4f}")

    H, T, Dh = cfg.nhead, cfg.max_seq_len, cfg.head_dim
    k_cache, v_cache = randn(batch, H, T, Dh), randn(batch, H, T, Dh)
    err = err_dec = 0.0
    for pos in (0, T // 2, T - 1):
        q, kn, vn = (randn(batch, H, 1, Dh) for _ in range(3))
        k2, v2 = k_cache.clone(), v_cache.clone()
        got = ca.cache_append_attention(q, kn, vn, k_cache, v_cache, pos)
        want = ca.cache_append_attention_plain(q, kn, vn, k2, v2, pos)
        torch.cuda.synchronize()
        assert_close(f"cache_append_attention pos {pos}", got, want)
        if not (torch.equal(k_cache, k2) and torch.equal(v_cache, v2)):
            raise AssertionError("cache_append_attention: caches differ "
                                 f"from the plain update at pos {pos}")
        err = max(err, max_err(got, want))
        got = ca.decode_attention(q, k_cache, v_cache, pos)
        want = ca.decode_attention_plain(q, k_cache, v_cache, pos)
        torch.cuda.synchronize()
        assert_close(f"decode_attention pos {pos}", got, want)
        if not (torch.equal(k_cache, k2) and torch.equal(v_cache, v2)):
            raise AssertionError("decode_attention wrote to the caches")
        err_dec = max(err_dec, max_err(got, want))
    pos = T - 1
    ms = cuda_ms(lambda: ca.cache_append_attention(q, kn, vn, k_cache,
                                                   v_cache, pos))
    plain = cuda_ms(lambda: ca.cache_append_attention_plain(
        q, kn, vn, k_cache, v_cache, pos))
    kp, vp = k_cache[:, :, :pos + 1], v_cache[:, :, :pos + 1]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kp, vp))
    G = batch * H
    nbytes = 4 * G * Dh * 2 + 2 * G * pos * Dh * 2 + 2 * G * Dh * 2
    flops = 4 * G * (pos + 1) * Dh
    cache.add(1, err, ms, plain, lib, nbytes, flops)
    log(f"kernel cache_append_attention: caches {tuple(k_cache.shape)} "
        f"pos {pos} max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
        f"sdpa_ms {lib:.4f} (prefix attention, no append) "
        f"bound_ms {bound_ms(nbytes, flops):.4f}")

    ms = cuda_ms(lambda: ca.decode_attention(q, k_cache, v_cache, pos))
    plain = cuda_ms(lambda: ca.decode_attention_plain(q, k_cache, v_cache,
                                                      pos))
    nbytes = 2 * G * Dh * 2 + 2 * G * (pos + 1) * Dh * 2   # q, out, prefix
    decode.add(1, err_dec, ms, plain, lib, nbytes, flops)
    log(f"kernel decode_attention: caches {tuple(k_cache.shape)} pos {pos} "
        f"max_abs_err {err_dec:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
        f"sdpa_ms {lib:.4f} bound_ms {bound_ms(nbytes, flops):.4f}")
    return [win, merge, cache, decode]


def check_fused_step(cfg, np_params, batch):
    """Phase 3: the fused decoder step against its plain version at the
    served shapes, at the first, a middle and the last slot."""
    import torch

    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    entry = Entry("fused_decoder_step", "handwritten_math_ocr_api_torch/"
                  "csrc/fused_step.cu",
                  "handwritten_math_ocr_api_tpu/ops/fused_step.py:774",
                  "one launch (all decoder layers) at the last slot "
                  "(pos = T - 1)")
    stacked = fs.build_stacked(np_params["decoder"], cfg, dev)
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    F, L_enc = cfg.dim_feedforward, cfg.encoder_len
    sk, sv = randn(L, batch, T, D), randn(L, batch, T, D)
    ck, cv = randn(L, batch, L_enc, D), randn(L, batch, L_enc, D)
    x = randn(batch, D)
    err = 0.0
    for pos in (0, T // 2 - 1, T - 1):
        got = fs.fused_decoder_layers_step_v2(stacked, cfg, x, sk, sv, ck,
                                              cv, pos)
        want = fs.fused_decoder_layers_step_v2_plain(stacked, cfg, x, sk, sv,
                                                     ck, cv, pos)
        torch.cuda.synchronize()
        for name, g, w in zip(("x_out", "k_new", "v_new"), got, want):
            assert_close(f"fused_decoder_step pos {pos} {name}", g, w,
                         STEP_ATOL, STEP_RTOL)
            err = max(err, max_err(g, w))
        log(f"kernel fused_decoder_step pos {pos}: max_abs_err "
            f"{max(max_err(g, w) for g, w in zip(got, want)):.3g}")
    pos = T - 1
    ms = cuda_ms(lambda: fs.fused_decoder_layers_step_v2(
        stacked, cfg, x, sk, sv, ck, cv, pos))
    plain = cuda_ms(lambda: fs.fused_decoder_layers_step_v2_plain(
        stacked, cfg, x, sk, sv, ck, cv, pos))
    weights = L * (D * 3 * D + 3 * D * D + 2 * D * F)
    small = L * (3 * D + 3 * D + F + D + 6 * D)        # biases, LN (f32)
    nbytes = (weights * 2 + small * 4 + 2 * L * batch * L_enc * D * 2
              + 2 * L * batch * pos * D * 2 + batch * D * 2   # caches, x
              + batch * D * 4 + 2 * L * batch * D * 2)        # outputs
    flops = (2 * batch * weights
             + 4 * L * batch * D * (pos + 1 + L_enc))         # attention
    entry.add(1, err, ms, plain, None, nbytes, flops)
    log(f"kernel fused_decoder_step: caches {tuple(sk.shape)} pos {pos} "
        f"max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
        f"bound_ms {bound_ms(nbytes, flops):.4f} "
        f"({bound_by(nbytes, flops)}) library_ms null")
    return entry


def check_swin_block(cfg, np_params, params, batch):
    """Phase 3: the whole-block kernel against its plain version at every
    stage the route fuses, unshifted and shifted."""
    import torch

    from handwritten_math_ocr_api_torch.ops import swin_block as sb

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sc = cfg.swin
    ws = sc.window_size
    N = ws * ws
    entry = Entry("swin_block", "handwritten_math_ocr_api_torch/csrc/"
                  "swin_block.cu",
                  "handwritten_math_ocr_api_tpu/ops/swin_block.py:129",
                  f"one encode: {fused_blocks(cfg)} launches at the stage "
                  f"shapes that fuse")
    # the engine's bundle: the blocks' four biases in float32
    encoder = sb.with_float32_biases(np_params["encoder"], params["encoder"])
    for i, (h, w, c, nh, depth, ph, pw) in enumerate(stage_shapes(cfg,
                                                                  batch)):
        hid = int(c * sc.mlp_ratio)
        if not sb.fits_vmem(c, ws, pw, hid):
            continue
        p = encoder["stages"][i]["blocks"][-1]
        x = torch.randn(batch, h, w, c, generator=gen, device=dev).to(
            torch.bfloat16)
        err = 0.0
        for shift in (0, ws // 2):
            got = sb.fused_swin_block(p, x, ws, shift, nh)
            want = sb.fused_swin_block_plain(p, x, ws, shift, nh)
            torch.cuda.synchronize()
            assert_close(f"swin_block stage {i + 1} shift {shift}", got, want)
            err = max(err, max_err(got, want))
        ms = cuda_ms(lambda: sb.fused_swin_block(p, x, ws, ws // 2, nh))
        plain = cuda_ms(lambda: sb.fused_swin_block_plain(p, x, ws, ws // 2,
                                                          nh))
        real = batch * h * w
        weights = c * 3 * c + c * c + 2 * c * hid
        nbytes = (2 * real * c * 2 + weights * 2 + (5 * c + hid) * 4
                  + 4 * c * 4 + (2 * ws - 1) ** 2 * nh * 4)
        # a padded token is 0 at the qkv input (its k, v are the bias) and
        # its query row is cropped: products over real tokens, attention of
        # real queries over all N keys of their window
        flops = (2 * real * c * 3 * c                  # qkv
                 + 4 * real * N * c                    # attention
                 + 2 * real * (c * c + 2 * c * hid))   # proj, MLP
        entry.add(depth, err, ms, plain, None, nbytes, flops)
        log(f"kernel swin_block stage {i + 1}: x {tuple(x.shape)} "
            f"max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
            f"bound_ms {bound_ms(nbytes, flops):.4f} "
            f"({bound_by(nbytes, flops)}) library_ms null x{depth}")
    return entry


def check_ragged_step(cfg, np_params, rows):
    """Phase 3: the ragged step against its plain version at the beam's
    rows (10 images x beam 5), at uniform pos 0, 74 and 149 and at a
    ragged position vector, in both head modes: bf16 within the decoder
    step's tolerance, and in float32 its argmax equal to the plain
    version's."""
    import torch

    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    dev = torch.device(DEVICE)
    entry = Entry("ragged_step", "handwritten_math_ocr_api_torch/csrc/"
                  "ragged_step.cu",
                  "handwritten_math_ocr_api_tpu/ops/fused_step.py:1220",
                  f"one launch (embedding, all decoder layers, head logits) "
                  f"for {rows} rows at the last slot (pos = T - 1)")
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    F, L_enc, V = cfg.dim_feedforward, cfg.encoder_len, cfg.vocab_size
    err = 0.0
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(dtype=dtype)
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dt)

        stacked = fs.build_stacked_full(np_params["decoder"], c, dev)
        sk, sv = randn(L, rows, T, D), randn(L, rows, T, D)
        ck, cv = randn(L, rows, L_enc, D), randn(L, rows, L_enc, D)
        prev = torch.randint(0, V, (rows,), generator=gen, device=dev,
                             dtype=torch.int32)
        cases = {f"pos {p}": torch.full((rows,), p, dtype=torch.int32,
                                        device=dev)
                 for p in (0, T // 2 - 1, T - 1)}
        cases["ragged"] = torch.randint(0, T, (rows,), generator=gen,
                                        device=dev, dtype=torch.int32)
        for name, pos in cases.items():
            for logits in (True, False):
                got = fs.fused_ragged_step(stacked, c, prev, pos, sk, sv, ck,
                                           cv, return_logits=logits)
                want = fs.fused_ragged_step_plain(stacked, c, prev, pos, sk,
                                                  sv, ck, cv,
                                                  return_logits=logits)
                torch.cuda.synchronize()
                what = f"ragged_step {dtype} {name} logits {logits}"
                if not logits:
                    agree = (got[0] == want[0]).float().mean().item()
                    if dtype == "float32" and agree < 1.0:
                        raise AssertionError(f"{what}: argmax differs")
                    log(f"kernel {what}: argmax agrees {agree:.4f}")
                    got, want = got[1:], want[1:]
                tol = ((STEP_ATOL, STEP_RTOL) if dtype == "bfloat16"
                       else (F32_STEP_ATOL, F32_STEP_ATOL))
                for g, w in zip(got, want):
                    assert_close(what, g, w, *tol)
                e = max(max_err(g, w) for g, w in zip(got, want))
                if dtype == "bfloat16":
                    err = max(err, e)
                log(f"kernel {what}: max_abs_err {e:.3g}")
        if dtype == "bfloat16":
            timed = (stacked, c, prev, cases[f"pos {T - 1}"], sk, sv, ck, cv)
    pos = T - 1
    ms = cuda_ms(lambda: fs.fused_ragged_step(*timed, return_logits=True))
    plain = cuda_ms(lambda: fs.fused_ragged_step_plain(*timed,
                                                       return_logits=True))
    weights = L * (D * 3 * D + 3 * D * D + 2 * D * F)
    small = L * (3 * D + 3 * D + F + D + 6 * D)        # biases, LN (f32)
    nbytes = (weights * 2 + small * 4 + (D * V + V) * 4    # head (f32)
              + 2 * rows * 4 + 2 * rows * D * 4            # prev, pos, rows
              + 2 * L * rows * L_enc * D * 2               # cross K/V
              + 2 * L * rows * pos * D * 2                 # cache prefix
              + rows * V * 4 + 2 * L * rows * D * 2)       # outputs
    flops = 2 * rows * weights + 4 * L * rows * D * (pos + 1 + L_enc)
    f32_flops = 2 * rows * D * V                           # the head
    entry.add(1, err, ms, plain, None, nbytes, flops, f32_flops)
    log(f"kernel ragged_step: caches {tuple(timed[4].shape)} pos {pos} "
        f"max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
        f"bound_ms {bound_ms(nbytes, flops, f32_flops):.4f} "
        f"({bound_by(nbytes, flops, f32_flops)}) library_ms null")
    return entry


def check_beam_reorder(cfg, rows):
    """Phase 3: the beam cache reorder against its plain version at the
    beam's rows, over the whole cache and over a prefix, fresh and into a
    preallocated pair: exactly equal. Its time is the kernel's alone (the
    C entry called directly); the wrapper's call, which first reads the
    range of ``src`` on the host, is timed beside it."""
    import torch

    from handwritten_math_ocr_api_torch.ops import _build
    from handwritten_math_ocr_api_torch.ops import beam_reorder as br

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    entry = Entry("beam_cache_gather", "handwritten_math_ocr_api_torch/"
                  "csrc/beam_reorder.cu",
                  "handwritten_math_ocr_api_tpu/ops/beam_reorder.py:31",
                  "one launch over the whole cache (t_ext = T)")
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    sk, sv = (torch.randn(L, rows, T, D, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    src = torch.randint(0, rows, (rows,), generator=gen, device=dev,
                        dtype=torch.int32)
    for t_ext in (T // 2, T):
        want = br.beam_cache_gather_plain(sk, sv, src, t_ext)
        got = br.beam_cache_gather(sk, sv, src, t_ext)
        out = (torch.zeros_like(sk), torch.zeros_like(sv))
        br.beam_cache_gather(sk, sv, src, t_ext, out=out)
        torch.cuda.synchronize()
        for g, o, w in zip(got, out, want):
            if not (torch.equal(g, w) and torch.equal(o[:, :, :t_ext], w)
                    and not o[:, :, t_ext:].any()):
                raise AssertionError(f"beam_cache_gather t_ext {t_ext}: "
                                     f"not the plain gather")
    gk, gv = (torch.empty_like(sk), torch.empty_like(sv))
    lib_c = _build.library()

    def kernel_only():
        _build.check(lib_c.beam_cache_gather(
            sk.data_ptr(), sv.data_ptr(), src.data_ptr(), gk.data_ptr(),
            gv.data_ptr(), L, rows, T, T, T, D * 2,
            _build.stream_handle(dev)), "beam_cache_gather")

    ms = cuda_ms(kernel_only)
    wrapped = cuda_ms(lambda: br.beam_cache_gather(sk, sv, src, T))
    plain = cuda_ms(lambda: br.beam_cache_gather_plain(sk, sv, src, T))
    idx = src.long()
    lib = cuda_ms(lambda: (sk.index_select(1, idx), sv.index_select(1, idx)))
    nbytes = 2 * 2 * L * rows * T * D * 2 + rows * 4
    entry.add(1, 0.0, ms, plain, lib, nbytes, 0.0)
    log(f"kernel beam_cache_gather: caches {tuple(sk.shape)} t_ext {T} "
        f"exact; ms {ms:.4f} (the wrapper's call with its host check of "
        f"src: {wrapped:.4f}) plain_ms {plain:.4f} index_select_ms "
        f"{lib:.4f} (two calls) bound_ms {bound_ms(nbytes, 0.0):.4f}")
    return entry


def fused_blocks(cfg) -> int:
    """Swin blocks per encode that the route rule sends to the block
    kernel (10 of 12 on Swin-T at 96x320: stages 1-3)."""
    from handwritten_math_ocr_api_torch.ops.swin_block import fits_vmem

    ws = cfg.swin.window_size
    return sum(depth for _, _, c, _, depth, _, pw in stage_shapes(cfg, 1)
               if fits_vmem(c, ws, pw, int(c * cfg.swin.mlp_ratio)))


def check_counts(counts, expected):
    if counts != expected:
        raise AssertionError(f"kernel launches {counts} != {expected}")


def profile_batch(engine, images, unprofiled_s, beam_size=None):
    """Device busy time of one predict_batch, and its largest kernels. The
    idle share is given against the profiled wall time and against the
    best unprofiled one (the profiler slows the host, not the device).
    Returns the latter, or None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict_batch(images, beam_size=beam_size)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    best_ms = unprofiled_s * 1e3
    if not rows:
        log("profile: the profiler saw no device time (not measured)")
        return None
    log(f"profile: predict_batch({len(images)}, beam_size={beam_size}) "
        f"wall {wall_ms:.1f} ms under "
        f"the profiler, device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f} (against the unprofiled "
        f"{best_ms:.1f} ms: {1 - busy_ms / best_ms:.3f})"
        f", device kernels {sum(e.count for e in rows)}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile: {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x {e.key[:100]}")
    return 1 - busy_ms / best_ms


def kernel_wrappers():
    """The eight wrappers, in the order of the ``kernels`` line."""
    from handwritten_math_ocr_api_torch.ops.beam_reorder import (
        beam_cache_gather,
    )
    from handwritten_math_ocr_api_torch.ops.cache_attention import (
        cache_append_attention,
        decode_attention,
    )
    from handwritten_math_ocr_api_torch.ops.fused_step import (
        fused_decoder_layers_step_v2,
        fused_ragged_step,
    )
    from handwritten_math_ocr_api_torch.ops.patch_merging import (
        fused_patch_merging,
    )
    from handwritten_math_ocr_api_torch.ops.swin_block import (
        fused_swin_block,
    )
    from handwritten_math_ocr_api_torch.ops.window_attention import (
        window_attention_core,
    )

    return [window_attention_core, fused_patch_merging,
            cache_append_attention, decode_attention,
            fused_decoder_layers_step_v2, fused_swin_block,
            fused_ragged_step, beam_cache_gather]


def expected_launches(cfg, route, encodes, steps, beam=False):
    """Each wrapper's launches for ``encodes`` encodes and ``steps`` decode
    steps (greedy, or beam search with ``beam``) on a route: the default
    one ("pallas": window attention in every block, cache-append attention
    in every layer of every step) or the fused one (the block kernel where
    the route rule fuses, window attention in the other blocks; per step
    one launch of the decoder step, or for beam search one of the ragged
    step and one of the beam cache reorder). No path runs decode
    attention."""
    blocks = sum(cfg.swin.depths)
    merges = len(cfg.swin.depths) - 1
    if route == "pallas":
        return [encodes * blocks, encodes * merges,
                cfg.num_decoder_layers * steps, 0, 0, 0, 0, 0]
    fused = fused_blocks(cfg)
    per_step = [0, steps, steps] if beam else [steps, 0, 0]
    return [encodes * (blocks - fused), encodes * merges, 0, 0,
            per_step[0], encodes * fused, *per_step[1:]]


def route_decode(engine, cfg, memory, kernels):
    """The engine's decode on its route, through the kernels or their
    plain versions."""
    from handwritten_math_ocr_api_torch.decode.fused import (
        greedy_decode_fused,
    )
    from handwritten_math_ocr_api_torch.decode.greedy import greedy_decode

    if engine.use_fused:
        return greedy_decode_fused(engine.params["decoder"], engine.stacked,
                                   cfg, memory, kernels=kernels)
    return greedy_decode(engine.params["decoder"], cfg, memory,
                         kernels=kernels)


def serve(cfg, np_params, tok, entries, route, **route_kw):
    """Phase 4: one route of the served path at full width, through the
    kernels: greedy, then beam search (``serve_beam``). Returns
    ((images/s, idle share) of greedy, serve_beam's result)."""
    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch.decode.api import (
        DecodeEngine,
        pick_bucket,
    )
    from handwritten_math_ocr_api_torch.models import model as model_mod

    wrappers = kernel_wrappers()
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (N_IMAGES, cfg.img_h, cfg.img_w, 1),
                          dtype=np.uint8)
    single = rng.integers(0, 256, (cfg.img_h, cfg.img_w, 1), dtype=np.uint8)

    engine = DecodeEngine(np_params, cfg, tokenizer=tok, device=DEVICE,
                          **route_kw)
    engine.warmup((N_IMAGES,), dtype=np.uint8)
    torch.cuda.synchronize()

    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    texts = engine.predict_batch(images)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    steps = engine.last_steps
    latex, conf = engine.predict_single(single)
    torch.cuda.synchronize()
    steps += engine.last_steps
    counts = [w.launches for w in wrappers]
    expected = expected_launches(cfg, route, 2, steps)
    log(f"serve {route}: predict_batch({N_IMAGES}) + predict_single: decode "
        f"steps {steps}, launches {counts}, expected {expected} "
        f"({[e.d['name'] for e in entries]})")
    check_counts(counts, expected)
    for e, n in zip(entries, counts):
        e.d["launches"] += n
        e.d["launches_by_route"][route] = n
    if len(texts) != N_IMAGES or not all(isinstance(s, str) for s in texts):
        raise AssertionError("predict_batch returned malformed texts")
    if not (isinstance(latex, str) and 0.0 <= conf <= 1.0):
        raise AssertionError(f"predict_single returned {latex!r}, {conf}")
    log(f"serve {route}: predict_batch first text {texts[0][:80]!r}")
    log(f"serve {route}: predict_single {latex[:80]!r} confidence "
        f"{conf:.4f}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.predict_batch(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    log(f"serve {route}: predict_batch({N_IMAGES}) seconds "
        f"{[round(t, 4) for t in times]} "
        f"(first counted run {batch_s:.4f}), {engine.last_steps} steps, "
        f"images/s {N_IMAGES / best:.2f}")

    idle = profile_batch(engine, images, best)

    # the kernel path against the plain path on the card, bf16
    block = engine.pallas_encoder_block
    x, _ = engine._pad_batch(images)
    with torch.inference_mode():
        mem_k = model_mod.encode(engine.params, cfg, x,
                                 use_pallas_block=block)
        mem_p = model_mod.encode(engine.params, cfg, x, kernels=False,
                                 use_pallas_block=block)
        res_k = route_decode(engine, cfg, mem_k, True)
        res_p = route_decode(engine, cfg, mem_p, False)
    if not torch.isfinite(mem_k.float()).all():
        raise AssertionError("encoder memory is not finite")
    bucket = pick_bucket(N_IMAGES, engine.decode_cfg.batch_buckets)
    if tuple(mem_k.shape) != (bucket, cfg.encoder_len, cfg.d_model):
        raise AssertionError(f"memory shape {tuple(mem_k.shape)}")
    mem_err = max_err(mem_k, mem_p)
    scale = mem_p.float().abs().max().item()
    agree = (res_k.tokens == res_p.tokens).float().mean().item()
    log(f"serve {route}: bf16 memory kernel vs plain max_abs_err "
        f"{mem_err:.4g} (memory max |x| {scale:.3g}); greedy tokens agree "
        f"{agree:.4f}")
    if mem_err > MEMORY_BF16_REL * scale:
        raise AssertionError(f"bf16 encoder memory differs by {mem_err}")

    # float32: the same weights through the kernels and the plain path
    cfg32 = cfg.replace(dtype="float32")
    engine32 = DecodeEngine(np_params, cfg32, tokenizer=tok, device=DEVICE,
                            **route_kw)
    x32, _ = engine32._pad_batch(images[:2])
    with torch.inference_mode():
        m_k = model_mod.encode(engine32.params, cfg32, x32,
                               use_pallas_block=block)
        m_p = model_mod.encode(engine32.params, cfg32, x32, kernels=False,
                               use_pallas_block=block)
        r_k = route_decode(engine32, cfg32, m_k, True)
        r_p = route_decode(engine32, cfg32, m_p, False)
    err32 = max_err(m_k, m_p)
    log(f"serve {route}: float32 memory kernel vs plain max_abs_err "
        f"{err32:.3g}; tokens equal {torch.equal(r_k.tokens, r_p.tokens)} "
        f"over {r_k.steps} steps")
    if err32 > MEMORY_F32_ATOL:
        raise AssertionError(f"float32 encoder memory differs by {err32}")
    if not torch.equal(r_k.tokens, r_p.tokens):
        raise AssertionError("float32 greedy tokens differ between the "
                             "kernel path and the plain path")
    # sums of up to 150 float32 log-probs: summation order only
    lp_err = (r_k.logprob_sum - r_p.logprob_sum).abs().max().item()
    if lp_err > 1e-2:
        raise AssertionError(f"float32 logprob sums differ by {lp_err}")
    beam = serve_beam(engine, engine32, images, entries, route)
    return (N_IMAGES / best, idle), beam


def route_beam(engine, cfg, memory, kernels):
    """The engine's beam search on its route, through the kernels or their
    plain versions."""
    from handwritten_math_ocr_api_torch.decode.beam import beam_decode
    from handwritten_math_ocr_api_torch.decode.fused import (
        beam_decode_fused,
    )

    if engine.use_fused:
        return beam_decode_fused(engine.params["decoder"], engine.stacked,
                                 cfg, memory, BEAM, kernels=kernels)
    return beam_decode(engine.params["decoder"], cfg, memory, BEAM,
                       kernels=kernels)


def serve_beam(engine, engine32, images, entries, route):
    """Phase 4, beam search: ``predict_batch`` of the images at beam 5 on
    the route of ``engine`` (bf16) through the kernels, its launches
    against the route's shape; then the tokens against the route's plain
    path (bf16: agreement printed; float32 on two images: equal) and, on
    the fused route, the float32 fused beam against the default beam on
    the same memory. Returns (images/s, idle share, steps)."""
    import torch

    from handwritten_math_ocr_api_torch.decode.beam import beam_decode
    from handwritten_math_ocr_api_torch.models import model as model_mod

    wrappers = kernel_wrappers()
    cfg, cfg32 = engine.cfg, engine32.cfg
    name = f"{route} beam"
    engine.predict_batch(images, beam_size=BEAM)       # warm up
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    texts = engine.predict_batch(images, beam_size=BEAM)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    steps = engine.last_steps
    counts = [w.launches for w in wrappers]
    expected = expected_launches(cfg, route, 1, steps, beam=True)
    log(f"serve {name}: predict_batch({N_IMAGES}, beam_size={BEAM}): "
        f"decode steps {steps}, launches {counts}, expected {expected}")
    check_counts(counts, expected)
    for e, n in zip(entries, counts):
        e.d["launches"] += n
        e.d["launches_by_route"][name] = n
    if len(texts) != N_IMAGES or not all(isinstance(t, str) for t in texts):
        raise AssertionError("beam predict_batch returned malformed texts")
    log(f"serve {name}: first text {texts[0][:80]!r}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.predict_batch(images, beam_size=BEAM)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    log(f"serve {name}: predict_batch({N_IMAGES}, beam_size={BEAM}) "
        f"seconds {[round(t, 4) for t in times]} (first counted run "
        f"{first_s:.4f}), {engine.last_steps} steps, images/s "
        f"{N_IMAGES / best:.2f}")
    idle = profile_batch(engine, images, best, beam_size=BEAM)

    block = engine.pallas_encoder_block
    x, B = engine._pad_batch(images)
    with torch.inference_mode():
        mem = model_mod.encode(engine.params, cfg, x,
                               use_pallas_block=block)[:B]
        res_k = route_beam(engine, cfg, mem, True)
        res_p = route_beam(engine, cfg, mem, False)
    if not torch.isfinite(res_k.scores).all():
        raise AssertionError("beam scores are not finite")
    agree = (res_k.tokens == res_p.tokens).float().mean().item()
    log(f"serve {name}: bf16 beam tokens, kernels vs plain on the same "
        f"memory, agree {agree:.4f}")

    x32, B32 = engine32._pad_batch(images[:2])
    with torch.inference_mode():
        m_k = model_mod.encode(engine32.params, cfg32, x32,
                               use_pallas_block=block)[:B32]
        m_p = model_mod.encode(engine32.params, cfg32, x32, kernels=False,
                               use_pallas_block=block)[:B32]
        r_k = route_beam(engine32, cfg32, m_k, True)
        r_p = route_beam(engine32, cfg32, m_p, False)
        other = (beam_decode(engine32.params["decoder"], cfg32, m_k, BEAM)
                 if engine.use_fused else None)
    score_err = (r_k.scores - r_p.scores).abs().max().item()
    log(f"serve {name}: float32 beam tokens equal to the plain path "
        f"{torch.equal(r_k.tokens, r_p.tokens)} over {r_k.steps} steps "
        f"(score max_abs_err {score_err:.3g})"
        + ("" if other is None else
           f"; fused beam equal to the default beam "
           f"{torch.equal(r_k.tokens, other.tokens)}"))
    if not torch.equal(r_k.tokens, r_p.tokens):
        raise AssertionError("float32 beam tokens differ between the "
                             "kernel path and the plain path")
    # sums of up to 150 float32 log-probs: summation order only
    if score_err > 1e-2:
        raise AssertionError(f"float32 beam scores differ by {score_err}")
    if other is not None and not torch.equal(r_k.tokens, other.tokens):
        raise AssertionError("float32 fused beam tokens differ from the "
                             "default route's beam")
    return N_IMAGES / best, idle, steps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.core.tokenizer import (
        Tokenizer,
        load_vocab,
    )
    from handwritten_math_ocr_api_torch.decode.api import (
        DecodeConfig,
        pick_bucket,
    )
    from handwritten_math_ocr_api_torch.ops import _build

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"torch.cuda.get_device_name(0) {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    log(f"build: {os.path.relpath(lib_path)} in "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = load_model_config(MODEL_DIR)
    tok = Tokenizer(*load_vocab(os.path.join(MODEL_DIR, "vocab.json")))
    if len(tok) != cfg.vocab_size:
        raise AssertionError("vocab.json does not match model_config.json")
    np_params = convert.random_params(cfg, SEED)
    params = convert.to_torch(np_params, cfg, DEVICE)
    bucket = pick_bucket(N_IMAGES, DecodeConfig().batch_buckets)
    entries = check_kernels(cfg, params, bucket)
    entries.append(check_fused_step(cfg, np_params, bucket))
    entries.append(check_swin_block(cfg, np_params, params, bucket))
    entries.append(check_ragged_step(cfg, np_params, N_IMAGES * BEAM))
    entries.append(check_beam_reorder(cfg, N_IMAGES * BEAM))

    routes = {"pallas": {},
              "fused": {"use_fused": True, "pallas_encoder_block": True}}
    summary = {}
    for route, kw in routes.items():
        summary[route] = serve(cfg, np_params, tok, entries, route, **kw)
    for route, (greedy, beam) in summary.items():
        for mode, (rate, idle, *_) in (("greedy", greedy),
                                       (f"beam {BEAM}", beam)):
            idle_s = "not measured" if idle is None else f"{idle:.3f}"
            log(f"route {route} {mode}: images/s {rate:.2f}, device idle "
                f"share {idle_s} (of the best unprofiled predict_batch)")

    log(json.dumps({"kernels": [e.d for e in entries]}))
    log(f"total seconds {time.perf_counter() - t_start:.1f}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
