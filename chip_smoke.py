#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printed on its own lines:

1. the device (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of the CUDA kernels in ``handwritten_math_ocr_api_torch/csrc``
   with ``nvcc``, and its seconds;
3. each of the twenty-three kernel entries against its plain PyTorch version
   on the card, in bf16, at the shapes the served paths give it (a
   10-image request padded to the 16-row batch bucket; beam search at
   beam 5 on the 10 images, 50 rows): window attention at every stage,
   unshifted (one (1, nh, N, N) mask for all windows) and shifted, patch
   merging, cache-append attention and decode attention at slots 0, 1,
   7, 8, 74, 75, 148 and 149 (and at 0, 74 and 149 on the beam's 50
   rows), each redesigned kernel's time also as a ratio to SDPA's; the
   fused decoder step at pos 0, 74 and 149, with the float
   bundle and the int8 one; the "v1" step that writes its rows into the
   caches (x_out and the written slot within the step tolerance, every
   other slot unchanged), these three also gated at one row and timed at
   the bucket (at each gated slot) and at one row, with the cluster shape
   of each launch; and the whole step of "v3"/"v4" in both cache
   layouts (its argmax equal wherever the plain logits' top-2 margin
   exceeds the step tolerance), each at pos 0, 74 and 149 at the bucket
   and at one row, with its cluster shape; the MQA entries of the fused
   decoder step (bf16 and int8 bundles) and of the ragged step (both
   bundles, bf16 and float32) as those of MHA, on the MQA configuration
   (``nhead_kv=1``: self caches of one 32-lane KV head, a packed qkv
   weight of 320 columns); the whole decode of 150 steps
   with the bf16 and the int8 resident bundle at the bucket, at one row
   and on an EOS-boosted bundle whose rows, at the bucket, end at
   different steps and some never, with a row that finished beside a
   live one in a cluster's group (its tokens equal to the plain version's
   up to a first difference at such a near-tie in a row, PAD after EOS),
   with its cluster shape; the whole Swin block at stages 1-3, unshifted and
   shifted, at one image and at the bucket, with its cluster geometry and
   beside the unfused block of the default route (``unfused_ms``); patch
   merging at its three merges at one image and at the bucket, beside
   layer norm and one matmul on the gathered rows (``unfused_ms``);
   the ragged step, the whole step and the whole decode past the
   positional table (cut to 8 rows: a model whose ``max_seq_len`` lies
   under the decode's), against their plain versions, which take the
   table's last row there as JAX's gather clamps the index;
   the ragged step at the beam's 50 rows at pos 0, 74, 149 and a ragged
   position vector and at the bucket's 16 rows at pos 149 and a ragged
   vector, in both head modes, with both bundles (and in float32, where its
   argmax must be equal, for the int8 bundle wherever the plain logits are
   no near-tie), one launch with two rows out of range (NaN and nxt -1
   there only), its cluster shape at both row counts and its times at pos
   0, 74 and 149; the beam cache reorder over the whole cache and a prefix
   (exactly equal); the ragged step's segment-ring entries (bf16 and int8
   bundles, MHA and MQA, each also in float32) at continuous batching's
   pool of 48 rows, with segment starts at 0, pos and pos - 63 (a ring of
   64 rows), the first n_chunks 16-row chunks (1, 2, 3; ring and not) and
   two rows whose segment starts lie out of range (NaN and nxt -1 there
   only), timed at pos 149 from slot 86 beside the non-ring entry and at
   n_chunks 1 and 3 with each one's cluster shape; the int8 dequant
   matmul at each projection of a
   decoder layer and the float32 head at 16 and 50 rows, and the cross K/V
   projection at 480 and 1500, each shape's time beside cuBLAS's on the
   weight dequantized beforehand. Each with its device time
   (``torch.profiler``: the kernels' own time, not the host's launch
   rate), the plain version's wall (CUDA events around 5 back-to-back
   calls, ``plain_ms``; for the whole decode, whose plain version launches
   some 40,000 small kernels, the synchronized wall of its one reference
   run), the time of one PyTorch library call computing
   the same function where there is one (else null; for the dequant matmul
   ``torch._weight_int8pack_mm``), and the least time the card could take
   (its bound, and whether bytes or operations set it);
4. served decoding at full width on four routes of the engine: the
   ``serving_model_r4`` configuration (Swin-T, d_model 256, 8 decoder
   layers, vocab 138; its ``model_config.json`` and ``vocab.json``) with
   seeded random weights (nonzero biases and norms). The routes are
   ``DecodeEngine()`` (the JAX ``use_pallas=True`` configuration),
   ``DecodeEngine(use_fused=True, pallas_encoder_block=True)``, and each
   with ``quantize=True`` (the int8 decoder); the two default routes with
   their decoder cut to ``DEFAULT_ROUTE_LAYERS`` layers, the fused ones at
   full depth. On each, greedy:
   ``predict_batch`` on 10 seeded images and ``predict_single`` on one;
   then beam search: ``predict_batch`` of the 10 images with
   ``beam_size=5``. Each path with every kernel's launch count set to 0
   before and checked against the route's shape after; the encoder memory
   and the tokens against the route's plain path on the card (bf16, and
   float32 where tokens must be equal; the fused beam's float32 tokens also
   equal to the default beam's). On the fused int8 route, whose steps
   round their matmul inputs to bf16 even in float32, the float32 check is
   a decode whose every step runs both steps (B1 and B7) beside the plain
   one on the plain path's tokens: their logits within the bf16 step
   tolerance, and any token where the kernel's argmax differs reported
   with the plain logits' margin there. Images per second and the
   device's idle share; the int8 routes' bf16 tokens against the float
   route of the same kind (printed);
5. "serve mqa", grouped self-attention at full width on the
   configuration's shapes with ``nhead_kv`` set (seeded random weights):
   MQA (``nhead_kv=1``) on the fused route at full depth, bf16 and int8,
   greedy, ``predict_single`` and beam 5 (the MQA entries of the fused
   decoder step and the ragged step), and on the default route, greedy
   (grouped attention on plain ops), each checked as in phase 4; GQA-2
   (``nhead_kv=2``) with ``use_fused``: a warning, the default route
   (phase 4's checks, greedy), and its tokens equal to the GQA-2 default
   engine's; the default routes with ``DEFAULT_ROUTE_LAYERS`` decoder
   layers, as phase 4's;
6. "serve continuous", continuous batching
   (``decode/continuous.ContinuousDecoder``) at full width: 32 slots,
   segments of 16 steps (64 when the pool is full and nothing waits), the
   segment ring; seeded weights with the EOS bias raised, 40 seeded images
   submitted 8 at once and then 4 a scheduler tick (admissions mid-flight,
   slots reused). The fused route in bf16: launch counts (the encoder's
   kernels per admission encode, one ragged step a scheduled step, no
   other decoder kernel), images/s, the device's idle share and the
   scheduler's stats; in float32, ring on and off, results and tokens
   equal to the fused engine's; the int8 bundle (bf16) held against its
   plain decode as phase 3 holds the whole decode; MQA in float32 equal
   to its fused engine and its int8 bundle held so too; the default
   route (``DEFAULT_ROUTE_LAYERS`` decoder layers) in float32 equal to the
   default engine;
7. "quality", the shipped weights on the ``data_eval_hard`` test split:
   the libzstd probe; ``serving_model_r4/params`` read by the port's own
   reader (``train/checkpoint.load_params_for_serving``) and its
   ``tree_digest``, the 2,000 test PNGs decoded by the port's PNG reader
   and their sha256, both equal to ``tests/fixtures/torch_r4_quality.json``
   (written by ``quality_bar.py`` with the JAX package on a CPU); the first
   64 images in float32 on the default route (all 8 decoder layers) and the
   fused one, predictions equal to JAX's float32 ones but for at most one
   (each difference with its first differing step and the card's top-2
   logit margin there); then through the port's harness
   (``eval/harness.evaluate_model``) at batch 64, each cell's launch counts
   set to 0 before it and checked after: fused bf16 and int8 greedy on all
   2,000 images, default bf16 and int8 greedy (8 layers) and fused beam 5
   on the first 512, ``ContinuousDecoder`` (fused bf16, one request an
   image) on the first 512, and fused bf16 greedy with ``constrained=True``
   on the first 512 (valid LaTeX exactly 1); each cell's exact match no
   more than 1.5 points under its bar and corpus CER no more than 0.01
   above it, beside its valid LaTeX, mean confidence, ECE and images/s;
   then fused bf16 sampling with ``top_k=1`` on the first 64, its strings
   equal to fused greedy's;
8. the fused greedy decode's A/B arms (``greedy_decode_fused(variant=)``:
   v1, v2, v3, v4, and v5 with the int8 and the bf16 resident bundle) at
   full width on the fused route's encoder memory of the 10-image request:
   each arm's launch counts (150 of its step kernel, or one whole decode),
   the wall of a decode, images/s and the device's idle share; float32
   tokens of every arm equal to its plain path's and v2's (the int8 v5,
   whose matmul inputs round to bf16, held as the whole decode is in
   phase 3);
9. "serve modes", the decode modes and serving engines beside greedy and
   beam, each path's launch counts set to 0 before it and checked after:
   ``sample_tokens`` of the 10-image request on four routes (default and
   fused, float and int8; the default ones at ``DEFAULT_ROUTE_LAYERS``),
   one seed twice equal and two seeds different in bf16, ``top_k=1``
   equal to greedy in float32, images/s and (fused) the idle share;
   constrained greedy on both routes (every output valid by
   ``eval/latex_check.check_latex``, float32 tokens equal to the plain
   path's) and ``ContinuousDecoder(constrained=True)`` (fused, ring on and
   off; default) equal to its route's constrained engine in float32;
   ``predict_stream`` of one image at segments of 8 and 16 on both routes,
   float32, equal to ``predict_single`` with one host read a segment, the
   time to the first event beside the stream's; ``serve/batcher.py``'s
   ``BatchingEngine`` and ``ContinuousServingEngine`` (fused, 32 slots)
   under 40 concurrent requests in float32, each result equal to its image
   decoded alone, a cancelled waiter dropped or its slot freed, stats and
   images/s. The streams, continuous runs and engines use the seeded
   weights with the EOS bias raised (and the PAD bias lowered);
10. "serve app", the HTTP app (``serve/app.py`` on ``serve/http.py``)
   started in this process on 127.0.0.1 and driven by a standard-library
   client, each step's launch counts set to 0 before it and checked after
   (each decode's encode and its steps on the fused route; B5 in every
   layer of every step of a stream): the shipped weights in float32 (a
   temporary artifact: ``vocab.json``, ``params`` linked,
   ``model_config.json`` with ``"dtype": "float32"``), fused route
   (``use_fused_decode``, ``pallas_encoder_block``), dynamic batching,
   rate limits raised; ``/health``, ``/status`` (device ``cuda``) and
   ``/model/info`` (the tree's parameter count); 8 test PNGs posted one
   after another (multipart and base64), each equal to
   ``engine.predict_single`` on the same uint8 image (confidence within
   1e-6); 32 concurrent requests, each equal to its image alone (1e-4);
   ``/predict/batch`` of 10 entries, one bad (9 equal to
   ``predict_with_confidence``); ``?beam_size=5`` equal to
   ``predict_batch(beam_size=5)``, ``?top_k=1`` to greedy; a stream of
   segments of 8 ending in ``/predict``'s result with one host read a
   segment; 8 greedy, 2 beam, 2 ``top_k=1`` and 2 stream requests at once
   (the batcher's and the executor's threads launching together), each
   equal to its result alone; ``/metrics``. Then ``batching_mode=
   "continuous"`` (32 slots): 32 concurrent requests equal to their
   images alone, and a client that disconnects mid-decode frees its slot
   (the decoder's ``cancelled``, ``active_slots`` 0). Printed, not gated:
   the bf16 shipped weights, fused route, dynamic batching: 16 requests
   from one client (a request's round trip), then three windows of 384
   from 16 closed-loop clients: requests/s, p50 and p95 latency, a
   request's and a batch's stages, for each window and over the three,
   the card's name and power limit and the host's CPU and load;
11. "train", the training path (``train/``): (a) the shipped weights in
   float32 on the first 256 test images (batches of 64, no augmentation,
   dropout and stochastic depth 0) against ``tests/fixtures/
   torch_r4_train.json`` (the JAX package's train and eval steps on a
   CPU): the eval loss within 1e-3 relative, the token accuracy within
   0.002, the first batch's gradient norm and its loss after one Adam step
   within 1e-3 relative; (b) a fresh model at full width (Swin-T, d_model
   256, 8 decoder layers, ``memory_norm``, the synthetic grammar's vocab,
   dropout and stochastic depth 0.1) trained in bf16 for 100 steps of 64
   synthetic stream images, augmented in the step, with warmup: no kernel
   launched in a train step, the mean loss of the last 20 steps at least
   ``TRAIN_LOSS_MARGIN`` under the first 20's, images/s, ms a step, the
   loader's wait, a profiled step's device idle share and the peak
   device memory; one eval step launching B2 and B3 as an encode does;
   (c) float32: saved after 3 steps and restored into a fresh state, the
   next 5 losses equal to an uninterrupted run's; (d) the trained weights
   written by ``save_params_for_serving``, read back bit for bit and
   decoded on the default and the fused route, their float32 tokens
   equal;
12. "resnet", the ResNet encoders (``serving_model_r4``'s configuration
   with ``encoder`` replaced: the 1-channel ResNet-18 trunk, its height
   pool and projection to d_model 256, 10 memory columns at 96x320;
   seeded weights and BatchNorm statistics away from 0 and 1): (a) the
   decoder kernels that read cross K/V at 10 columns against their plain
   versions with phase 3's tolerances (B1 bf16 and int8 at the bucket
   and at one row, pos 0/74/149; B7 both bundles at the beam's 50 rows,
   pos 0/74/149 and ragged; B7's ring entries at the continuous pool,
   both bundles; B9 at the cross K/V shapes of 160 and 500 rows; B10-B12
   and the MQA entries at 10 columns are left to
   ``tests/test_torch_kernels_cuda.py``), each time printed beside
   its 30-column time and written into its ``kernels`` entry
   (``ms_lenc10``); (b) ``resnet18`` on the default route (decoder cut to
   ``DEFAULT_ROUTE_LAYERS``) and the fused route through phase 4's
   checks (greedy and beam 5 of 10 images, launch counts with no encoder
   kernel, float32 tokens equal to the plain path, images/s, idle share),
   and the encode of 16 images timed by CUDA events; (c) ``res18trans``
   (8 transformer encoder layers): fused greedy (launch counts), then 16
   requests through ``ContinuousDecoder`` on the fused route in float32,
   equal to the fused engine; (d) a seeded reference-layout ``resnet18``
   built here in plain ``torch.nn``, saved, made a serving artifact by
   ``python -m handwritten_math_ocr_api_torch convert-checkpoint`` and
   served in float32: its 40 BatchNorm statistics present, its tokens
   equal to the in-memory converted tree's, its encoder memory within
   1e-4 of the module's own ``eval()`` forward; (e) one float32 train
   step of ``resnet18`` at batch 16 on the card and on the host from the
   same inputs (loss, gradient norm and new statistics within 1e-4
   relative), then 30 bf16 steps at batch 64 of the synthetic stream
   (images/s, ms a step, idle share, peak memory; a finite loss and
   statistics that moved);
13. a ``kernels`` JSON line, the ``nvidia-smi`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

It imports torch, numpy and the port only; phases 1-6, 8, 9 and 12 run on
seeded random weights, phases 7, 10 and 11 (a) read the checkpoint and the
test split. It exits non-zero on any failure, or when no CUDA device is
present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
DEVICE = "cuda"
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(REPO_ROOT, "serving_model_r4")
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
# the int8 bundle of the decoder steps rounds every matmul input to bf16,
# in a float32 configuration too, so kernel and plain carry the bf16
# steps' rounding differences: they are held at STEP_ATOL / STEP_RTOL in
# both dtypes
# the whole decode's log-prob sums over the rows whose tokens agree, 150
# steps, kernel vs plain: in bf16 (either bundle) and for the int8 bundle
# in float32 (its matmul inputs round to bf16). Runs on an H100 measured
# 0.191 (bf16 bundle), 0.105 (int8) and 0.046 (int8 in float32); the
# limits leave about 2.5x room above those
WHOLE_DECODE_LP_ATOL = 0.5
WHOLE_DECODE_INT8_F32_LP_ATOL = 0.15
# decoder layers of phase 4's two MHA default routes (the model has 8):
# they run no kernel that another phase does not hold at full depth (B2
# and B3 in the encoder, B5 and B9 in phase 3), and host-bound steps of
# ~340 launches made them the script's longest phases
DEFAULT_ROUTE_LAYERS = 2


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 5) -> float:
    """Mean device time of one call of ``fn``: the device time of the
    kernels and copies it launches (``torch.profiler``) over ``iters``
    back-to-back calls. Time the device spends waiting for the host is not
    counted: back to back, a call of a few microseconds of kernels is
    bound by the host's launch rate, which says more about the host than
    about the kernel. The profiler on the GPU machine can miss some
    launches of a session (the first ones, or all), so each kind of kernel
    counts at its mean time a launch, times its launches per call (its
    recorded count over ``iters``, rounded); a session that recorded no
    device activity is run again, up to ``tries`` sessions in all, and
    then the calls are timed with CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]
        per_call = sum(e.self_device_time_total / e.count
                       * round(e.count / iters) for e in rows)
        if per_call > 0:
            return per_call / 1e3
        log("cuda_ms: the profiler recorded no device activity; "
            "profiling again")
    # the profiler went blind on that machine for a while (five empty
    # sessions in a row in one run): CUDA events around the same calls,
    # which count the device's gaps between launches too
    log(f"cuda_ms: the profiler recorded no device activity in {tries} "
        f"sessions; timed with CUDA events instead (gaps included)")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean wall of one call of a kernel's plain version on the card: CUDA
    events around ``iters`` back-to-back calls after ``warmup``. A plain
    version launches tens to thousands of small kernels, and the profiler
    sessions of ``cuda_ms`` over them took most of phase 3's time; the
    events also count the device's gaps between those launches, so the
    number is the plain version's wall, at least its device time."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def check_kernels(cfg, params, batch, rows):
    """Phase 3: every kernel against its plain version at the served
    shapes (``batch`` greedy rows, ``rows`` beam rows). Returns the
    kernels' JSON entries."""
    import torch
    import torch.nn.functional as F

    from handwritten_math_ocr_api_torch.models import swin
    from handwritten_math_ocr_api_torch.ops import _build
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
        q, k, v = (randn(batch, nW, nh, N, dh) for _ in range(3))
        q4, k4, v4 = (t.reshape(batch, nW * nh, N, dh) for t in (q, k, v))
        G = batch * nW * nh
        flops = 4 * G * N * N * dh
        # the stage's even blocks are unshifted, with one (1, nh, N, N)
        # mask for every window; its odd blocks shift where the map is
        # wider than a window, with an (nW, nh, N, N) mask
        for d, blocks in ((0, depth - depth // 2), (1, depth // 2)):
            if not blocks:
                continue
            p_attn = params["encoder"]["stages"][i]["blocks"][d]["attn"]
            shift = d * (ws // 2)
            shift_h = 0 if ws >= ph else shift
            shift_w = 0 if ws >= pw else shift
            mask = swin.attention_mask(p_attn, ws, nh, ph, pw, shift_h,
                                       shift_w).contiguous()
            kind = "shifted" if shift_h or shift_w else "unshifted"
            got = wa.window_attention_core(q, k, v, mask)
            want = wa.window_attention_core_plain(q, k, v, mask)
            torch.cuda.synchronize()
            assert_close(f"window_attention stage {i + 1} {kind}", got, want)
            ms = cuda_ms(lambda: wa.window_attention_core(q, k, v, mask))
            plain = plain_ms(
                lambda: wa.window_attention_core_plain(q, k, v, mask))
            m4 = mask.expand(nW, nh, N, N).reshape(1, nW * nh, N, N).to(bf16)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4))
            nbytes = 4 * G * N * dh * 2 + mask.numel() * 4
            win.add(blocks, max_err(got, want), ms, plain, lib, nbytes, flops)
            log(f"kernel window_attention stage {i + 1} {kind}: q "
                f"{tuple(q.shape)} mask {tuple(mask.shape)} max_abs_err "
                f"{max_err(got, want):.3g} ms {ms:.4f} plain_ms {plain:.4f} "
                f"sdpa_ms {lib:.4f} ratio_to_sdpa {ms / lib:.3f} "
                f"bound_ms {bound_ms(nbytes, flops):.4f} x{blocks}")

        if i == len(cfg.swin.depths) - 1:
            continue
        p_merge = params["encoder"]["merges"][i]
        err = 0.0
        for n in (1, batch):  # predict_single and the bucket
            x = randn(n, h, w, c)
            got = pm.fused_patch_merging(p_merge, x)
            want = pm.patch_merging_plain(p_merge, x)
            torch.cuda.synchronize()
            assert_close(f"patch_merging {i + 1} batch {n}", got, want)
            err = max(err, max_err(got, want))
        ms = cuda_ms(lambda: pm.fused_patch_merging(p_merge, x))
        plain = plain_ms(lambda: pm.patch_merging_plain(p_merge, x))
        # unfused: layer norm (bf16 in and out) and one matmul on the rows
        # gathered beforehand; several calls, not a yardstick of one
        cat = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                         x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        g, b = (p_merge["norm"][k].to(bf16) for k in ("scale", "bias"))
        w_red = p_merge["reduction"]["w"].to(bf16)
        unfused = cuda_ms(lambda: F.layer_norm(cat, cat.shape[-1:], g, b,
                                               1e-5) @ w_red)
        merge.d["unfused_ms"] = merge.d.get("unfused_ms", 0.0) + unfused
        M = batch * (h // 2) * (w // 2)
        nbytes = (x.numel() * 2 + 8 * c * c * 2 + 2 * 4 * c * 4
                  + M * 2 * c * 2)
        flops = 2 * M * 4 * c * 2 * c
        merge.add(1, err, ms, plain, None, nbytes, flops)
        log(f"kernel patch_merging {i + 1}: x {tuple(x.shape)} "
            f"max_abs_err {err:.3g} (batch 1 and {batch}) ms {ms:.4f} "
            f"plain_ms {plain:.4f} unfused_ms {unfused:.4f} bound_ms "
            f"{bound_ms(nbytes, flops):.4f} tile 32x"
            f"{pm.tile_plan(M, c, _build.sm_count(dev))[0]}")

    d = win.d
    log(f"kernel window_attention: one encode ms {d['ms']:.4f} sdpa_ms "
        f"{d['library_ms']:.4f} ratio_to_sdpa "
        f"{d['ms'] / d['library_ms']:.3f} bound_ms {d['bound_ms']:.4f}")

    H, T, Dh = cfg.nhead, cfg.max_seq_len, cfg.head_dim

    def cache_case(n, positions):
        """Both kernels against their plain versions on n rows at each
        slot of ``positions``; returns the caches, the last slot's inputs
        and the largest errors."""
        k_cache, v_cache = randn(n, H, T, Dh), randn(n, H, T, Dh)
        err = err_dec = 0.0
        for pos in positions:
            q, kn, vn = (randn(n, H, 1, Dh) for _ in range(3))
            k2, v2 = k_cache.clone(), v_cache.clone()
            got = ca.cache_append_attention(q, kn, vn, k_cache, v_cache, pos)
            want = ca.cache_append_attention_plain(q, kn, vn, k2, v2, pos)
            torch.cuda.synchronize()
            assert_close(f"cache_append_attention {n} rows pos {pos}", got,
                         want)
            if not (torch.equal(k_cache, k2) and torch.equal(v_cache, v2)):
                raise AssertionError("cache_append_attention: caches differ "
                                     f"from the plain update at pos {pos}")
            err = max(err, max_err(got, want))
            got = ca.decode_attention(q, k_cache, v_cache, pos)
            want = ca.decode_attention_plain(q, k_cache, v_cache, pos)
            torch.cuda.synchronize()
            assert_close(f"decode_attention {n} rows pos {pos}", got, want)
            if not (torch.equal(k_cache, k2) and torch.equal(v_cache, v2)):
                raise AssertionError("decode_attention wrote to the caches")
            err_dec = max(err_dec, max_err(got, want))
        return k_cache, v_cache, q, kn, vn, err, err_dec

    # the default beam route's 50 rows (G = 400): gates, and B5's time
    pos = T - 1
    k_cache, v_cache, q, kn, vn, err, _ = cache_case(
        rows, (0, T // 2 - 1, T - 1))
    ms = cuda_ms(lambda: ca.cache_append_attention(q, kn, vn, k_cache,
                                                   v_cache, pos))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k_cache[:, :, :pos + 1], v_cache[:, :, :pos + 1]))
    log(f"kernel cache_append_attention: caches {tuple(k_cache.shape)} "
        f"pos {pos} max_abs_err {err:.3g} ms {ms:.4f} sdpa_ms {lib:.4f} "
        f"ratio_to_sdpa {ms / lib:.3f} (beam rows; not in the kernels line)")

    # the served greedy batch: every gate slot, both ends of a 16-byte
    # copy's tail, and the timed entries at the last slot
    k_cache, v_cache, q, kn, vn, err, err_dec = cache_case(
        batch, (0, 1, 7, 8, T // 2 - 1, T // 2, T - 2, T - 1))
    ms = cuda_ms(lambda: ca.cache_append_attention(q, kn, vn, k_cache,
                                                   v_cache, pos))
    plain = plain_ms(lambda: ca.cache_append_attention_plain(
        q, kn, vn, k_cache, v_cache, pos))
    kp, vp = k_cache[:, :, :pos + 1], v_cache[:, :, :pos + 1]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kp, vp))
    G = batch * H
    nbytes = 4 * G * Dh * 2 + 2 * G * pos * Dh * 2 + 2 * G * Dh * 2
    flops = 4 * G * (pos + 1) * Dh
    cache.add(1, err, ms, plain, lib, nbytes, flops)
    log(f"kernel cache_append_attention: caches {tuple(k_cache.shape)} "
        f"pos {pos} max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
        f"sdpa_ms {lib:.4f} (prefix attention, no append) ratio_to_sdpa "
        f"{ms / lib:.3f} bound_ms {bound_ms(nbytes, flops):.4f}")

    ms = cuda_ms(lambda: ca.decode_attention(q, k_cache, v_cache, pos))
    plain = plain_ms(lambda: ca.decode_attention_plain(q, k_cache, v_cache,
                                                      pos))
    nbytes = 2 * G * Dh * 2 + 2 * G * (pos + 1) * Dh * 2   # q, out, prefix
    decode.add(1, err_dec, ms, plain, lib, nbytes, flops)
    log(f"kernel decode_attention: caches {tuple(k_cache.shape)} pos {pos} "
        f"max_abs_err {err_dec:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
        f"sdpa_ms {lib:.4f} ratio_to_sdpa {ms / lib:.3f} "
        f"bound_ms {bound_ms(nbytes, flops):.4f}")
    return [win, merge, cache, decode]


def check_fused_step(cfg, np_params, batch, quantize=False):
    """Phase 3: the fused decoder step against its plain version at the
    served shapes, at the first, a middle and the last slot; with the
    float bundle, or with ``quantize`` the int8 one (its int8 entry)."""
    import torch

    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    mqa = "_mqa" if cfg.kv_heads != cfg.nhead else ""
    name = f"fused_step{mqa}_int8" if quantize else f"fused_decoder_step{mqa}"
    entry = Entry(name, "handwritten_math_ocr_api_torch/csrc/fused_step.cu",
                  "handwritten_math_ocr_api_tpu/ops/fused_step.py:774",
                  "one launch (all decoder layers) at the last slot "
                  "(pos = T - 1)")
    stacked = fs.build_stacked(np_params["decoder"], cfg, dev)
    if quantize:
        stacked = fs.quantize_stacked(stacked)
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    L_enc, kvd = cfg.encoder_len, cfg.kv_dim
    sk, sv = randn(L, batch, T, kvd), randn(L, batch, T, kvd)
    ck, cv = randn(L, batch, L_enc, D), randn(L, batch, L_enc, D)
    x = randn(batch, D)
    one = first_row(x, sk, sv, ck, cv)

    def gate(inputs):
        """The kernel against its plain version at the first, a middle
        and the last slot; the largest error."""
        err = 0.0
        for pos in step_positions(cfg):
            got = fs.fused_decoder_layers_step_v2(stacked, cfg, *inputs, pos)
            want = fs.fused_decoder_layers_step_v2_plain(stacked, cfg,
                                                         *inputs, pos)
            torch.cuda.synchronize()
            rows = inputs[0].shape[0]
            for what, g, w in zip(("x_out", "k_new", "v_new"), got, want):
                assert_close(f"{name} {rows} rows pos {pos} {what}", g, w,
                             STEP_ATOL, STEP_RTOL)
            e = max(max_err(g, w) for g, w in zip(got, want))
            err = max(err, e)
            log(f"kernel {name} {rows} rows pos {pos}: max_abs_err {e:.3g}")
        return err

    err = gate((x, sk, sv, ck, cv))
    pos = T - 1
    ms = cuda_ms(lambda: fs.fused_decoder_layers_step_v2(
        stacked, cfg, x, sk, sv, ck, cv, pos))
    plain = plain_ms(lambda: fs.fused_decoder_layers_step_v2_plain(
        stacked, cfg, x, sk, sv, ck, cv, pos))
    nbytes, flops = step_bound(cfg, batch, pos, quantize)
    entry.add(1, err, ms, plain, None, nbytes, flops)
    log(f"kernel {name}: caches {tuple(sk.shape)} pos {pos} "
        f"max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
        f"bound_ms {bound_ms(nbytes, flops):.4f} "
        f"({bound_by(nbytes, flops)}) library_ms null")
    step_more(entry, name, cfg, batch, quantize, gate(one),
              lambda rows_pos: fs.fused_decoder_layers_step_v2(
                  stacked, cfg, *(one if rows_pos[0] == 1 else
                                  (x, sk, sv, ck, cv)), rows_pos[1]))
    return entry


def step_positions(cfg):
    """The slots a decoder step is held at: the first, a middle, the
    last."""
    T = cfg.max_seq_len
    return (0, T // 2 - 1, T - 1)


def first_row(x, *caches):
    """The first batch row of a step's x (B, D) and caches (L, B, ...), as
    contiguous tensors of their own (made before any timing)."""
    return (x[:1].contiguous(), *(c[:, :1].contiguous() for c in caches))


def step_bound(cfg, rows, pos, quantize):
    """(bytes, flops) of one decoder step (B1 or B11) for ``rows`` rows at
    slot ``pos``: the weights once, each row's cross K/V and cache prefix,
    x in, x_out and the fresh K/V rows out (self caches of kvd lanes: D,
    or one KV head's under MQA); two flops a weight a row and the
    attention's four a query head's element of a slot."""
    L, D = cfg.num_decoder_layers, cfg.d_model
    L_enc, kvd = cfg.encoder_len, cfg.kv_dim
    nbytes, weights = step_weight_bytes(cfg, quantize)
    nbytes += (2 * L * rows * L_enc * D * 2
               + 2 * L * rows * pos * kvd * 2 + rows * D * 2  # caches, x
               + rows * D * 4 + 2 * L * rows * kvd * 2)       # outputs
    flops = (2 * rows * weights
             + 4 * L * rows * D * (pos + 1 + L_enc))          # attention
    return nbytes, flops


def step_more(entry, name, cfg, batch, quantize, err1, call):
    """The decoder step kernel at one row (``predict_single``), already
    gated with largest error ``err1``, and at the earlier slots of the
    batch, into ``entry``: the one row's time and bound at the last slot
    (``ms_rows1``, ``bound_ms_rows1``, ``max_abs_err_rows1``), the batch's
    time and bound at each gated slot (``ms_by_pos``, ``bound_ms_by_pos``),
    and the cluster shape of both launches
    (``ops/fused_step.cluster_geometry``). ``call((rows, pos))`` launches
    the kernel on the first row or the batch."""
    import torch

    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    T, last = cfg.max_seq_len, cfg.max_seq_len - 1
    cluster = {}
    for rows in (batch, 1):
        cluster[rows] = fs.cluster_geometry("fused_step", cfg, rows, T,
                                            cfg.encoder_len, torch.bfloat16,
                                            quantize)
        log(f"kernel {name}: {rows} rows, cluster shape {cluster[rows]}")
    ms1 = cuda_ms(lambda: call((1, last)))
    nbytes, flops = step_bound(cfg, 1, last, quantize)
    entry.d["ms_rows1"] = ms1
    entry.d["bound_ms_rows1"] = bound_ms(nbytes, flops)
    entry.d["max_abs_err_rows1"] = err1
    entry.d["cluster"] = cluster[batch]
    entry.d["cluster_rows1"] = cluster[1]
    log(f"kernel {name}: 1 row pos {last} ms {ms1:.4f} bound_ms "
        f"{bound_ms(nbytes, flops):.4f} max_abs_err {err1:.3g} "
        f"({batch} rows: {entry.d['ms']:.4f})")
    by_pos, bound_by_pos = {}, {}
    for pos in step_positions(cfg):
        by_pos[pos] = (entry.d["ms"] if pos == last
                       else cuda_ms(lambda: call((batch, pos))))
        bound_by_pos[pos] = bound_ms(*step_bound(cfg, batch, pos, quantize))
        log(f"kernel {name}: {batch} rows pos {pos} ms {by_pos[pos]:.4f} "
            f"bound_ms {bound_by_pos[pos]:.4f}")
    entry.d["ms_by_pos"] = by_pos
    entry.d["bound_ms_by_pos"] = bound_by_pos


def step_weight_bytes(cfg, quantize):
    """(bytes of the stacked layer weights a decoder step reads once: bf16,
    or int8 with their float32 scales; plus the float32 biases and
    LayerNorm tables, and the weights' element count)."""
    L, D, F = cfg.num_decoder_layers, cfg.d_model, cfg.dim_feedforward
    qkv = D + 2 * cfg.kv_dim                       # the packed qkv columns
    weights = L * (D * qkv + 3 * D * D + 2 * D * F)
    cols = L * (qkv + 3 * D + F + D)               # output columns
    small = (cols + 6 * L * D) * 4                 # biases, LN (f32)
    if quantize:
        return weights + cols * 4 + small, weights
    return weights * 2 + small, weights


def check_swin_block(cfg, np_params, params, batch):
    """Phase 3: the whole-block kernel against its plain version at every
    stage the route fuses, unshifted and shifted, at one image
    (``predict_single``) and at the bucket, with its launch geometry; timed
    at both, beside the plain version and the unfused block of the default
    route (layer norm, cuBLAS, window attention and GELU)."""
    import torch

    from handwritten_math_ocr_api_torch.models import swin
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
    entry.d["unfused_ms"] = 0.0
    entry.d["ms_batch1"] = 0.0
    # the engine's bundle: the blocks' four biases in float32
    encoder = sb.with_float32_biases(np_params["encoder"], params["encoder"])
    for i, (h, w, c, nh, depth, ph, pw) in enumerate(stage_shapes(cfg,
                                                                  batch)):
        hid = int(c * sc.mlp_ratio)
        if not sb.fits_vmem(c, ws, pw, hid):
            continue
        p = encoder["stages"][i]["blocks"][-1]
        err, times = 0.0, {}
        for n in (1, batch):
            geo = sb.block_geometry(n, h, w, c, nh, hid, ws, dev)
            log(f"kernel swin_block stage {i + 1} batch {n} geometry: "
                + " ".join(f"{k} {v}" for k, v in geo.items()))
            x = torch.randn(n, h, w, c, generator=gen, device=dev).to(
                torch.bfloat16)
            for shift in (0, ws // 2):
                got = sb.fused_swin_block(p, x, ws, shift, nh)
                want = sb.fused_swin_block_plain(p, x, ws, shift, nh)
                torch.cuda.synchronize()
                assert_close(f"swin_block stage {i + 1} batch {n} shift "
                             f"{shift}", got, want)
                err = max(err, max_err(got, want))
            times[n] = cuda_ms(lambda: sb.fused_swin_block(p, x, ws, ws // 2,
                                                           nh))
        ms = times[batch]
        plain = plain_ms(lambda: sb.fused_swin_block_plain(p, x, ws, ws // 2,
                                                          nh))
        # the default route's block: several calls, one of them B2
        blk = params["encoder"]["stages"][i]["blocks"][-1]
        unfused = cuda_ms(lambda: swin.swin_block(
            blk, x, ws, ws // 2, nh, kernels=True, use_pallas_block=False))
        entry.d["unfused_ms"] += depth * unfused
        entry.d["ms_batch1"] += depth * times[1]
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
            f"max_abs_err {err:.3g} (batch 1 and {batch}) ms {ms:.4f} "
            f"ms_batch1 {times[1]:.4f} plain_ms {plain:.4f} unfused_ms "
            f"{unfused:.4f} bound_ms {bound_ms(nbytes, flops):.4f} "
            f"({bound_by(nbytes, flops)}) library_ms null x{depth}")
    d = entry.d
    log(f"kernel swin_block: one encode ms {d['ms']:.4f} (batch 1 "
        f"{d['ms_batch1']:.4f}) unfused_ms {d['unfused_ms']:.4f} plain_ms "
        f"{d['plain_ms']:.4f} bound_ms {d['bound_ms']:.4f}")
    return entry


def ragged_bound(cfg, rows, pos, quantize):
    """(bytes, bf16 flops, float32 flops) of one ragged step for ``rows``
    rows at slot ``pos``: the weights and the float32 head once, each row's
    cross K/V and cache prefix, prev and pos, the embedding rows, the
    logits and fresh K/V rows out (self caches of kvd lanes)."""
    L, D = cfg.num_decoder_layers, cfg.d_model
    L_enc, V, kvd = cfg.encoder_len, cfg.vocab_size, cfg.kv_dim
    nbytes, weights = step_weight_bytes(cfg, quantize)
    nbytes += ((D * V + V) * 4                             # head (f32)
               + 2 * rows * 4 + 2 * rows * D * 4           # prev, pos, rows
               + 2 * L * rows * L_enc * D * 2              # cross K/V
               + 2 * L * rows * pos * kvd * 2              # cache prefix
               + rows * V * 4 + 2 * L * rows * kvd * 2)    # outputs
    flops = 2 * rows * weights + 4 * L * rows * D * (pos + 1 + L_enc)
    return nbytes, flops, 2 * rows * D * V                 # the head


def check_ragged_step(cfg, np_params, rows, batch, quantize=False):
    """Phase 3: the ragged step (B7, on the cluster layer code) against its
    plain version at the beam's rows (10 images x beam 5) at uniform pos
    0, 74 and 149 and at a ragged position vector, and at the greedy
    bucket's rows at pos 149 and a ragged vector, in both head modes, on
    both entries of the bundle (bf16 and float32): bf16 within the decoder
    step's tolerance, and in float32 its argmax equal to the plain
    version's. With ``quantize``, the int8 bundle (its int8 entries):
    float32 within the bf16 tolerance too, and the argmax equal wherever
    the plain logits' top two lie further apart than twice the largest
    logits error. Then one launch at the beam's rows with a row whose
    position lies past the cache and one whose token lies past the
    vocabulary: NaN outputs and nxt -1 in those two, every other row as
    the plain step gives it. The cluster shape at both row counts; times
    at the beam's rows at pos 0, 74 and 149 and at the bucket at 149."""
    import torch

    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    dev = torch.device(DEVICE)
    mqa = "_mqa" if cfg.kv_heads != cfg.nhead else ""
    name = f"ragged_step{mqa}_int8" if quantize else f"ragged_step{mqa}"
    entry = Entry(name, "handwritten_math_ocr_api_torch/csrc/"
                  "ragged_step.cu",
                  "handwritten_math_ocr_api_tpu/ops/fused_step.py:1220",
                  f"one launch (embedding, all decoder layers, head logits) "
                  f"for {rows} rows at the last slot (pos = T - 1)")
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    L_enc, V, kvd = cfg.encoder_len, cfg.vocab_size, cfg.kv_dim
    err, timed = 0.0, {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(dtype=dtype)
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dt)

        stacked = fs.build_stacked_full(np_params["decoder"], c, dev)
        if quantize:
            stacked = fs.quantize_stacked(stacked)
        tol = ((STEP_ATOL, STEP_RTOL) if dtype == "bfloat16" or quantize
               else (F32_STEP_ATOL, F32_STEP_ATOL))
        for n, slots in ((rows, (0, T // 2 - 1, T - 1)), (batch, (T - 1,))):
            sk, sv = randn(L, n, T, kvd), randn(L, n, T, kvd)
            ck, cv = randn(L, n, L_enc, D), randn(L, n, L_enc, D)
            prev = torch.randint(0, V, (n,), generator=gen, device=dev,
                                 dtype=torch.int32)
            cases = {f"pos {p}": torch.full((n,), p, dtype=torch.int32,
                                            device=dev) for p in slots}
            cases["ragged"] = torch.randint(0, T, (n,), generator=gen,
                                            device=dev, dtype=torch.int32)
            for case, pos in cases.items():
                for logits in (True, False):
                    got = fs.fused_ragged_step(stacked, c, prev, pos, sk, sv,
                                               ck, cv, return_logits=logits)
                    want = fs.fused_ragged_step_plain(
                        stacked, c, prev, pos, sk, sv, ck, cv,
                        return_logits=logits)
                    torch.cuda.synchronize()
                    what = f"{name} {dtype} {n} rows {case} logits {logits}"
                    if logits:
                        plain_logits = want[0]
                        logit_err = max_err(got[0], want[0])
                    else:
                        agree = (got[0] == want[0]).float().mean().item()
                        log(f"kernel {what}: argmax agrees {agree:.4f}")
                        differ = got[0] != want[0]
                        if dtype == "float32" and quantize and agree < 1.0:
                            top2 = plain_logits.topk(2, dim=-1).values
                            margin = top2[:, 0] - top2[:, 1]
                            log(f"kernel {what}: plain top-2 margin where "
                                f"the argmax differs "
                                f"{margin[differ].max():.3g}, logits "
                                f"max_abs_err {logit_err:.3g}")
                            differ &= margin > 2 * logit_err  # no near-tie
                        if dtype == "float32" and bool(differ.any()):
                            raise AssertionError(f"{what}: argmax differs")
                        got, want = got[1:], want[1:]
                    for g, w in zip(got, want):
                        assert_close(what, g, w, *tol)
                    e = max(max_err(g, w) for g, w in zip(got, want))
                    if dtype == "bfloat16":
                        err = max(err, e)
                    log(f"kernel {what}: max_abs_err {e:.3g}")
            if dtype == "bfloat16":
                timed[n] = (stacked, c, prev, cases, sk, sv, ck, cv)
            if n == rows:
                check_ragged_dead_rows(name, fs, stacked, c, prev,
                                       cases[f"pos {T - 1}"],
                                       (sk, sv, ck, cv), tol,
                                       dtype == "float32" and not quantize)
    for n in (rows, batch):
        entry.d["cluster" if n == rows else f"cluster_rows{n}"] = geo = (
            fs.cluster_geometry("ragged_step", cfg, n, T, L_enc,
                                torch.bfloat16, quantize, V))
        log(f"kernel {name}: {n} rows, cluster shape {geo}")

    def call(n, p):
        st, c, prev, cases, *caches = timed[n]
        return fs.fused_ragged_step(st, c, prev, cases[f"pos {p}"], *caches,
                                    return_logits=True)

    by_pos, bound_by_pos = {}, {}
    for p in (0, T // 2 - 1, T - 1):
        by_pos[p] = cuda_ms(lambda: call(rows, p))
        bound_by_pos[p] = bound_ms(*ragged_bound(cfg, rows, p, quantize))
        log(f"kernel {name}: {rows} rows pos {p} ms {by_pos[p]:.4f} "
            f"bound_ms {bound_by_pos[p]:.4f}")
    pos = T - 1
    ms = by_pos[pos]
    st, c, prev, cases, *caches = timed[rows]
    plain = plain_ms(lambda: fs.fused_ragged_step_plain(
        st, c, prev, cases[f"pos {pos}"], *caches, return_logits=True))
    nbytes, flops, f32_flops = ragged_bound(cfg, rows, pos, quantize)
    entry.add(1, err, ms, plain, None, nbytes, flops, f32_flops)
    entry.d["ms_by_pos"] = by_pos
    entry.d["bound_ms_by_pos"] = bound_by_pos
    ms_b = cuda_ms(lambda: call(batch, pos))
    entry.d[f"ms_rows{batch}"] = ms_b
    entry.d[f"bound_ms_rows{batch}"] = bound_ms(
        *ragged_bound(cfg, batch, pos, quantize))
    log(f"kernel {name}: caches {tuple(caches[0].shape)} pos {pos} "
        f"max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
        f"bound_ms {bound_ms(nbytes, flops, f32_flops):.4f} "
        f"({bound_by(nbytes, flops, f32_flops)}) library_ms null; "
        f"{batch} rows ms {ms_b:.4f} bound_ms "
        f"{entry.d[f'bound_ms_rows{batch}']:.4f}")
    return entry


def check_ragged_dead_rows(name, fs, stacked, cfg, prev, pos, caches, tol,
                           exact_argmax):
    """One ragged step with row 1's position past the cache and row 3's
    token past the vocabulary, in both head modes: NaN logits, log-prob
    and fresh rows and nxt -1 in those rows, every other row within
    ``tol`` of the plain step on the rows as they were (its argmax equal
    where ``exact_argmax``)."""
    import torch

    T, V = cfg.max_seq_len, cfg.vocab_size
    bad_pos, bad_prev = pos.clone(), prev.clone()
    bad_pos[1], bad_prev[3] = T, V
    dead = torch.zeros_like(pos, dtype=torch.bool)
    dead[1] = dead[3] = True
    for logits in (True, False):
        got = fs.fused_ragged_step(stacked, cfg, bad_prev, bad_pos, *caches,
                                   return_logits=logits)
        want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                          return_logits=logits)
        torch.cuda.synchronize()
        what = f"{name} {cfg.dtype} rows out of range logits {logits}"
        if not logits:
            if got[0][dead].tolist() != [-1, -1] or (
                    exact_argmax and not torch.equal(got[0][~dead],
                                                     want[0][~dead])):
                raise AssertionError(f"{what}: nxt {got[0].tolist()}")
            got, want = got[1:], want[1:]
        for g, w in zip(got, want):
            at = dead if g.dim() < 3 else (slice(None), dead)
            live = ~dead if g.dim() < 3 else (slice(None), ~dead)
            if not torch.isnan(g[at].float()).all():
                raise AssertionError(f"{what}: a dead row's output is not "
                                     f"NaN")
            assert_close(what, g[live], w[live], *tol)
        log(f"kernel {what}: NaN and nxt -1 in the two rows, the other "
            f"rows within the step tolerance")


# continuous batching's fused pool: 32 slots and the scratch slot, padded
# to the ragged step's 16-row chunks, and its segment ring of
# max_segment_steps rows
CONT_SLOTS = 32
CONT_POOL = 48
CONT_SEGMENT_STEPS = 16
CONT_RING = 64


def check_ragged_ring(cfg, np_params, pool, quantize=False):
    """Phase 3: B7's ring entries (continuous batching's fused segments) at
    the pool's ``pool`` rows against the plain ring step, bf16 and float32
    (int8: the bf16 tolerance in both, and the float32 argmax equal where
    the plain logits' top two lie further apart than twice the largest
    logits error; else equal in float32): segment starts at 0, pos and
    pos - (S - 1) in turn over random slots, and every row at slot 149
    with its segment from 86; the first n_chunks 16-row chunks, n_chunks
    1, 2 and 3, with and without the ring (bf16); one launch with a row whose
    segment starts past its slot and one S slots before it (NaN and nxt -1
    there only). Times at slot 149 and start 86: the ring entry beside the
    non-ring one on the same rows and slot (the same bytes: the ring holds
    the slots the cache holds without it), and the ring entry at
    n_chunks 1 and 3 with each one's cluster geometry."""
    import torch

    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    dev = torch.device(DEVICE)
    S = CONT_RING
    mqa = "_mqa" if cfg.kv_heads != cfg.nhead else ""
    name = f"ragged_ring{mqa}" + ("_int8" if quantize else "")
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    L_enc, V, kvd = cfg.encoder_len, cfg.vocab_size, cfg.kv_dim
    entry = Entry(name, "handwritten_math_ocr_api_torch/csrc/ragged_ring.cu",
                  "handwritten_math_ocr_api_tpu/ops/fused_step.py:1220",
                  f"one launch (embedding, all decoder layers, head logits) "
                  f"for {pool} rows at slot {T - 1}, segment start "
                  f"{T - S}: {T - S} cache slots and {S - 1} ring rows")
    err, timed = 0.0, None
    i32 = torch.int32
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(dtype=dtype)
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dt)

        stacked = fs.build_stacked_full(np_params["decoder"], c, dev)
        if quantize:
            stacked = fs.quantize_stacked(stacked)
        tol = ((STEP_ATOL, STEP_RTOL) if dtype == "bfloat16" or quantize
               else (F32_STEP_ATOL, F32_STEP_ATOL))
        caches = (randn(L, pool, T, kvd), randn(L, pool, T, kvd),
                  randn(L, pool, L_enc, D), randn(L, pool, L_enc, D))
        rk, rv = randn(L, pool, S, kvd), randn(L, pool, S, kvd)
        prev = torch.randint(0, V, (pool,), generator=gen, device=dev,
                             dtype=i32)
        pos = torch.randint(0, T, (pool,), generator=gen, device=dev,
                            dtype=i32)
        kind = torch.arange(pool, device=dev) % 3
        pos = torch.where(kind == 0, pos % S, pos)
        seg = torch.where(kind == 0, 0, torch.where(kind == 1, pos,
                                                    pos - (S - 1)))
        cases = {"mixed": (pos, seg.clamp(min=0).to(i32)),
                 f"pos {T - 1} seg {T - S}": (
                     torch.full((pool,), T - 1, dtype=i32, device=dev),
                     torch.full((pool,), T - S, dtype=i32, device=dev))}

        def both(p, g, **kw):
            ring = {"seg_start": g, "ring_k": rk, "ring_v": rv, **kw}
            return (fs.fused_ragged_step(stacked, c, prev, p, *caches,
                                         **ring),
                    fs.fused_ragged_step_plain(stacked, c, prev, p, *caches,
                                               **ring))

        for case, (p, g) in cases.items():
            for logits in (True, False):
                got, want = both(p, g, return_logits=logits)
                torch.cuda.synchronize()
                what = f"{name} {dtype} {pool} rows {case} logits {logits}"
                if logits:
                    plain_logits, logit_err = want[0], max_err(got[0],
                                                               want[0])
                else:
                    differ = got[0] != want[0]
                    log(f"kernel {what}: argmax agrees "
                        f"{1 - differ.float().mean().item():.4f}")
                    if quantize:  # no near-tie
                        differ &= margin_of(plain_logits) > 2 * logit_err
                    if dtype == "float32" and bool(differ.any()):
                        raise AssertionError(f"{what}: argmax differs")
                    got, want = got[1:], want[1:]
                for g_, w_ in zip(got, want):
                    assert_close(what, g_, w_, *tol)
                e = max(max_err(g_, w_) for g_, w_ in zip(got, want))
                if dtype == "bfloat16":
                    err = max(err, e)
                log(f"kernel {what}: max_abs_err {e:.3g}")
        p, g = cases["mixed"]
        for nc in (1, 2, 3) if dtype == "bfloat16" else ():
            for ring in (True, False):
                kw = ({"seg_start": g, "ring_k": rk, "ring_v": rv} if ring
                      else {})
                run = 16 * nc
                got = fs.fused_ragged_step(stacked, c, prev, p, *caches,
                                           n_chunks=nc, return_logits=True,
                                           **kw)
                want = fs.fused_ragged_step_plain(
                    stacked, c, prev, p, *caches, n_chunks=nc,
                    return_logits=True, **kw)
                torch.cuda.synchronize()
                what = f"{name} {dtype} n_chunks {nc} ring {ring}"
                assert_close(what, got[0][:run], want[0][:run], *tol)
                for g_, w_ in zip(got[1:], want[1:]):
                    assert_close(what, g_[:, :run], w_[:, :run], *tol)
                log(f"kernel {what}: the first {run} rows within the step "
                    f"tolerance")
        # dead rows: row 1's segment starts past its slot, row 3's S slots
        # before it
        bad, good = g.clone(), g.clone()
        bad[1], good[1] = p[1] + 1, p[1]
        p3 = p.clone()
        p3[3] = T - 1
        bad[3], good[3] = T - 1 - S, T - 1
        dead = torch.zeros(pool, dtype=torch.bool, device=dev)
        dead[1] = dead[3] = True
        for logits in (True, False):
            got = fs.fused_ragged_step(stacked, c, prev, p3, *caches,
                                       seg_start=bad, ring_k=rk, ring_v=rv,
                                       return_logits=logits)
            want = fs.fused_ragged_step_plain(
                stacked, c, prev, p3, *caches, seg_start=good, ring_k=rk,
                ring_v=rv, return_logits=logits)
            torch.cuda.synchronize()
            what = f"{name} {dtype} segment starts out of range"
            if not logits:
                if got[0][dead].tolist() != [-1, -1]:
                    raise AssertionError(f"{what}: nxt {got[0].tolist()}")
                got, want = got[1:], want[1:]
            for g_, w_ in zip(got, want):
                at = dead if g_.dim() < 3 else (slice(None), dead)
                live = ~dead if g_.dim() < 3 else (slice(None), ~dead)
                if not torch.isnan(g_[at].float()).all():
                    raise AssertionError(f"{what}: a dead row's output is "
                                         f"not NaN")
                assert_close(what, g_[live], w_[live], *tol)
        log(f"kernel {name} {dtype}: NaN and nxt -1 in the two rows whose "
            f"segment starts out of range, the others within the step "
            f"tolerance")
        if dtype == "bfloat16":
            timed = (stacked, c, prev, caches, rk, rv,
                     *cases[f"pos {T - 1} seg {T - S}"])
    stacked, c, prev, caches, rk, rv, p, g = timed
    ring = {"seg_start": g, "ring_k": rk, "ring_v": rv}
    ms = cuda_ms(lambda: fs.fused_ragged_step(stacked, c, prev, p, *caches,
                                              return_logits=True, **ring))
    ms_flat = cuda_ms(lambda: fs.fused_ragged_step(
        stacked, c, prev, p, *caches, return_logits=True))
    plain = plain_ms(lambda: fs.fused_ragged_step_plain(
        stacked, c, prev, p, *caches, return_logits=True, **ring))
    nbytes, flops, f32_flops = ragged_bound(cfg, pool, T - 1, quantize)
    nbytes += pool * 4                                     # seg_start
    entry.add(1, err, ms, plain, None, nbytes, flops, f32_flops)
    entry.d["ms_no_ring"] = ms_flat
    entry.d["cluster"] = fs.cluster_geometry(
        "ragged_step", cfg, pool, T, L_enc, torch.bfloat16, quantize, V)
    for nc in (1, 3):
        run = 16 * nc
        entry.d[f"ms_n_chunks{nc}"] = cuda_ms(lambda: fs.fused_ragged_step(
            stacked, c, prev, p, *caches, n_chunks=nc, return_logits=True,
            **ring))
        entry.d[f"bound_ms_n_chunks{nc}"] = bound_ms(
            *ragged_bound(cfg, run, T - 1, quantize))
        entry.d[f"cluster_n_chunks{nc}"] = geo = fs.cluster_geometry(
            "ragged_step", cfg, run, T, L_enc, torch.bfloat16, quantize, V)
        log(f"kernel {name}: n_chunks {nc} ({run} of {pool} rows) ms "
            f"{entry.d[f'ms_n_chunks{nc}']:.4f} bound_ms "
            f"{entry.d[f'bound_ms_n_chunks{nc}']:.4f} cluster shape {geo}")
    log(f"kernel {name}: {pool} rows pos {T - 1} seg {T - S} max_abs_err "
        f"{err:.3g} ms {ms:.4f} (without the ring, the same rows and slot: "
        f"{ms_flat:.4f}) plain_ms {plain:.4f} bound_ms "
        f"{bound_ms(nbytes, flops, f32_flops):.4f} "
        f"({bound_by(nbytes, flops, f32_flops)}) library_ms null; cluster "
        f"shape {entry.d['cluster']}")
    return entry


def check_dequant_matmul(cfg, np_params, batch, rows):
    """Phase 3: the int8 dequant matmul against its plain version at every
    shape the default int8 route gives it: the six projections of a
    decoder layer (the cross q a column slice of the packed matrix) and
    the float32 head at the greedy bucket and the beam's rows, and the
    cross K/V projection (a column slice) of the encoder memory at both."""
    import torch

    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.ops import quant

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    L, D, L_enc = cfg.num_decoder_layers, cfg.d_model, cfg.encoder_len
    dec = convert.to_torch(
        {"decoder": quant.quantize_decoder_params(np_params["decoder"])},
        cfg, dev)["decoder"]
    sa, ca = dec["layers"][0]["self_attn"], dec["layers"][0]["cross_attn"]
    ffn = dec["layers"][0]["ffn"]
    layer = [("qkv", sa["w_qkv_q"], sa["w_qkv_scale"]),
             ("out", sa["w_out_q"], sa["w_out_scale"]),
             ("cross q", ca["w_qkv_q"][:, :D], ca["w_qkv_scale"][:D]),
             ("cross out", ca["w_out_q"], ca["w_out_scale"]),
             ("fc1", ffn["fc1"]["w_q"], ffn["fc1"]["w_scale"]),
             ("fc2", ffn["fc2"]["w_q"], ffn["fc2"]["w_scale"])]
    head = ("head", dec["fc_out"]["w_q"], dec["fc_out"]["w_scale"])
    cross_k = ("cross k", ca["w_qkv_q"][:, D:2 * D],
               ca["w_qkv_scale"][D:2 * D])
    entry = Entry("dequant_matmul", "handwritten_math_ocr_api_torch/csrc/"
                  "dequant_matmul.cu",
                  "handwritten_math_ocr_api_tpu/ops/quant.py:79",
                  f"one greedy decode step at the {batch}-row bucket: "
                  f"{L} layers x {len(layer)} projections and the float32 "
                  f"head")
    entry.d["library"] = ("torch._weight_int8pack_mm on an (N, K) int8 "
                          "copy of the weight made before the timing; "
                          "cublas_ms beside it: torch.matmul of x with the "
                          "weight dequantized to x's dtype beforehand, not "
                          "the same function (no int8 load)")
    entry.d["cublas_ms"] = 0.0
    entry.d["by_shape"] = []
    cases = [(*w, M, torch.bfloat16) for M in (batch, rows) for w in layer]
    cases += [(*head, M, torch.float32) for M in (batch, rows)]
    cases += [(*cross_k, M * L_enc, torch.bfloat16) for M in (batch, rows)]
    for name, w_q, scale, M, dt in cases:
        K, N = w_q.shape
        x = torch.randn(M, K, generator=gen, device=dev).to(dt)
        got = quant.dequant_matmul(x, w_q, scale)
        want = quant.dequant_matmul_plain(x, w_q, scale)
        torch.cuda.synchronize()
        f32 = dt == torch.float32
        tol = (F32_STEP_ATOL, F32_STEP_ATOL) if f32 else (KERNEL_ATOL,
                                                          KERNEL_RTOL)
        assert_close(f"dequant_matmul {name} M {M}", got, want, *tol)
        err = max_err(got, want)
        w_deq = (w_q.float() * scale).to(dt)
        ms = cuda_ms(lambda: quant.dequant_matmul(x, w_q, scale))
        plain = plain_ms(lambda: quant.dequant_matmul_plain(x, w_q, scale))
        cublas = cuda_ms(lambda: torch.matmul(x, w_deq))
        lib, lib_note = int8pack_ms(x, w_q, scale, want)
        esz = x.element_size()
        nbytes = M * K * esz + K * N + N * 4 + M * N * esz
        flops = 2 * M * K * N
        ops = (0.0, flops) if f32 else (flops, 0.0)
        if M == batch:
            times = 1 if name == "head" else L
            entry.add(times, err, ms, plain, lib, nbytes, *ops)
            entry.d["cublas_ms"] += times * cublas
        entry.d["by_shape"].append({
            "shape": name, "M": M, "K": K, "N": N, "ldw": w_q.stride(0),
            "dtype": str(dt)[6:], "ms": ms, "matmul_ms": cublas,
            "int8pack_ms": lib, "bound_ms": bound_ms(nbytes, *ops),
            "max_abs_err": err})
        log(f"kernel dequant_matmul {name}: x {tuple(x.shape)} "
            f"{str(dt)[6:]} w {tuple(w_q.shape)} (row stride "
            f"{w_q.stride(0)}) max_abs_err {err:.3g} ms {ms:.4f} "
            f"plain_ms {plain:.4f} matmul_ms {cublas:.4f} "
            f"int8pack_ms {lib_note} "
            f"bound_ms {bound_ms(nbytes, *ops):.5f} "
            f"({bound_by(nbytes, *ops)})")
    log(f"kernel dequant_matmul: a {batch}-row step ({L} layers x "
        f"{len(layer)} and the head) ms {entry.d['ms']:.4f}, matmul_ms "
        f"{entry.d['cublas_ms']:.4f}, int8pack_ms {entry.d['library_ms']}")
    return entry


def int8pack_ms(x, w_q, scale, want):
    """(ms, note) of ``torch._weight_int8pack_mm``, PyTorch's weight-only
    int8 matmul, on x and an (N, K) copy of the int8 weight made before the
    timing, with the float32 scales (or, if it refuses those, the scales
    in x's dtype, noted); (None, why) where it raises."""
    import torch

    w_t = w_q.t().contiguous()
    for sc in (scale, scale.to(x.dtype)):
        try:
            err = max_err(torch._weight_int8pack_mm(x, w_t, sc), want)
        except (RuntimeError, NotImplementedError) as e:
            why = f"{type(e).__name__}: {str(e).splitlines()[0][:80]}"
            continue
        ms = cuda_ms(lambda: torch._weight_int8pack_mm(x, w_t, sc))
        return ms, (f"{ms:.4f} (scales {str(sc.dtype)[6:]}, max_abs_err "
                    f"{err:.3g})")
    return None, f"null (raised {why})"


def check_beam_reorder(cfg, rows):
    """Phase 3: the beam cache reorder against its plain version at the
    beam's rows, over the whole cache and over a prefix, fresh and into a
    preallocated pair: exactly equal. Its time is the kernel's alone (the
    C entry called directly); the wrapper's call, which first reads the
    range of ``src`` back to the host, is timed beside it."""
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
    plain = plain_ms(lambda: br.beam_cache_gather_plain(sk, sv, src, T))
    idx = src.long()
    lib = cuda_ms(lambda: (sk.index_select(1, idx), sv.index_select(1, idx)))
    nbytes = 2 * 2 * L * rows * T * D * 2 + rows * 4
    entry.add(1, 0.0, ms, plain, lib, nbytes, 0.0)
    log(f"kernel beam_cache_gather: caches {tuple(sk.shape)} t_ext {T} "
        f"exact; ms {ms:.4f} (the wrapper's call, with the device work of "
        f"its check of src: {wrapped:.4f}) plain_ms {plain:.4f} "
        f"index_select_ms "
        f"{lib:.4f} (two calls) bound_ms {bound_ms(nbytes, 0.0):.4f}")
    return entry


def check_layers_step(cfg, np_params, batch):
    """Phase 3: the "v1" layer step (B11) against its plain version at the
    greedy bucket, bf16, at the first, a middle and the last slot: x_out
    and the written slot within the decoder step's tolerance, every other
    slot of the caches bit for bit unchanged."""
    import torch

    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    entry = Entry("layers_step_in_place", "handwritten_math_ocr_api_torch/"
                  "csrc/fused_step.cu",
                  "handwritten_math_ocr_api_tpu/ops/fused_step.py:896",
                  "one launch (all decoder layers, the fresh rows written "
                  "into the caches) at the last slot (pos = T - 1)")
    entry.d["library"] = "none (no single call)"
    stacked = fs.build_stacked(np_params["decoder"], cfg, dev)
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    L_enc = cfg.encoder_len
    sk, sv = randn(L, batch, T, D), randn(L, batch, T, D)
    ck, cv = randn(L, batch, L_enc, D), randn(L, batch, L_enc, D)
    x = randn(batch, D)
    one = first_row(x, sk, sv, ck, cv)

    def gate(inputs):
        """The kernel against its plain version at the first, a middle
        and the last slot, every other slot unchanged; the largest
        error."""
        x, sk, sv, ck, cv = inputs
        rows, err = x.shape[0], 0.0
        for pos in step_positions(cfg):
            got_k, got_v = sk.clone(), sv.clone()
            want_k, want_v = sk.clone(), sv.clone()
            got = fs.fused_decoder_layers_step(stacked, cfg, x, got_k, got_v,
                                               ck, cv, pos)
            want = fs.fused_decoder_layers_step_plain(stacked, cfg, x,
                                                      want_k, want_v, ck, cv,
                                                      pos)
            torch.cuda.synchronize()
            other = torch.arange(T, device=dev) != pos
            pairs = [("x_out", got[0], want[0])]
            for what, g, w, old in (("k", got_k, want_k, sk),
                                    ("v", got_v, want_v, sv)):
                pairs.append((f"cache {what} slot {pos}", g[:, :, pos],
                              w[:, :, pos]))
                if not torch.equal(g[:, :, other], old[:, :, other]):
                    raise AssertionError(
                        f"layers_step_in_place {rows} rows pos {pos}: it "
                        f"wrote {what} outside slot {pos}")
            for what, g, w in pairs:
                assert_close(f"layers_step_in_place {rows} rows pos {pos} "
                             f"{what}", g, w, STEP_ATOL, STEP_RTOL)
            e = max(max_err(g, w) for _, g, w in pairs)
            err = max(err, e)
            log(f"kernel layers_step_in_place {rows} rows pos {pos}: "
                f"max_abs_err {e:.3g}, other slots unchanged")
        return err

    err = gate((x, sk, sv, ck, cv))
    pos = T - 1
    ms = cuda_ms(lambda: fs.fused_decoder_layers_step(
        stacked, cfg, x, sk, sv, ck, cv, pos))
    plain = plain_ms(lambda: fs.fused_decoder_layers_step_plain(
        stacked, cfg, x, sk, sv, ck, cv, pos))
    nbytes, flops = step_bound(cfg, batch, pos, False)
    entry.add(1, err, ms, plain, None, nbytes, flops)
    log(f"kernel layers_step_in_place: caches {tuple(sk.shape)} pos {pos} "
        f"max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain:.4f} "
        f"bound_ms {bound_ms(nbytes, flops):.4f} "
        f"({bound_by(nbytes, flops)}) library_ms null")
    step_more(entry, "layers_step_in_place", cfg, batch, False, gate(one),
              lambda rows_pos: fs.fused_decoder_layers_step(
                  stacked, cfg, *(one if rows_pos[0] == 1 else
                                  (x, sk, sv, ck, cv)), rows_pos[1]))
    return entry


def margin_of(logits):
    """The top-2 margin of each row of float32 logits (..., V)."""
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def check_whole_step(cfg, np_params, batch):
    """Phase 3: the whole step of "v3"/"v4" (B10) against its plain version
    at the greedy bucket and at one row, bf16, in both cache layouts, at
    the first, a middle and the last slot: logp and the fresh rows within
    the decoder step's tolerance, nxt equal wherever the plain logits'
    top-2 margin exceeds it, and in the time-major layout every other slot
    bit for bit unchanged; the cluster shape of both row counts. The time
    is the time-major entry's ("v4", JAX's default) at the bucket; the
    batch-major one's and both at one row are printed beside it."""
    import torch

    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    entry = Entry("whole_step", "handwritten_math_ocr_api_torch/csrc/"
                  "whole_step.cu",
                  "handwritten_math_ocr_api_tpu/ops/fused_step.py:654",
                  "one launch (embedding, all decoder layers, float32 head "
                  "and argmax; time-major caches written in place) at the "
                  "last slot (pos = T - 1)")
    entry.d["library"] = "none (no single call)"
    stacked = fs.build_stacked_full(np_params["decoder"], cfg, dev)
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    L_enc, V = cfg.encoder_len, cfg.vocab_size

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    cluster = {}
    for rows in (batch, 1):
        cluster[rows] = fs.cluster_geometry("whole_step", cfg, rows, T,
                                            L_enc, torch.bfloat16, V=V)
        log(f"kernel whole_step: {rows} rows, cluster shape "
            f"{cluster[rows]}")
    ck, cv = randn(L, batch, L_enc, D), randn(L, batch, L_enc, D)
    prev = torch.randint(0, V, (batch,), generator=gen, device=dev,
                         dtype=torch.int32)

    def gate(time_major, prev, sk, sv, ck, cv):
        """Both entries against the plain step at the first, a middle and
        the last slot; the largest error."""
        rows, err = prev.shape[0], 0.0
        layout = "time-major" if time_major else "batch-major"
        for pos in step_positions(cfg):
            got_k, got_v = sk.clone(), sv.clone()
            want_k, want_v = sk.clone(), sv.clone()
            got = fs.fused_whole_step(stacked, cfg, prev, got_k, got_v, ck,
                                      cv, pos, time_major=time_major)
            want = fs.fused_whole_step_plain(stacked, cfg, prev, want_k,
                                             want_v, ck, cv, pos,
                                             time_major=time_major)
            view = ((want_k.transpose(1, 2), want_v.transpose(1, 2))
                    if time_major else (want_k, want_v))
            logits = fs.fused_ragged_step_plain(
                stacked, cfg, prev,
                torch.full((rows,), pos, dtype=torch.int32, device=dev),
                *view, ck, cv, return_logits=True)[0]
            torch.cuda.synchronize()
            what = f"whole_step {layout} {rows} rows pos {pos}"
            clear = margin_of(logits) > STEP_ATOL
            agree = (got[0] == want[0]).float().mean().item()
            if not torch.equal(got[0][clear], want[0][clear]):
                raise AssertionError(f"{what}: nxt differs where the plain "
                                     f"logits' top-2 margin exceeds "
                                     f"{STEP_ATOL}")
            pairs = [("logp", got[1], want[1])]
            if time_major:
                other = torch.arange(T, device=dev) != pos
                for name, g, w, old in (("k", got_k, want_k, sk),
                                        ("v", got_v, want_v, sv)):
                    pairs.append((f"cache {name} slot {pos}", g[:, pos],
                                  w[:, pos]))
                    if not torch.equal(g[:, other], old[:, other]):
                        raise AssertionError(f"{what}: it wrote {name} "
                                             f"outside slot {pos}")
            else:
                if not (torch.equal(got_k, sk) and torch.equal(got_v, sv)):
                    raise AssertionError(f"{what}: it wrote to the caches")
                pairs += [("k_new", got[2], want[2]),
                          ("v_new", got[3], want[3])]
            for name, g, w in pairs:
                assert_close(f"{what} {name}", g, w, STEP_ATOL, STEP_RTOL)
            e = max(max_err(g, w) for _, g, w in pairs)
            err = max(err, e)
            log(f"kernel {what}: nxt agrees {agree:.4f} (equal where the "
                f"margin exceeds {STEP_ATOL}), max_abs_err {e:.3g}")
        return err

    err, err1, timed, timed1 = 0.0, 0.0, {}, {}
    pos = T - 1
    for time_major in (True, False):
        shape = (L, T, batch, D) if time_major else (L, batch, T, D)
        sk, sv = randn(*shape), randn(*shape)
        one = (prev[:1].contiguous(),
               *((c[:, :, :1] if time_major else c[:, :1]).contiguous()
                 for c in (sk, sv)),
               ck[:, :1].contiguous(), cv[:, :1].contiguous())
        err = max(err, gate(time_major, prev, sk, sv, ck, cv))
        err1 = max(err1, gate(time_major, *one))
        timed[time_major] = cuda_ms(lambda: fs.fused_whole_step(
            stacked, cfg, prev, sk, sv, ck, cv, pos, time_major=time_major))
        timed1[time_major] = cuda_ms(lambda: fs.fused_whole_step(
            stacked, cfg, *one, pos, time_major=time_major))
        if time_major:
            plain = plain_ms(lambda: fs.fused_whole_step_plain(
                stacked, cfg, prev, sk, sv, ck, cv, pos, time_major=True))
    nbytes, weights = step_weight_bytes(cfg, False)
    nbytes += ((D * V + V) * 4 + batch * D * 4 + D * 4     # head, emb rows
               + batch * 4 + batch * 8                     # prev, nxt, logp
               + 2 * L * batch * L_enc * D * 2             # cross K/V
               + 2 * L * batch * pos * D * 2               # cache prefix
               + 2 * L * batch * D * 2)                    # fresh rows
    flops = 2 * batch * weights + 4 * L * batch * D * (pos + 1 + L_enc)
    f32_flops = 2 * batch * D * V
    entry.add(1, err, timed[True], plain, None, nbytes, flops, f32_flops)
    entry.d["ms_batch_major"] = timed[False]
    entry.d["ms_rows1"] = timed1[True]
    entry.d["ms_rows1_batch_major"] = timed1[False]
    entry.d["max_abs_err_rows1"] = err1
    entry.d["cluster"] = cluster[batch]
    entry.d["cluster_rows1"] = cluster[1]
    log(f"kernel whole_step: time-major caches ({L}, {T}, {batch}, {D}) pos "
        f"{pos} max_abs_err {err:.3g} ms {timed[True]:.4f} (batch-major "
        f"{timed[False]:.4f}; 1 row {timed1[True]:.4f}, batch-major "
        f"{timed1[False]:.4f}) plain_ms {plain:.4f} "
        f"bound_ms {bound_ms(nbytes, flops, f32_flops):.4f} "
        f"({bound_by(nbytes, flops, f32_flops)}) library_ms null")
    return entry


def hold_decode(name, got, want, logits):
    """A greedy decode against its plain version: each row's tokens equal
    up to its first difference, which must come where the plain logits'
    top-2 margin lies under STEP_ATOL (a near-tie: the kernel's logits may
    lie that far from the plain ones); rows that agree throughout have
    equal counts. Prints the agreement and each first difference; returns
    the largest log-prob sum error over the rows that agree throughout."""
    import torch

    flips, err = [], 0.0
    for r in range(got.tokens.shape[0]):
        differ = (got.tokens[r] != want.tokens[r]).nonzero()
        if len(differ):
            t = int(differ[0])
            flips.append((r, t, float(margin_of(logits[r, t]))))
        elif got.token_count[r] != want.token_count[r]:
            raise AssertionError(f"{name}: row {r} counts differ")
        else:
            err = max(err, abs(float(got.logprob_sum[r]
                                     - want.logprob_sum[r])))
    agree = (got.tokens == want.tokens).float().mean().item()
    log(f"{name}: tokens agree {agree:.4f} with the plain version; first "
        f"differences (row, step, plain top-2 margin) {flips}")
    bad = [f for f in flips if f[2] >= STEP_ATOL]
    if bad:
        raise AssertionError(f"{name}: tokens differ where the plain "
                             f"logits' margin is at least {STEP_ATOL}: {bad}")
    if not torch.isfinite(got.logprob_sum).all():
        raise AssertionError(f"{name}: log-prob sums are not finite")
    return err


def steps_per_row(tokens, eos_id):
    """The steps each row of a greedy decode runs: to its EOS step, or
    every step."""
    T = tokens.shape[1]
    return [row.index(eos_id) + 1 if eos_id in row else T
            for row in tokens.tolist()]


# the head bias of EOS raised for phase 3's EOS-boosted whole decodes: on
# the seeded weights and the numpy-seeded 16-row memory of
# check_whole_decode, rows end at different steps and some never (the
# float32 plain decode: EOS at steps 15, -, 0, 50, -, 139, 0, 7, 0, -, 70,
# 1, -, 7, 0, 123), so that each group of 2 rows holds a row that
# finishes while the other runs on
EOS_BOOST = 3.1


def mixed_groups(values, rows):
    """The groups of ``rows`` consecutive rows (a cluster kernel's row
    groups: ``cluster_geometry``'s "rows") whose ``values`` are not all
    equal; for the steps each row of a decode ran, the groups in which a
    row finished while another ran on."""
    return [g // rows for g in range(0, len(values), rows)
            if len(set(values[g:g + rows])) > 1]


def finishing(got, eos_id, pad_id):
    """Each row's EOS step (None for a row that never emits it), after
    checking that only PAD follows it, that its count is its non-EOS
    tokens (its EOS step, or T) and its length its non-PAD ones."""
    T, ends = got.tokens.shape[1], []
    for row, count, length in zip(got.tokens.tolist(),
                                  got.token_count.tolist(),
                                  got.lengths.tolist()):
        e = row.index(eos_id) if eos_id in row else None
        tail = row[e + 1:] if e is not None else []
        if (count != (T if e is None else e)
                or length != sum(t != pad_id for t in row)
                or tail != [pad_id] * len(tail)):
            raise AssertionError(f"whole decode row {row[:8]}...: EOS at "
                                 f"{e}, count {count}, length {length}")
        ends.append(e)
    return ends


def check_whole_decode(cfg, np_params, batch, quantize):
    """Phase 3: the whole decode (B12) against its plain version, bf16,
    over T steps from random encoder memory, with the resident bundle float
    or, with ``quantize``, int8, at the greedy bucket and at one row, and
    on an EOS-boosted bundle at the bucket whose rows end at different
    steps and some never, with a group (2 rows at the bucket) holding a
    row that finished beside one that ran on (PAD after EOS, counts and
    lengths checked): the tokens held by ``hold_decode``, the log-prob
    sums of the rows that agree within WHOLE_DECODE_LP_ATOL; the cluster
    shape of both row counts. Times are one whole decode's at the bucket
    (and at one row)."""
    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import EOS_ID, PAD_ID
    from handwritten_math_ocr_api_torch.ops import fused_step as fs
    from handwritten_math_ocr_api_torch.ops import whole_decode as wd

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    name = "whole_decode_int8" if quantize else "whole_decode"
    entry = Entry(name, "handwritten_math_ocr_api_torch/csrc/"
                  "whole_decode.cu",
                  "handwritten_math_ocr_api_tpu/ops/whole_decode.py:336",
                  f"one launch: a whole greedy decode of {batch} rows over "
                  f"T steps; bound with each input read once and each "
                  f"self-cache slot written once (the re-reads of the "
                  f"cache fit in L2 with the weights); plain_ms is the "
                  f"synchronized wall of one plain decode")
    entry.d["library"] = "none (no single call)"
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    L_enc, V = cfg.encoder_len, cfg.vocab_size
    dec = convert.to_torch({"decoder": np_params["decoder"]}, cfg,
                           dev)["decoder"]
    resident = wd.build_resident(dec, cfg, quantize)
    cluster = {}
    for rows in (batch, 1):
        cluster[rows] = fs.cluster_geometry("whole_decode", cfg, rows, T,
                                            L_enc, torch.bfloat16, quantize,
                                            V)
        log(f"kernel {name}: {rows} rows, cluster shape {cluster[rows]}")

    def gate(what, resident, memory):
        """The kernel's decode against the plain one's; (the kernel's
        output, the log-prob sum error, the plain decode's wall ms). The
        plain decode launches some 40,000 small kernels, and a profiled run
        of it costs tens of seconds of the host's time: its one reference
        run is timed by the synchronized wall clock instead."""
        got = wd.fused_whole_decode(resident, cfg, memory)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, logits = wd.fused_whole_decode_plain(resident, cfg, memory,
                                                   return_logits=True)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        if tuple(got.tokens.shape) != (memory.shape[0], T):
            raise AssertionError(f"{what}: tokens "
                                 f"{tuple(got.tokens.shape)}")
        finishing(got, EOS_ID, PAD_ID)
        err = hold_decode(f"kernel {what}", got, want, logits)
        if err > WHOLE_DECODE_LP_ATOL:
            raise AssertionError(f"{what}: log-prob sums differ by {err}")
        return got, err, plain

    memory = torch.randn(batch, L_enc, D, generator=gen, device=dev).to(
        torch.bfloat16)
    got, err, plain = gate(f"{name} {batch} rows", resident, memory)
    one = memory[:1].contiguous()
    _, err1, _ = gate(f"{name} 1 row", resident, one)
    boosted = dict(np_params["decoder"])
    bias = np.array(boosted["fc_out"]["b"], np.float32)
    bias[EOS_ID] += EOS_BOOST
    boosted["fc_out"] = {**boosted["fc_out"], "b": bias}
    eos_resident = wd.build_resident(convert.to_torch(
        {"decoder": boosted}, cfg, dev)["decoder"], cfg, quantize)
    eos_memory = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (batch, L_enc, D)).astype(np.float32)).to(dev, torch.bfloat16)
    eos_got, eos_err, _ = gate(f"{name} EOS-boosted {batch} rows",
                               eos_resident, eos_memory)
    ends = finishing(eos_got, EOS_ID, PAD_ID)
    group = cluster[batch]["rows"]
    mixed = mixed_groups(steps_per_row(eos_got.tokens, EOS_ID), group)
    log(f"kernel {name} EOS-boosted {batch} rows: EOS steps {ends}; "
        f"groups of {group} rows where a row finished beside a live one: "
        f"{mixed}")
    if None not in ends or len({e for e in ends if e is not None}) < 2:
        raise AssertionError(f"{name}: the EOS-boosted rows do not end at "
                             f"different steps with one live ({ends})")
    if group < 2 or not mixed:
        raise AssertionError(f"{name}: no group of the EOS-boosted decode "
                             f"holds a finished row beside a live one "
                             f"({group} rows a group, EOS steps {ends})")
    ms = cuda_ms(lambda: wd.fused_whole_decode(resident, cfg, memory),
                 iters=3, warmup=1)
    ms1 = cuda_ms(lambda: wd.fused_whole_decode(resident, cfg, one),
                  iters=3, warmup=1)
    nbytes, weights = step_weight_bytes(cfg, quantize)
    runs = steps_per_row(got.tokens, EOS_ID)
    steps = sum(runs)                                      # (row, step) pairs
    # step t of a row reads its t earlier K and V slots in every layer;
    # at most 2 L B T D bf16 (19.7 MB at 16 rows), they fit in the 50 MB
    # L2 with the weights, so the bound counts each slot written once and
    # the re-reads not at all
    slots = L * sum(n * (n - 1) // 2 for n in runs)
    reads = 2 * slots * D * 2
    nbytes += ((D * V + V) * 4                             # head (f32)
               + (V + T) * D * 4                           # emb tables
               + 2 * L * batch * L_enc * D * 2             # cross K/V
               + steps * 2 * L * D * 2                     # cache writes
               + batch * T * 4 + batch * 8)                # outputs
    attended = slots + steps * L * (1 + L_enc)
    flops = 2 * steps * weights + 4 * D * attended
    f32_flops = 2 * steps * D * V
    entry.add(1, max(err, err1, eos_err), ms, plain, None, nbytes, flops,
              f32_flops)
    entry.d["ms_rows1"] = ms1
    entry.d["cluster"] = cluster[batch]
    entry.d["cluster_rows1"] = cluster[1]
    log(f"kernel {name}: memory {tuple(memory.shape)} {steps} (row, step) "
        f"pairs, log-prob sums max_abs_err {err:.3g} (rows that agree; 1 "
        f"row {err1:.3g}, EOS-boosted {eos_err:.3g}); ms {ms:.4f} (1 row "
        f"{ms1:.4f}) plain_ms "
        f"{plain:.4f} bound_ms {bound_ms(nbytes, flops, f32_flops):.4f} "
        f"({bound_by(nbytes, flops, f32_flops)}; {nbytes / 1e6:.2f} MB "
        f"moved, each input read once, each cache slot written once; the "
        f"{reads / 1e9:.3f} GB of cache re-reads not counted) "
        f"plain_ms is one synchronized wall; library_ms null")
    return entry


# the positional table cut to this many rows for check_past_table: a model
# whose max_seq_len lies under the decode's
PAST_TABLE_ROWS = 8


def check_past_table(cfg, np_params, batch):
    """Phase 3: the three kernels that read the positional table on the
    card (B7, B10, B12) at positions past it, bf16, each against its plain
    version, which takes the table's last row there as JAX's gather
    clamps the index: the bundle's table cut to PAST_TABLE_ROWS rows; B7
    on ``batch`` rows at a position vector holding the last slot, the first
    slot past the table and slots inside it (logits and fresh rows within
    the decoder step's tolerance); B10 at the last slot on one row (logp
    and the written row within it, nxt equal where the plain margin is
    clear); B12 a whole decode of T steps on one row, which must run past
    the table (held by ``hold_decode``). Returns the largest error."""
    import torch

    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.ops import fused_step as fs
    from handwritten_math_ocr_api_torch.ops import whole_decode as wd

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    L_enc, V, kvd = cfg.encoder_len, cfg.vocab_size, cfg.kv_dim
    Tp = PAST_TABLE_ROWS

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def cut(bundle):
        return {**bundle, "pos_emb": bundle["pos_emb"][:Tp].contiguous()}

    stacked = cut(fs.build_stacked_full(np_params["decoder"], cfg, dev))
    errs = []
    # B7: a position vector with the last slot, the first past the table
    prev = torch.randint(0, V, (batch,), generator=gen, device=dev,
                         dtype=torch.int32)
    pos = torch.randint(0, Tp, (batch,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[1] = T - 1, Tp
    caches = (randn(L, batch, T, kvd), randn(L, batch, T, kvd),
              randn(L, batch, L_enc, D), randn(L, batch, L_enc, D))
    got = fs.fused_ragged_step(stacked, cfg, prev, pos, *caches,
                               return_logits=True)
    want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                      return_logits=True)
    for name, g, w in zip(("logits", "k_new", "v_new"), got, want):
        assert_close(f"ragged_step past the table {name}", g, w, STEP_ATOL,
                     STEP_RTOL)
        errs.append(max_err(g, w))
    # B10: one row at the last slot, time-major caches
    one = (prev[:1].contiguous(), randn(L, T, 1, D), randn(L, T, 1, D),
           caches[2][:, :1].contiguous(), caches[3][:, :1].contiguous())
    got_k, got_v = one[1].clone(), one[2].clone()
    want_k, want_v = one[1].clone(), one[2].clone()
    got = fs.fused_whole_step(stacked, cfg, one[0], got_k, got_v, *one[3:],
                              T - 1)
    want = fs.fused_whole_step_plain(stacked, cfg, one[0], want_k, want_v,
                                     *one[3:], T - 1)
    logits = fs.fused_ragged_step_plain(
        stacked, cfg, one[0],
        torch.full((1,), T - 1, dtype=torch.int32, device=dev),
        want_k.transpose(1, 2), want_v.transpose(1, 2), *one[3:],
        return_logits=True)[0]
    clear = margin_of(logits) > STEP_ATOL
    if not torch.equal(got[0][clear], want[0][clear]):
        raise AssertionError("whole_step past the table: nxt differs where "
                             "the plain margin is clear")
    for name, g, w in (("logp", got[1], want[1]),
                       ("cache k", got_k[:, T - 1], want_k[:, T - 1]),
                       ("cache v", got_v[:, T - 1], want_v[:, T - 1])):
        assert_close(f"whole_step past the table {name}", g, w, STEP_ATOL,
                     STEP_RTOL)
        errs.append(max_err(g, w))
    # B12: one row's decode of T steps over a table of Tp rows
    dec = convert.to_torch({"decoder": np_params["decoder"]}, cfg,
                           dev)["decoder"]
    resident = cut(wd.build_resident(dec, cfg, False))
    memory = randn(1, L_enc, D)
    got = wd.fused_whole_decode(resident, cfg, memory)
    want, logits = wd.fused_whole_decode_plain(resident, cfg, memory,
                                               return_logits=True)
    ran = int(logits.shape[1])
    if ran <= Tp:
        raise AssertionError(f"whole_decode past the table: the decode "
                             f"ended at step {ran}, inside the table")
    errs.append(hold_decode("kernel whole_decode past the table", got, want,
                            logits))
    log(f"kernels past the positional table ({Tp} rows, T {T}): ragged_step "
        f"at pos {pos[:2].tolist()} and {batch - 2} rows inside, "
        f"whole_step at pos {T - 1}, whole_decode of {ran} steps; "
        f"max_abs_err {max(errs):.3g}")
    return max(errs)


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


def tally(entries, counts, route):
    """Add a path's launch counts to the kernels' entries."""
    for e, n in zip(entries, counts):
        e.d["launches"] += n
        e.d["launches_by_route"][route] = n


# the port's kernels as the profiler names them
PORT_KERNELS = tuple(f"(anonymous namespace)::{k}_kernel" for k in (
    "window_attention", "window_attention_mma", "patch_merging",
    "patch_merging_mma", "cache_append_attention",
    "fused_step_cluster", "swin_block", "swin_block_mma",
    "ragged_step_cluster", "beam_gather",
    "dequant_mma", "dequant_f32", "whole_step_cluster",
    "whole_decode_cluster"))


def profile_call(fn, what, unprofiled_s, tries=3):
    """Device busy time of one call of ``fn``, and its largest kernels. The
    idle share is given against the profiled wall time and against the
    best unprofiled one (the profiler slows the host, not the device).
    Returns the latter, or None when the profiler saw no device time. The
    profiler on the GPU machine can miss the first launches of a session:
    a session that recorded fewer of the port's kernels than its wrappers
    launched is run again, up to ``tries`` sessions; the last one's count
    is printed beside its busy time, which then is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total]
        seen = sum(e.count for e in rows
                   if any(k in e.key for k in PORT_KERNELS))
        launched = sum(read_counts())
        if rows and seen == launched:
            break
        log(f"profile: {seen} of the {launched} launches of the port's "
            f"kernels recorded")
    if not rows:
        log("profile: the profiler saw no device time (not measured)")
        return None
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    best_ms = unprofiled_s * 1e3
    log(f"profile: {what} wall {wall_ms:.1f} ms under "
        f"the profiler, device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f} (against the unprofiled "
        f"{best_ms:.1f} ms: {1 - busy_ms / best_ms:.3f})"
        f", device kernels {sum(e.count for e in rows)}, the port's "
        f"{seen} of {launched}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile: {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x {e.key[:100]}")
    return 1 - busy_ms / best_ms


def profile_batch(engine, images, unprofiled_s, beam_size=None):
    """``profile_call`` of one ``predict_batch``: one session on the
    default route, whose 150 steps launch 10,000s of small kernels (reading
    such a session back takes the host some 40 s; the share of the port's
    launches it recorded is printed), up to three on the fused one."""
    return profile_call(
        lambda: engine.predict_batch(images, beam_size=beam_size),
        f"predict_batch({len(images)}, beam_size={beam_size})", unprofiled_s,
        tries=3 if engine.use_fused else 1)


def kernel_counters():
    """(wrapper, count attribute) of each kernel of the ``kernels`` line,
    in its order: the decoder steps count their int8 entries apart, B1
    and B7 their MQA kernels, and B7 its ring entries."""
    from handwritten_math_ocr_api_torch.ops.beam_reorder import (
        beam_cache_gather,
    )
    from handwritten_math_ocr_api_torch.ops.cache_attention import (
        cache_append_attention,
        decode_attention,
    )
    from handwritten_math_ocr_api_torch.ops.fused_step import (
        fused_decoder_layers_step,
        fused_decoder_layers_step_v2,
        fused_ragged_step,
        fused_whole_step,
    )
    from handwritten_math_ocr_api_torch.ops.patch_merging import (
        fused_patch_merging,
    )
    from handwritten_math_ocr_api_torch.ops.quant import dequant_matmul
    from handwritten_math_ocr_api_torch.ops.swin_block import (
        fused_swin_block,
    )
    from handwritten_math_ocr_api_torch.ops.whole_decode import (
        fused_whole_decode,
    )
    from handwritten_math_ocr_api_torch.ops.window_attention import (
        window_attention_core,
    )

    wrappers = [window_attention_core, fused_patch_merging,
                cache_append_attention, decode_attention,
                fused_decoder_layers_step_v2, fused_swin_block,
                fused_ragged_step, beam_cache_gather, dequant_matmul]
    return ([(w, "launches") for w in wrappers]
            + [(fused_decoder_layers_step_v2, "int8_launches"),
               (fused_ragged_step, "int8_launches"),
               (fused_decoder_layers_step, "launches"),
               (fused_whole_step, "launches"),
               (fused_whole_decode, "launches"),
               (fused_whole_decode, "int8_launches"),
               (fused_decoder_layers_step_v2, "mqa_launches"),
               (fused_decoder_layers_step_v2, "mqa_int8_launches"),
               (fused_ragged_step, "mqa_launches"),
               (fused_ragged_step, "mqa_int8_launches"),
               (fused_ragged_step, "ring_launches"),
               (fused_ragged_step, "ring_int8_launches"),
               (fused_ragged_step, "ring_mqa_launches"),
               (fused_ragged_step, "ring_mqa_int8_launches")])


def reset_counts():
    for wrapper, attr in kernel_counters():
        setattr(wrapper, attr, 0)


def read_counts():
    return [getattr(wrapper, attr) for wrapper, attr in kernel_counters()]


def expected_launches(cfg, route, encodes, steps, beam=False):
    """Each kernel's launches for ``encodes`` encodes (each followed by one
    decode) and ``steps`` decode steps (greedy, or beam search with
    ``beam``) on a route: the default one ("pallas": window attention in
    every block, cache-append attention in every layer of every step) or
    the fused one (the block kernel where the route rule fuses, window
    attention in the other blocks; per step one launch of the decoder
    step, or for beam search one of the ragged step and one of the beam
    cache reorder). An "_int8" route adds, on the default route, the
    dequant matmul in every projection of every layer and the head each
    step and in the cross K and V projection of every layer each decode;
    on the fused route it moves the steps' launches to their int8
    entries. No path runs decode attention, nor B10-B12 (only
    ``serve_variants`` does). A ResNet encoder launches no encoder kernel
    (its convolutions are cuDNN's). Under MQA/GQA (``nhead_kv`` < ``nhead``) the
    default route's steps attend on plain ops (no cache-append attention)
    and the fused route's steps are B1's and B7's MQA kernels."""
    swin = cfg.encoder == "swin_t"  # a ResNet encoder launches none
    blocks = sum(cfg.swin.depths) if swin else 0
    merges = len(cfg.swin.depths) - 1 if swin else 0
    L = cfg.num_decoder_layers
    quantized = route.endswith("_int8")
    grouped = cfg.kv_heads != cfg.nhead
    if route.startswith("pallas"):
        dq = (6 * L + 1) * steps + 2 * L * encodes if quantized else 0
        return [encodes * blocks, encodes * merges,
                0 if grouped else L * steps, 0, 0, 0, 0, 0, dq,
                *[0] * 14]
    fused = fused_blocks(cfg) if swin else 0
    b1, b7, b8 = (0, steps, steps) if beam else (steps, 0, 0)
    b1, b1_int8 = (0, b1) if quantized else (b1, 0)
    b7, b7_int8 = (0, b7) if quantized else (b7, 0)
    mha = [b1, b7, b1_int8, b7_int8]
    mqa = [0, 0, 0, 0]
    if grouped:
        mha, mqa = mqa, [b1, b1_int8, b7, b7_int8]
    return [encodes * (blocks - fused), encodes * merges, 0, 0, mha[0],
            encodes * fused, mha[1], b8, 0, mha[2], mha[3], 0, 0, 0, 0,
            *mqa, 0, 0, 0, 0]


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


def serve(cfg, np_params, tok, entries, route, beam=True, **route_kw):
    """Phase 4: one route of the served path at full width, through the
    kernels: greedy, then with ``beam`` beam search (``serve_beam``).
    Returns ((images/s, idle share, bf16 greedy tokens) of greedy,
    serve_beam's result or None)."""
    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch.decode.api import (
        DecodeEngine,
        pick_bucket,
    )
    from handwritten_math_ocr_api_torch.models import model as model_mod

    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (N_IMAGES, cfg.img_h, cfg.img_w, 1),
                          dtype=np.uint8)
    single = rng.integers(0, 256, (cfg.img_h, cfg.img_w, 1), dtype=np.uint8)

    engine = DecodeEngine(np_params, cfg, tokenizer=tok, device=DEVICE,
                          **route_kw)
    engine.warmup((N_IMAGES,), dtype=np.uint8)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    texts = engine.predict_batch(images)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    steps = engine.last_steps
    latex, conf = engine.predict_single(single)
    torch.cuda.synchronize()
    steps += engine.last_steps
    counts = read_counts()
    expected = expected_launches(cfg, route, 2, steps)
    log(f"serve {route}: predict_batch({N_IMAGES}) + predict_single: decode "
        f"steps {steps}, launches {counts}, expected {expected} "
        f"({[e.d['name'] for e in entries]})")
    check_counts(counts, expected)
    tally(entries, counts, route)
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
                                 use_pallas_block=block,
                                 model_state=engine.model_state)
        mem_p = model_mod.encode(engine.params, cfg, x, kernels=False,
                                 use_pallas_block=block,
                                 model_state=engine.model_state)
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
                               use_pallas_block=block,
                               model_state=engine32.model_state)
        m_p = model_mod.encode(engine32.params, cfg32, x32, kernels=False,
                               use_pallas_block=block,
                               model_state=engine32.model_state)
    err32 = max_err(m_k, m_p)
    log(f"serve {route}: float32 memory kernel vs plain max_abs_err "
        f"{err32:.3g}")
    if err32 > MEMORY_F32_ATOL:
        raise AssertionError(f"float32 encoder memory differs by {err32}")
    if engine.use_fused and engine.quantize:
        fused_int8_trace(engine32, cfg32, m_p, route)
    else:
        with torch.inference_mode():
            r_k = route_decode(engine32, cfg32, m_k, True)
            r_p = route_decode(engine32, cfg32, m_p, False)
        log(f"serve {route}: float32 tokens equal "
            f"{torch.equal(r_k.tokens, r_p.tokens)} over {r_k.steps} steps")
        if not torch.equal(r_k.tokens, r_p.tokens):
            raise AssertionError("float32 greedy tokens differ between the "
                                 "kernel path and the plain path")
        # sums of up to 150 float32 log-probs: summation order only
        lp_err = (r_k.logprob_sum - r_p.logprob_sum).abs().max().item()
        if lp_err > 1e-2:
            raise AssertionError(f"float32 logprob sums differ by {lp_err}")
    if not beam:
        return (N_IMAGES / best, idle, res_k.tokens), None
    return ((N_IMAGES / best, idle, res_k.tokens),
            serve_beam(engine, engine32, images, entries, route))


def fused_int8_trace(engine32, cfg32, memory, route):
    """The fused int8 route in float32: a greedy decode of ``memory`` whose
    every step runs the plain step and, on caches of their own, the int8
    B1 and B7 kernels, all fed the plain path's tokens. The kernels'
    logits must stay within the bf16 step tolerance of the plain ones
    (their matmul inputs round to bf16, in float32 too); where a kernel's
    argmax differs from the plain one (the first such step is where its
    own decode would flip), the plain logits' top-2 margin there is
    reported."""
    import torch

    from handwritten_math_ocr_api_torch.decode.fused import init_fused_cache
    from handwritten_math_ocr_api_torch.decode.greedy import greedy_loop
    from handwritten_math_ocr_api_torch.models import layers
    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    dec, stacked = engine32.params["decoder"], engine32.stacked
    B, T = memory.shape[0], cfg32.max_seq_len
    sk, sv, ck, cv = init_fused_cache(dec, cfg32, memory, T)
    caches = {k: (sk.clone(), sv.clone()) for k in ("plain", "b1", "b7")}
    emb, pos_table = dec["embedding"]["table"], dec["pos"]["table"]
    err = {"b1": 0.0, "b7": 0.0}
    flips = {"b1": [], "b7": []}

    def append(key, step, k_new, v_new):
        k, v = caches[key]
        k[:, :, step] = k_new
        v[:, :, step] = v_new

    def step_logits(prev, step):
        x_emb = (emb[prev] + pos_table[step]).float()
        logits = {}
        for key, fn in (("plain", fs.fused_decoder_layers_step_v2_plain),
                        ("b1", fs.fused_decoder_layers_step_v2)):
            x, k_new, v_new = fn(stacked, cfg32, x_emb, *caches[key], ck, cv,
                                 step)
            append(key, step, k_new, v_new)
            logits[key] = layers.linear(dec["fc_out"], x)
        pos = torch.full((B,), step, dtype=torch.int32, device=prev.device)
        logits["b7"], k_new, v_new = fs.fused_ragged_step(
            stacked, cfg32, prev.to(torch.int32), pos, *caches["b7"], ck, cv,
            return_logits=True)
        append("b7", step, k_new, v_new)
        plain = logits["plain"]
        top2 = plain.topk(2, dim=-1).values
        for key in ("b1", "b7"):
            err[key] = max(err[key], max_err(logits[key], plain))
            for row in (logits[key].argmax(-1) != plain.argmax(-1)).nonzero():
                r = int(row)
                flips[key].append(
                    (r, step, float(top2[r, 0] - top2[r, 1])))
        return plain

    with torch.inference_mode():
        res = greedy_loop(step_logits, B, T, memory.device)
    for key in ("b1", "b7"):
        first = (f"first at row {flips[key][0][0]} step {flips[key][0][1]}, "
                 f"plain top-2 margin {flips[key][0][2]:.3g}"
                 if flips[key] else "none")
        log(f"serve {route}: float32 {key} int8 logits vs plain over "
            f"{res.steps} steps of the plain path's tokens: max_abs_err "
            f"{err[key]:.3g}; argmax differs at {len(flips[key])} "
            f"(row, step) of {B * res.steps} ({first})")
        if err[key] > STEP_ATOL:
            raise AssertionError(f"float32 {key} int8 logits differ by "
                                 f"{err[key]}")


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
    the same memory. The fused int8 route's float32 beam tokens are
    reported, not held equal: its steps round their matmul inputs to bf16
    (``fused_int8_trace`` holds its step logits). Returns (images/s, idle
    share, steps, bf16 beam tokens)."""
    import torch

    from handwritten_math_ocr_api_torch.decode.beam import beam_decode
    from handwritten_math_ocr_api_torch.models import model as model_mod

    cfg, cfg32 = engine.cfg, engine32.cfg
    name = f"{route} beam"
    engine.predict_batch(images, beam_size=BEAM)       # warm up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    texts = engine.predict_batch(images, beam_size=BEAM)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    steps = engine.last_steps
    counts = read_counts()
    expected = expected_launches(cfg, route, 1, steps, beam=True)
    log(f"serve {name}: predict_batch({N_IMAGES}, beam_size={BEAM}): "
        f"decode steps {steps}, launches {counts}, expected {expected}")
    check_counts(counts, expected)
    tally(entries, counts, name)
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
                               use_pallas_block=block,
                               model_state=engine.model_state)[:B]
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
                               use_pallas_block=block,
                               model_state=engine32.model_state)[:B32]
        m_p = model_mod.encode(engine32.params, cfg32, x32, kernels=False,
                               use_pallas_block=block,
                               model_state=engine32.model_state)[:B32]
        r_k = route_beam(engine32, cfg32, m_k, True)
        r_p = route_beam(engine32, cfg32, m_p, False)
        other = (beam_decode(engine32.params["decoder"], cfg32, m_k, BEAM)
                 if engine.use_fused and not engine.quantize else None)
    score_err = (r_k.scores - r_p.scores).abs().max().item()
    log(f"serve {name}: float32 beam tokens equal to the plain path "
        f"{torch.equal(r_k.tokens, r_p.tokens)} over {r_k.steps} steps "
        f"(score max_abs_err {score_err:.3g})"
        + ("" if other is None else
           f"; fused beam equal to the default beam "
           f"{torch.equal(r_k.tokens, other.tokens)}"))
    if engine.use_fused and engine.quantize:
        differ = (r_k.tokens != r_p.tokens).nonzero()
        if len(differ):
            log(f"serve {name}: float32 beam tokens first differ at image "
                f"{int(differ[0, 0])} step {int(differ[0, 1])} (reported, "
                f"not held: see the float32 step logits above)")
        return N_IMAGES / best, idle, steps, res_k.tokens
    if not torch.equal(r_k.tokens, r_p.tokens):
        raise AssertionError("float32 beam tokens differ between the "
                             "kernel path and the plain path")
    # sums of up to 150 float32 log-probs: summation order only
    if score_err > 1e-2:
        raise AssertionError(f"float32 beam scores differ by {score_err}")
    if other is not None and not torch.equal(r_k.tokens, other.tokens):
        raise AssertionError("float32 fused beam tokens differ from the "
                             "default route's beam")
    return N_IMAGES / best, idle, steps, res_k.tokens


def serve_grouped(cfg, tok, entries):
    """Phase 5 ("serve mqa"): grouped self-attention at full width, the
    configuration's shapes with ``nhead_kv`` set and seeded random weights
    (no trained MQA or GQA checkpoint exists). MQA (``nhead_kv=1``) on the
    fused route, bf16 and int8, greedy and beam (B1's and B7's MQA
    kernels), and on the default route, greedy (grouped attention on plain
    ops); each through ``serve``: launch counts, images/s, device idle
    share, float32 tokens against the plain path. GQA-2 (``nhead_kv=2``)
    with ``use_fused``: the engine must warn and serve on the default
    route (``serve``, greedy), its tokens equal to the GQA-2 default
    engine's. The default routes, MQA's and GQA-2's, with their decoder
    cut to ``DEFAULT_ROUTE_LAYERS`` layers, as phase 4's: host-bound steps
    of plain ops that no kernel of theirs needs at full depth (they were
    77.5 s and 89.9 s of a 615.9 s run at full depth on an H100 80GB
    HBM3 at 700.00 W). Returns {route: serve's result}."""
    import logging

    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine

    fused = {"use_fused": True, "pallas_encoder_block": True}
    mqa = cfg.replace(nhead_kv=1)
    mqa_params = convert.random_params(mqa, SEED)
    cut = mqa.replace(num_decoder_layers=DEFAULT_ROUTE_LAYERS)
    cut_params = convert.random_params(cut, SEED)
    summary = {}
    for route, c, p, kw, beam in (
            ("fused_mqa", mqa, mqa_params, fused, True),
            ("fused_mqa_int8", mqa, mqa_params, {**fused, "quantize": True},
             True),
            ("pallas_mqa", cut, cut_params, {}, False)):
        t0 = time.perf_counter()
        summary[route] = serve(c, p, tok, entries, route, beam=beam, **kw)
        log(f"serve {route}: phase seconds {time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    gqa = cfg.replace(nhead_kv=2, num_decoder_layers=DEFAULT_ROUTE_LAYERS)
    gqa_params = convert.random_params(gqa, SEED)
    warned = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = warned.append
    logger = logging.getLogger("handwritten_math_ocr_api_torch.decode.api")
    logger.addHandler(handler)
    try:
        summary["pallas_gqa"] = serve(gqa, gqa_params, tok, entries,
                                      "pallas_gqa", beam=False,
                                      use_fused=True)
        fallback = DecodeEngine(gqa_params, gqa, tokenizer=tok,
                                device=DEVICE, use_fused=True)
    finally:
        logger.removeHandler(handler)
    if fallback.use_fused or not any("GQA" in r.getMessage()
                                     for r in warned):
        raise AssertionError("a GQA use_fused engine did not warn and take "
                             "the default route")
    default = DecodeEngine(gqa_params, gqa, tokenizer=tok, device=DEVICE)
    images = np.random.default_rng(SEED).integers(
        0, 256, (N_IMAGES, cfg.img_h, cfg.img_w, 1), dtype=np.uint8)
    got = fallback.decode_tokens(images).tokens
    want = default.decode_tokens(images).tokens
    log(f"serve pallas_gqa: use_fused warned ({warned[0].getMessage()!r}); "
        f"bf16 tokens equal to the default GQA engine's "
        f"{torch.equal(got, want)}")
    if not torch.equal(got, want):
        raise AssertionError("GQA use_fused tokens differ from the default "
                             "engine's")
    log(f"serve pallas_gqa: phase seconds {time.perf_counter() - t0:.1f}")
    return summary


CONT_IMAGES = 40


def continuous_decoder(cfg, np_params, tok, **kw):
    """A ContinuousDecoder at the pool of ``CONT_SLOTS`` slots, segments
    of ``CONT_SEGMENT_STEPS`` and ``CONT_RING`` steps, that keeps each
    finished request's tokens, count and log-prob sum (``decoded``) and
    counts its admissions' encodes (``inserts``)."""
    from handwritten_math_ocr_api_torch.decode.continuous import (
        ContinuousDecoder,
    )

    class Recording(ContinuousDecoder):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.decoded, self.inserts = {}, 0

        def _insert(self, slots, imgs):
            self.inserts += 1
            return super()._insert(slots, imgs)

        def _process_report(self, seg_idx, rep):
            held = dict(self._slot_req)
            out = super()._process_report(seg_idx, rep)
            for slot, rid in held.items():
                if rid in out:
                    self.decoded[rid] = (rep["tokens"][slot].copy(),
                                         int(rep["count"][slot]),
                                         float(rep["lp_sum"][slot]))
            return out

    return Recording(np_params, cfg, tok, num_slots=CONT_SLOTS,
                     segment_steps=CONT_SEGMENT_STEPS,
                     max_segment_steps=CONT_RING, device=DEVICE, **kw)


def continuous_traffic(dec, images):
    """Phase 6's traffic: 8 images submitted at once, then 4 a scheduler
    tick, so that admissions land mid-flight and slots are reused; run to
    the end. Returns (the (latex, confidence) results, a GreedyResult of
    the requests' tokens, both in submission order, and the wall
    seconds)."""
    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch.decode.greedy import GreedyResult

    dec.decoded.clear()
    t0 = time.perf_counter()
    ids = [dec.submit(img) for img in images[:8]]
    results, n = {}, 8
    while not dec.idle:
        results.update(dec.step_once())
        if n < len(images):
            ids += [dec.submit(img) for img in images[n:n + 4]]
            n += 4
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev = torch.device(DEVICE)
    tokens = torch.from_numpy(np.stack(
        [dec.decoded[i][0] for i in ids])).long().to(dev)
    count = torch.tensor([dec.decoded[i][1] for i in ids], device=dev)
    lp = torch.tensor([dec.decoded[i][2] for i in ids], device=dev)
    res = GreedyResult(tokens, (tokens != 0).sum(dim=-1), lp, count,
                       tokens.shape[1])
    return [results[i] for i in ids], res, wall


def continuous_counts(dec, cfg, route, name):
    """The run's launch counts against its shape: the encoder's kernels in
    each admission's encode, and one launch of B7's entry for the pool
    (ring or not, int8 or not, MQA or not) a scheduled step on the fused
    route (none on the default one), every other kernel none."""
    from handwritten_math_ocr_api_torch.ops.fused_step import (
        fused_ragged_step,
    )

    counts = read_counts()
    expected = expected_launches(cfg, route, dec.inserts, 0)
    if dec.use_fused:
        attr = (("ring_" if dec.segment_ring else "")
                + ("mqa_" if cfg.kv_heads != cfg.nhead else "")
                + ("int8_launches" if "w_qkv_s" in dec._seg_params
                   else "launches"))
        expected[kernel_counters().index((fused_ragged_step, attr))] = (
            dec.steps_scheduled)
    log(f"continuous {name}: {dec.inserts} admission encodes, "
        f"{dec.steps_scheduled} scheduled steps, launches {counts}, "
        f"expected {expected}")
    check_counts(counts, expected)
    return counts


def continuous_vs(name, got, want, pairs_got, pairs_want):
    """A continuous run against a reference run of the same requests in
    float32: tokens and counts equal, strings equal, confidences within
    1e-4 (summation order only)."""
    import torch

    if not (torch.equal(got.tokens, want.tokens)
            and torch.equal(got.token_count.long(),
                            want.token_count.long())):
        differ = (got.tokens != want.tokens).any(dim=1).nonzero().flatten()
        raise AssertionError(f"continuous {name}: float32 tokens differ in "
                             f"rows {differ.tolist()}")
    conf = max(abs(g[1] - w[1]) for g, w in zip(pairs_got, pairs_want))
    if ([g[0] for g in pairs_got] != [w[0] for w in pairs_want]
            or conf > 1e-4):
        raise AssertionError(f"continuous {name}: results differ "
                             f"(confidence by {conf})")
    log(f"continuous {name}: float32 tokens, counts and strings equal, "
        f"confidences within {conf:.3g}")


def plain_fused_decode(engine, cfg, memory):
    """The fused route's plain greedy decode of ``memory`` (the "v2" step's
    plain version and the float32 head), and its logits at every step
    (B, T, V); a row's logits after its end are NaN."""
    import torch

    from handwritten_math_ocr_api_torch.decode.fused import init_fused_cache
    from handwritten_math_ocr_api_torch.decode.greedy import greedy_loop
    from handwritten_math_ocr_api_torch.models import layers
    from handwritten_math_ocr_api_torch.ops import fused_step as fs

    dec, stacked = engine.params["decoder"], engine.stacked
    B, T, V = memory.shape[0], cfg.max_seq_len, cfg.vocab_size
    sk, sv, ck, cv = init_fused_cache(dec, cfg, memory, T)
    emb, pos_table = dec["embedding"]["table"], dec["pos"]["table"]
    logits = torch.full((B, T, V), float("nan"), device=memory.device)

    def step_logits(prev, step):
        x_emb = (emb[prev] + pos_table[step]).to(getattr(torch, cfg.dtype))
        x, k_new, v_new = fs.fused_decoder_layers_step_v2_plain(
            stacked, cfg, x_emb, sk, sv, ck, cv, step)
        sk[:, :, step] = k_new
        sv[:, :, step] = v_new
        logits[:, step] = layers.linear(dec["fc_out"], x.float())
        return logits[:, step]

    with torch.inference_mode():
        res = greedy_loop(step_logits, B, T, memory.device)
    return res, logits


def serve_continuous(cfg, tok, entries):
    """Phase 6 ("serve continuous"): continuous batching
    (``decode/continuous.ContinuousDecoder``) at full width, 32 slots
    (the fused pool 48 rows), segments of 16 steps and of 64 when the pool
    is full and nothing waits, the segment ring of 64 rows; seeded random
    weights with the EOS bias raised (``EOS_BOOST``), so that requests end
    at different steps and slots are reused; the traffic of
    ``continuous_traffic`` on 40 seeded images. The fused route
    (``use_fused``, ``pallas_encoder_block``) in bf16: launch counts
    (``continuous_counts``), images/s (best of 3), the device's idle
    share, the scheduler's stats. In float32, its results (ring on and
    off) equal to the fused engine's ``predict_with_confidence`` and
    tokens (B7 against B1: summation order only). The int8 bundle in
    bf16 held by ``hold_decode`` against its plain decode. MQA
    (``nhead_kv=1``): float32 equal to the MQA fused engine, and its int8
    bundle in bf16 held as above. The default route, with its decoder
    cut to ``DEFAULT_ROUTE_LAYERS`` layers, in float32: equal to the
    default engine's."""
    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import EOS_ID
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
    from handwritten_math_ocr_api_torch.models import model as model_mod

    fused = {"use_fused": True, "pallas_encoder_block": True}
    images = np.random.default_rng(SEED + 7).integers(
        0, 256, (CONT_IMAGES, cfg.img_h, cfg.img_w, 1), dtype=np.uint8)

    def params_of(c):
        p = convert.random_params(c, SEED)
        p["decoder"]["fc_out"]["b"][EOS_ID] += EOS_BOOST
        return p

    np_params = params_of(cfg)
    dec = continuous_decoder(cfg, np_params, tok, **fused)
    dec.warmup(image_dtype=np.uint8)
    reset_counts()
    dec.reset_stats()
    dec.inserts = 0
    _, bf16_res, first = continuous_traffic(dec, images)
    tally(entries, continuous_counts(dec, cfg, "fused", "fused bf16"),
          "continuous fused")
    st = dec.stats
    log(f"continuous fused bf16: stats avg_occupancy "
        f"{st['avg_occupancy']:.4f} work_occupancy "
        f"{st['work_occupancy']:.4f} rows_scheduled {st['rows_scheduled']} "
        f"steps {dec.steps_scheduled} segments {st['segments_run']} "
        f"harvest_blocks {st['harvest_blocks']} t_admit_s {st['t_admit_s']} "
        f"t_dispatch_s {st['t_dispatch_s']} t_harvest_wait_s "
        f"{st['t_harvest_wait_s']}; requests' steps "
        f"{steps_per_row(bf16_res.tokens.cpu(), EOS_ID)}")
    times = []
    for _ in range(3):
        times.append(continuous_traffic(dec, images)[2])
    best = min(times)
    log(f"continuous fused bf16: {CONT_IMAGES} requests seconds "
        f"{[round(t, 4) for t in times]} (first counted run {first:.4f}), "
        f"images/s {CONT_IMAGES / best:.2f}")
    idle = profile_call(lambda: continuous_traffic(dec, images),
                        f"continuous fused bf16 ({CONT_IMAGES} requests)",
                        best)
    idle_s = "not measured" if idle is None else f"{idle:.3f}"
    log(f"route continuous fused: images/s {CONT_IMAGES / best:.2f}, device "
        f"idle share {idle_s} (of the best unprofiled run)")
    dec.close()

    # float32: the fused route, ring on and off, against the fused engine
    cfg32 = cfg.replace(dtype="float32")
    engine32 = DecodeEngine(np_params, cfg32, tokenizer=tok, device=DEVICE,
                            **fused)
    want = engine32.decode_tokens(images)
    pairs_want = engine32.predict_with_confidence(images)
    runs = {}
    for ring in (True, False):
        d = continuous_decoder(cfg32, np_params, tok, segment_ring=ring,
                               **fused)
        reset_counts()
        pairs, res, _ = continuous_traffic(d, images)
        name = f"fused float32 ring {ring}"
        tally(entries, continuous_counts(d, cfg32, "fused", name),
              f"continuous fused float32 ring {ring}")
        continuous_vs(name, res, want, pairs, pairs_want)
        runs[ring] = (res, pairs)
        d.close()
    continuous_vs("ring off against ring on", runs[False][0], runs[True][0],
                  runs[False][1], runs[True][1])

    def held_int8(c, p, name):
        """The int8 bundle in bf16, held by hold_decode against the plain
        decode of the engine's memory of the same images."""
        d = continuous_decoder(c, p, tok, quantize=True, **fused)
        reset_counts()
        _, got, _ = continuous_traffic(d, images)
        tally(entries, continuous_counts(d, c, "fused", name),
              f"continuous {name}")
        d.close()
        engine = DecodeEngine(p, c, tokenizer=tok, device=DEVICE,
                              quantize=True, **fused)
        x, n = engine._pad_batch(images)
        with torch.inference_mode():
            memory = model_mod.encode(engine.params, c, x,
                                      use_pallas_block=True)[:n]
        want8, logits = plain_fused_decode(engine, c, memory)
        err = hold_decode(f"continuous {name}", got, want8, logits)
        log(f"continuous {name}: log-prob sums max_abs_err {err:.3g} over "
            f"the rows that agree")
        if err > WHOLE_DECODE_LP_ATOL:
            raise AssertionError(f"continuous {name}: log-prob sums differ "
                                 f"by {err}")

    held_int8(cfg, np_params, "fused int8 bf16")

    # MQA: float32 against the MQA fused engine, and its int8 bundle
    mqa = cfg.replace(nhead_kv=1)
    mqa_params = params_of(mqa)
    mqa32 = mqa.replace(dtype="float32")
    engine = DecodeEngine(mqa_params, mqa32, tokenizer=tok, device=DEVICE,
                          **fused)
    d = continuous_decoder(mqa32, mqa_params, tok, **fused)
    reset_counts()
    pairs, res, _ = continuous_traffic(d, images)
    tally(entries,
          continuous_counts(d, mqa32, "fused", "fused mqa float32"),
          "continuous fused mqa float32")
    continuous_vs("fused mqa float32", res, engine.decode_tokens(images),
                  pairs, engine.predict_with_confidence(images))
    d.close()
    held_int8(mqa, mqa_params, "fused mqa int8 bf16")

    # the default route (decoder_step_ragged on plain ops), float32
    cut = cfg32.replace(num_decoder_layers=DEFAULT_ROUTE_LAYERS)
    cut_params = params_of(cut)
    engine = DecodeEngine(cut_params, cut, tokenizer=tok, device=DEVICE)
    d = continuous_decoder(cut, cut_params, tok)
    reset_counts()
    pairs, res, _ = continuous_traffic(d, images)
    tally(entries, continuous_counts(d, cut, "pallas", "default float32"),
          "continuous default float32")
    continuous_vs("default float32", res, engine.decode_tokens(images),
                  pairs, engine.predict_with_confidence(images))
    d.close()


# phase "quality": the shipped weights on the data_eval_hard test split,
# held to the JAX package's scores (quality_bar.py's fixture)
QUALITY_FIXTURE = os.path.join(REPO_ROOT, "tests", "fixtures",
                               "torch_r4_quality.json")
QUALITY_DATA = os.path.join(REPO_ROOT, "data_eval_hard")
QUALITY_BATCH = 64
QUALITY_SUBSET = 512
# bf16 and int8 quality gates: exact match at most 1.5 points under its
# bar and corpus CER at most 0.01 above it. A wrong reader or layout
# scores near 0; bf16 rounding moves a few near-ties between runs
QUALITY_EXACT_BELOW = 0.015
QUALITY_CER_ABOVE = 0.01
# float32 predictions of the first 64 images equal to JAX's on all but at
# most this many (63 of 64: summation order may flip one near-tie)
QUALITY_F32_DIFFER = 1


class CountedEngine:
    """A DecodeEngine for the harness (``decode_tokens``) or the batcher
    (``predict_with_confidence``) that counts its decodes (one encode
    each), their decode steps and the host seconds they take (each decode
    ends on its loop's read of the finished flags)."""

    def __init__(self, engine):
        self.engine = engine
        self.calls = 0
        self.steps = 0
        self.seconds = 0.0

    def decode_tokens(self, images, beam_size=None):
        t0 = time.perf_counter()
        res = self.engine.decode_tokens(images, beam_size)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.steps += self.engine.last_steps
        return res

    def predict_with_confidence(self, images):
        t0 = time.perf_counter()
        out = self.engine.predict_with_confidence(images)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.steps += self.engine.last_steps
        return out


class ContinuousEngine:
    """``decode_tokens`` for the harness over a ``continuous_decoder``: each
    image of a batch is one request, and the decoder runs until the
    batch's requests are done. Returns their GreedyResult."""

    def __init__(self, dec):
        self.dec = dec

    def decode_tokens(self, images, beam_size=None):
        import numpy as np
        import torch

        from handwritten_math_ocr_api_torch.decode.greedy import GreedyResult

        ids = [self.dec.submit(img) for img in images]
        while not self.dec.idle:
            self.dec.step_once()
        tokens = torch.from_numpy(np.stack(
            [self.dec.decoded[i][0] for i in ids])).long()
        count = torch.tensor([self.dec.decoded[i][1] for i in ids])
        lp = torch.tensor([self.dec.decoded[i][2] for i in ids])
        return GreedyResult(tokens, (tokens != 0).sum(dim=-1), lp, count,
                            tokens.shape[1])


def quality_loader(tok, cfg, n=None):
    """The port's test loader at batch 64 in CSV order, over the first
    ``n`` images (all with None)."""
    from handwritten_math_ocr_api_torch.core.config import DataConfig
    from handwritten_math_ocr_api_torch.data.dataset import get_test_loader

    loader = get_test_loader(tok, DataConfig(data_root=QUALITY_DATA,
                                             batch_size=QUALITY_BATCH), cfg)
    if n is not None:
        loader.dataset.rows = loader.dataset.rows[:n]
    return loader


def quality_gate(name, summary, bar):
    """Print a cell's scores beside its bar; raise if exact match or corpus
    CER misses its gate."""
    def f(x):
        return "none" if x is None else f"{x:.4f}"

    em, cer = summary["accuracy"], summary["corpus_cer"]
    log(f"quality {name}: {summary['num_samples']} images, exact match "
        f"{em:.4f} (bar {bar['exact_match']:.4f}), corpus CER {cer:.4f} "
        f"(bar {bar['corpus_cer']:.4f}), avg CER {summary['avg_cer']:.4f} "
        f"(bar {bar['avg_cer']:.4f}), valid LaTeX "
        f"{summary['valid_latex']:.4f} (bar {bar['valid_latex']:.4f}), "
        f"mean confidence {f(summary.get('mean_confidence'))} (bar "
        f"{f(bar['mean_confidence'])}), ECE {f(summary.get('ece'))} (bar "
        f"{f(bar['ece'])}), BLEU-4 {summary['bleu']:.4f} (0.0 without "
        f"nltk), images/s {summary['images_per_sec']:.2f} (harness wall, "
        f"host metrics included)")
    if (em < bar["exact_match"] - QUALITY_EXACT_BELOW
            or cer > bar["corpus_cer"] + QUALITY_CER_ABOVE):
        raise AssertionError(
            f"quality {name}: exact match {em} / corpus CER {cer} miss the "
            f"bar {bar['exact_match']} - {QUALITY_EXACT_BELOW} / "
            f"{bar['corpus_cer']} + {QUALITY_CER_ABOVE}")


def quality_float32(cfg, np_params, tok, batch, fixture):
    """The first 64 images in float32 on the default route (all 8 decoder
    layers) and the fused one: predictions equal to JAX's float32 ones on
    all but at most ``QUALITY_F32_DIFFER``; each difference printed with its first
    differing step and the card's top-2 logit margin there (the plain
    decoder's teacher-forced logits on the card's own tokens)."""
    import torch

    from handwritten_math_ocr_api_torch.core.config import PAD_ID, SOS_ID
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
    from handwritten_math_ocr_api_torch.models import model as model_mod
    from handwritten_math_ocr_api_torch.models.decoder import decoder_forward

    want = fixture["float32_first64"]
    cfg32 = cfg.replace(dtype="float32")
    routes = {"default": {}, "fused": {"use_fused": True,
                                       "pallas_encoder_block": True}}
    for route, kw in routes.items():
        engine = DecodeEngine(np_params, cfg32, tokenizer=tok, device=DEVICE,
                              **kw)
        res = engine.decode_tokens(batch["image"])
        tokens = res.tokens.cpu().tolist()
        preds = tok.decode_batch(tokens)
        diffs = []
        for i, (p, w) in enumerate(zip(preds, want["predictions"])):
            if p == w:
                continue
            ref = want["tokens"][i] + [PAD_ID] * len(tokens[i])
            s = next(j for j, t in enumerate(tokens[i]) if t != ref[j])
            x, _ = engine._pad_batch(batch["image"][i:i + 1])
            with torch.inference_mode():
                memory = model_mod.encode(
                    engine.params, cfg32, x,
                    use_pallas_block=engine.pallas_encoder_block)[:1]
                tgt = torch.tensor([[SOS_ID] + tokens[i][:s]],
                                   device=memory.device)
                logits = decoder_forward(engine.params["decoder"], cfg32,
                                         memory, tgt)[0, s]
            diffs.append((i, s, round(float(margin_of(logits)), 6)))
        equal = len(preds) - len(diffs)
        log(f"quality float32 {route}: predictions equal to JAX's float32 "
            f"on {equal} of {len(preds)}; differences (image, first "
            f"differing step, card top-2 margin) {diffs}")
        if len(diffs) > QUALITY_F32_DIFFER:
            raise AssertionError(f"quality float32 {route}: {equal} of "
                                 f"{len(preds)} predictions equal JAX's")


def quality_profile(engine, name, images):
    """The wall (best of 3) and the device's busy time and idle share of
    one decode_tokens of the first batch of real images."""
    import torch

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.decode_tokens(images)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"quality {name}: decode_tokens({len(images)}) of the first batch, "
        f"{engine.last_steps} steps, seconds {[round(w, 4) for w in walls]}")
    profile_call(lambda: engine.decode_tokens(images),
                 f"quality {name} decode_tokens({len(images)})", min(walls),
                 tries=1)


def quality_top1(np_params, cfg, tok, entries, images):
    """Sampling with ``top_k=1`` on the first batch of real images, fused
    bf16, launches counted: its strings equal fused greedy's (the same
    kernels compute the same logits; only the argmax survives top-1)."""
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine

    greedy = DecodeEngine(np_params, cfg, tokenizer=tok, device=DEVICE,
                          use_fused=True, pallas_encoder_block=True)
    want = tok.decode_batch(greedy.decode_tokens(images).tokens.tolist())
    got = []

    def run():
        got.extend(tok.decode_batch(greedy.sample_tokens(
            images, top_k=1, seed=SEED).tokens.tolist()))
        return greedy.last_steps

    counted(entries, "quality sample top_k=1", run, route_shape(cfg, "fused"))
    equal = sum(g == w for g, w in zip(got, want))
    log(f"quality fused bf16 sample top_k=1: strings equal fused greedy's "
        f"on {equal} of {len(want)}")
    if equal != len(want):
        raise AssertionError("quality: top_k=1 sampling differs from greedy")


def quality(tok, entries):
    """Phase "quality": the shipped weights read by the port's own reader,
    the test split decoded by its PNG reader, both to the fixture's
    digests; float32 predictions of the first 64 images against JAX's on
    the default and the fused route; bf16 and int8 scores through the
    port's harness at batch 64 against the bars, each cell's launches
    counted (set to 0 before it, read after); one decode of the first batch
    on each bf16 greedy route timed and profiled."""
    import ctypes.util
    import hashlib

    import numpy as np

    from handwritten_math_ocr_api_torch.data.dataset import read_labels
    from handwritten_math_ocr_api_torch.data.png import read_png_batch
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
    from handwritten_math_ocr_api_torch.eval.harness import evaluate_model
    from handwritten_math_ocr_api_torch.train.checkpoint import (
        leaves_with_paths,
        load_params_for_serving,
        tree_digest,
    )

    log(f"quality: libzstd {ctypes.util.find_library('zstd')}")
    with open(QUALITY_FIXTURE) as f:
        fixture = json.load(f)
    t0 = time.perf_counter()
    np_params, _, vocab, idx2char, cfg = load_params_for_serving(MODEL_DIR)
    read_s = time.perf_counter() - t0
    digest = tree_digest(np_params)
    leaves = [x for _, x in leaves_with_paths(np_params)]
    log(f"quality: checkpoint read in {read_s:.2f} s, {len(leaves)} leaves, "
        f"{sum(x.size for x in leaves)} parameters, tree_digest {digest} "
        f"(fixture {fixture['tree_digest']})")
    if digest != fixture["tree_digest"]:
        raise AssertionError("quality: the checkpoint's tree_digest differs "
                             "from the fixture's")
    if tok.vocab != vocab:
        raise AssertionError("quality: the artifact's vocab.json differs")

    t0 = time.perf_counter()
    paths = [os.path.join(QUALITY_DATA, "test_formulas", name)
             for name, _ in read_labels(os.path.join(QUALITY_DATA,
                                                     "test_labels.csv"))]
    stack = read_png_batch(paths)
    png_s = time.perf_counter() - t0
    sha = hashlib.sha256(stack.tobytes()).hexdigest()
    log(f"quality: {len(paths)} test PNGs decoded in {png_s:.2f} s, shape "
        f"{list(stack.shape)}, sha256 {sha} (fixture "
        f"{fixture['images_sha256']})")
    if sha != fixture["images_sha256"]:
        raise AssertionError("quality: the decoded test images differ from "
                             "the fixture's")

    first = next(iter(quality_loader(tok, cfg, QUALITY_BATCH)))
    quality_float32(cfg, np_params, tok, first, fixture)

    bars = fixture["bars"]
    sub = str(QUALITY_SUBSET)
    fused = {"use_fused": True, "pallas_encoder_block": True}
    cells = [
        ("fused bf16 greedy", "fused", fused, None, None,
         bars["bf16_greedy"]["2000"]),
        ("fused int8 greedy", "fused_int8", {**fused, "quantize": True},
         None, None, bars["bf16_greedy_int8"]["2000"]),
        ("default bf16 greedy", "pallas", {}, QUALITY_SUBSET, None,
         bars["bf16_greedy"][sub]),
        ("default int8 greedy", "pallas_int8", {"quantize": True},
         QUALITY_SUBSET, None, bars["bf16_greedy_int8"][sub]),
        ("fused bf16 beam 5", "fused", fused, QUALITY_SUBSET, BEAM,
         bars["bf16_beam5"][sub]),
        ("fused bf16 constrained greedy", "fused",
         {**fused, "constrained": True}, QUALITY_SUBSET, None,
         bars["bf16_greedy_constrained"][sub]),
    ]
    results = {}
    for name, route, kw, n, beam, bar in cells:
        engine = DecodeEngine(np_params, cfg, tokenizer=tok, device=DEVICE,
                              **kw)
        engine.warmup((QUALITY_BATCH,), beam_sizes=(beam,) if beam else (),
                      dtype=np.uint8)
        counted = CountedEngine(engine)
        reset_counts()
        res = evaluate_model(counted, quality_loader(tok, cfg, n), tok, beam)
        counts = read_counts()
        expected = expected_launches(cfg, route, counted.calls,
                                     counted.steps, beam=bool(beam))
        log(f"quality {name}: {counted.calls} decodes, {counted.steps} "
            f"steps, {counted.seconds:.2f} s in decode_tokens of the "
            f"harness's {res['summary']['elapsed_sec']:.2f} s, launches "
            f"{counts}, expected {expected}")
        check_counts(counts, expected)
        tally(entries, counts, f"quality {name}")
        quality_gate(name, res["summary"], bar)
        results[name] = res
        if name in ("fused bf16 greedy", "default bf16 greedy"):
            quality_profile(engine, name, first["image"])
        if engine.constraint is not None:
            valid = res["summary"]["valid_latex"]
            if valid != 1.0:
                raise AssertionError(f"quality {name}: valid LaTeX {valid}, "
                                     f"not 1 (constrained by construction)")
    quality_top1(np_params, cfg, tok, entries, first["image"])

    dec = continuous_decoder(cfg, np_params, tok, **fused)
    dec.warmup(image_dtype=np.uint8)
    reset_counts()
    dec.reset_stats()
    dec.inserts = 0
    res = evaluate_model(ContinuousEngine(dec),
                         quality_loader(tok, cfg, QUALITY_SUBSET), tok)
    name = "continuous fused bf16 greedy"
    counts = continuous_counts(dec, cfg, "fused", f"quality {name}")
    dec.close()
    tally(entries, counts, f"quality {name}")
    greedy = [r["prediction"] for r in
              results["fused bf16 greedy"]["records"][:QUALITY_SUBSET]]
    agree = np.mean([r["prediction"] == g
                     for r, g in zip(res["records"], greedy)])
    log(f"quality {name}: predictions equal to fused bf16 greedy's on "
        f"{agree:.4f} of {QUALITY_SUBSET} (not held)")
    quality_gate(name, res["summary"], bars["bf16_greedy"][sub])
    for route in ("fused", "default"):
        a = results[f"{route} bf16 greedy"]["summary"]["accuracy"]
        b = results[f"{route} int8 greedy"]["summary"]["accuracy"]
        log(f"quality: int8 costs {route} greedy {100 * (a - b):.2f} exact-"
            f"match points on the card ({a:.4f} bf16, {b:.4f} int8)")



# the fused greedy decode's arms: (variant, int8 resident bundle); the
# index in kernel_counters() of the kernel each launches, and whether it
# launches once a step or once a decode
ARMS = {"v1": ("v1", False), "v2": ("v2", False), "v3": ("v3", False),
        "v4": ("v4", False), "v5 int8": ("v5", True), "v5": ("v5", False)}
ARM_KERNEL = {"v1": (11, True), "v2": (4, True), "v3": (12, True),
              "v4": (12, True), "v5 int8": (14, False), "v5": (13, False)}


def arm_launches(arm, steps):
    counts = [0] * len(kernel_counters())
    index, per_step = ARM_KERNEL[arm]
    counts[index] = steps if per_step else 1
    return counts


def serve_variants(cfg, np_params, tok, entries):
    """Phase 7: the fused greedy decode's A/B arms
    (``greedy_decode_fused(variant=...)``: v1, v2, v3, v4, and v5 with the
    int8 and the bf16 resident bundle) at full width on the fused route's
    encoder memory of the 10-image request (bucket 16), T steps each. Per
    arm: every launch count set to 0 before one decode and checked after;
    the wall of a decode (best of 3), images/s, device busy and idle share
    (one profiled decode), steps; bf16 tokens against v2's (printed). Then
    in float32: the tokens of v1, v3, v4 and v5 (float bundle) equal to
    their plain path's and to v2's; the int8 v5, which rounds its matmul
    inputs to bf16, held by ``hold_decode`` against its plain version.
    Returns {arm: (images/s, idle share, steps)}."""
    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
    from handwritten_math_ocr_api_torch.decode.fused import (
        greedy_decode_fused,
    )
    from handwritten_math_ocr_api_torch.models import model as model_mod
    from handwritten_math_ocr_api_torch.ops import whole_decode as wd

    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (N_IMAGES, cfg.img_h, cfg.img_w, 1),
                          dtype=np.uint8)
    fused = {"use_fused": True, "pallas_encoder_block": True}

    def setup(c):
        engine = DecodeEngine(np_params, c, tokenizer=tok, device=DEVICE,
                              **fused)
        x, _ = engine._pad_batch(images)
        with torch.inference_mode():
            memory = model_mod.encode(engine.params, c, x,
                                      use_pallas_block=True)
        dec = engine.params["decoder"]
        bundles = {arm: (wd.build_resident(dec, c, int8) if v == "v5"
                         else engine.stacked)
                   for arm, (v, int8) in ARMS.items()}
        return dec, memory, bundles

    dec, memory, bundles = setup(cfg)
    summary, tokens = {}, {}
    for arm, (variant, _) in ARMS.items():
        def decode(kernels=True):
            return greedy_decode_fused(dec, bundles[arm], cfg, memory,
                                       variant=variant, kernels=kernels)

        decode()                                   # warm up
        torch.cuda.synchronize()
        reset_counts()
        res = decode()
        torch.cuda.synchronize()
        counts = read_counts()
        expected = arm_launches(arm, res.steps)
        log(f"variant {arm}: {res.steps} steps, launches {counts}, "
            f"expected {expected}")
        check_counts(counts, expected)
        tally(entries, counts, f"variant {arm}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
        log(f"variant {arm}: greedy_decode_fused seconds "
            f"{[round(t, 4) for t in times]}, images/s {N_IMAGES / best:.2f}")
        idle = profile_call(decode, f"greedy_decode_fused variant {arm}",
                            best)
        summary[arm] = (N_IMAGES / best, idle, res.steps)
        tokens[arm] = res.tokens
    for arm in ARMS:
        agree = (tokens[arm] == tokens["v2"]).float().mean().item()
        log(f"variant {arm}: bf16 tokens agree with v2's {agree:.4f} "
            f"(not held)")

    cfg32 = cfg.replace(dtype="float32")
    dec32, m32, bundles32 = setup(cfg32)
    with torch.inference_mode():
        v2 = greedy_decode_fused(dec32, bundles32["v2"], cfg32, m32)
        for arm, (variant, int8) in ARMS.items():
            got = greedy_decode_fused(dec32, bundles32[arm], cfg32, m32,
                                      variant=variant)
            if int8:
                want, logits = wd.fused_whole_decode_plain(
                    bundles32[arm], cfg32, m32, return_logits=True)
                err = hold_decode(f"variant {arm} float32", got, want, logits)
                log(f"variant {arm} float32: log-prob sums max_abs_err "
                    f"{err:.3g} over the rows that agree")
                if err > WHOLE_DECODE_INT8_F32_LP_ATOL:
                    raise AssertionError(f"variant {arm}: float32 log-prob "
                                         f"sums differ by {err}")
                continue
            want = greedy_decode_fused(dec32, bundles32[arm], cfg32, m32,
                                       variant=variant, kernels=False)
            lp_err = (got.logprob_sum - want.logprob_sum).abs().max().item()
            log(f"variant {arm} float32: tokens equal to the plain path "
                f"{torch.equal(got.tokens, want.tokens)}, to v2 "
                f"{torch.equal(got.tokens, v2.tokens)}, over {got.steps} "
                f"steps; log-prob sums max_abs_err {lp_err:.3g}")
            if not (torch.equal(got.tokens, want.tokens)
                    and torch.equal(got.tokens, v2.tokens)):
                raise AssertionError(f"variant {arm}: float32 tokens differ "
                                     f"from the plain path's or v2's")
            # sums of up to 150 float32 log-probs: summation order only
            if lp_err > 1e-2:
                raise AssertionError(f"variant {arm}: float32 log-prob sums "
                                     f"differ by {lp_err}")
    return summary


# phase "serve modes": sampling, constrained greedy, streaming and the
# serving engines of serve/batcher.py
MODES_SEEDS = (11, 12)
MODES_TEMPERATURE = 1.0
MODES_SEGMENTS = (8, 16)


def counted(entries, name, fn, expected_of):
    """Run ``fn`` (which returns the decode steps it ran) with every launch
    count set to 0 before it; check the counts after against
    ``expected_of(steps)``; add them to the entries. Returns fn's steps."""
    reset_counts()
    steps = fn()
    counts = read_counts()
    expected = expected_of(steps)
    log(f"modes {name}: {steps} steps, launches {counts}, expected "
        f"{expected}")
    check_counts(counts, expected)
    tally(entries, counts, f"modes {name}")
    return steps


def route_shape(cfg, route):
    """``expected_launches`` of one encode and its decode on ``route``."""
    return lambda steps: expected_launches(cfg, route, 1, steps)


def boosted_params(c, seed=SEED):
    """Seeded weights with the EOS bias raised (``EOS_BOOST``: rows end at
    1-150 steps) and the PAD bias lowered (a trained model never emits PAD,
    and a PAD token ends a stream segment's harvest: ROADMAP C3)."""
    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import EOS_ID, PAD_ID

    p = convert.random_params(c, seed)
    p["decoder"]["fc_out"]["b"][EOS_ID] += EOS_BOOST
    p["decoder"]["fc_out"]["b"][PAD_ID] = -1e4
    return p


def modes_sampling(cfg, np_params, cut, cut_params, tok, entries, images):
    """Sampling: ``sample_tokens`` of the images on four routes (default
    and fused, float and int8), launch counts; the same seed twice gives
    the same bf16 tokens, two seeds differ; in float32, ``top_k=1`` equals
    the route's greedy tokens. images/s (best of 3) and, on the fused
    routes, the idle share. Returns {route: (images/s, idle)}."""
    import torch

    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine

    fused = {"use_fused": True, "pallas_encoder_block": True}
    routes = {"pallas": (cut, cut_params, {}),
              "pallas_int8": (cut, cut_params, {"quantize": True}),
              "fused": (cfg, np_params, fused),
              "fused_int8": (cfg, np_params, {**fused, "quantize": True})}
    out = {}
    kw = {"temperature": MODES_TEMPERATURE}
    for route, (c, p, rkw) in routes.items():
        engine = DecodeEngine(p, c, tokenizer=tok, device=DEVICE, **rkw)
        engine.sample_tokens(images, seed=MODES_SEEDS[0], **kw)   # warm up
        torch.cuda.synchronize()
        runs = []

        def sample(seed):
            runs.append(engine.sample_tokens(images, seed=seed, **kw))
            torch.cuda.synchronize()
            return engine.last_steps

        counted(entries, f"sample {route}", lambda: sample(MODES_SEEDS[0]),
                route_shape(c, route))
        sample(MODES_SEEDS[0])
        sample(MODES_SEEDS[1])
        if not torch.equal(runs[0].tokens, runs[1].tokens):
            raise AssertionError(f"modes sample {route}: one seed gave "
                                 f"two token sets")
        if torch.equal(runs[0].tokens, runs[2].tokens):
            raise AssertionError(f"modes sample {route}: two seeds gave "
                                 f"the same tokens")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.sample_tokens(images, seed=MODES_SEEDS[0], **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        best = min(walls)
        idle = None
        if engine.use_fused:   # a default-route session takes ~40 s to read
            idle = profile_call(
                lambda: engine.sample_tokens(images, seed=MODES_SEEDS[0],
                                             **kw),
                f"modes sample {route}", best, tries=2)
        out[route] = (len(images) / best, idle)
        log(f"modes sample {route}: seconds {[round(w, 4) for w in walls]}, "
            f"{engine.last_steps} steps, images/s {len(images) / best:.2f}; "
            f"seed {MODES_SEEDS[0]} twice equal, seeds {MODES_SEEDS} differ "
            f"on {(runs[0].tokens != runs[2].tokens).float().mean():.4f} of "
            f"the tokens; first text "
            f"{tok.decode(runs[0].tokens[0].tolist())[:60]!r}")

        c32 = c.replace(dtype="float32")
        e32 = DecodeEngine(p, c32, tokenizer=tok, device=DEVICE, **rkw)
        greedy = e32.decode_tokens(images)
        top1 = e32.sample_tokens(images, top_k=1, seed=MODES_SEEDS[1],
                                 temperature=1.7)
        if not (torch.equal(greedy.tokens, top1.tokens)
                and torch.equal(greedy.token_count, top1.token_count)):
            raise AssertionError(f"modes sample {route}: float32 top_k=1 "
                                 f"tokens differ from greedy's")
        lp = (greedy.logprob_sum - top1.logprob_sum).abs().max().item()
        if lp > 1e-3:
            raise AssertionError(f"modes sample {route}: float32 top_k=1 "
                                 f"log-prob sums differ by {lp}")
        log(f"modes sample {route}: float32 top_k=1 tokens equal greedy's "
            f"over {greedy.steps} steps (log-prob sums within {lp:.3g})")
    return out


def modes_constrained(cfg, np_params, cut, cut_params, tok, entries,
                      images):
    """Constrained greedy: the images on both routes in bf16, launch
    counts, every output valid by the port's ``check_latex``; in float32
    the kernels' tokens equal the plain path's. ``ContinuousDecoder(
    constrained=True)`` on the EOS-boosted weights in float32 (the fused
    route with the ring on and off, and the default route) equal to the
    constrained engine of its route."""
    import torch

    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
    from handwritten_math_ocr_api_torch.decode.fused import (
        greedy_decode_fused,
    )
    from handwritten_math_ocr_api_torch.decode.greedy import greedy_decode
    from handwritten_math_ocr_api_torch.eval.latex_check import check_latex
    from handwritten_math_ocr_api_torch.models import model as model_mod

    fused = {"use_fused": True, "pallas_encoder_block": True}
    routes = {"pallas": (cut, cut_params, {}),
              "fused": (cfg, np_params, fused)}
    for route, (c, p, rkw) in routes.items():
        engine = DecodeEngine(p, c, tokenizer=tok, device=DEVICE,
                              constrained=True, **rkw)
        engine.warmup((len(images),), dtype=images.dtype)
        torch.cuda.synchronize()
        results = []

        def run():
            results.extend(engine.predict_with_confidence(images))
            torch.cuda.synchronize()
            return engine.last_steps

        counted(entries, f"constrained {route}", run, route_shape(c, route))
        invalid = [(f, check_latex(f)[1]) for f, _ in results
                   if not check_latex(f)[0]]
        if invalid:
            raise AssertionError(f"modes constrained {route}: invalid "
                                 f"LaTeX {invalid[:2]}")
        log(f"modes constrained {route}: {len(results)} outputs valid "
            f"LaTeX; first {results[0][0][:60]!r}")

        c32 = c.replace(dtype="float32")
        e32 = DecodeEngine(p, c32, tokenizer=tok, device=DEVICE,
                           constrained=True, **rkw)
        x, n = e32._pad_batch(images[:4])
        dec = e32.params["decoder"]
        with torch.inference_mode():
            mem_k = model_mod.encode(e32.params, c32, x,
                                     use_pallas_block=e32.pallas_encoder_block)
            mem_p = model_mod.encode(e32.params, c32, x, kernels=False,
                                     use_pallas_block=e32.pallas_encoder_block)
            if e32.use_fused:
                r_k, r_p = (greedy_decode_fused(
                    dec, e32.stacked, c32, m, constraint=e32.constraint,
                    kernels=k) for m, k in ((mem_k, True), (mem_p, False)))
            else:
                r_k, r_p = (greedy_decode(
                    dec, c32, m, constraint=e32.constraint, kernels=k)
                    for m, k in ((mem_k, True), (mem_p, False)))
        if not torch.equal(r_k.tokens, r_p.tokens):
            raise AssertionError(f"modes constrained {route}: float32 "
                                 f"tokens differ from the plain path's")
        log(f"modes constrained {route}: float32 tokens equal the plain "
            f"path's over {r_k.steps} steps")

    # continuous, on the EOS-boosted weights, in float32
    cfg32, cut32 = cfg.replace(dtype="float32"), cut.replace(dtype="float32")
    for route, c, kw in (("fused", cfg32, {**fused, "segment_ring": True}),
                         ("fused", cfg32, {**fused, "segment_ring": False}),
                         ("pallas", cut32, {})):
        p = boosted_params(c)
        want = DecodeEngine(p, c, tokenizer=tok, device=DEVICE,
                            constrained=True,
                            **{k: v for k, v in kw.items()
                               if k != "segment_ring"})
        pairs_want = want.predict_with_confidence(images)
        d = continuous_decoder(c, p, tok, constrained=True, **kw)
        reset_counts()
        pairs, res, _ = continuous_traffic(d, images)
        name = (f"constrained {route}"
                + (f" ring {kw['segment_ring']}" if d.use_fused else ""))
        tally(entries, continuous_counts(d, c, route, name),
              f"modes {name}")
        d.close()
        continuous_vs(name, res, want.decode_tokens(images), pairs,
                      pairs_want)


def modes_streaming(cfg, cut, tok, entries, images):
    """Streaming on the EOS-boosted weights, float32: ``predict_stream`` of
    one image (the longest greedy decode that ends) on both routes at
    segments of 8 and 16; the events' tokens equal its greedy tokens and
    the final result ``predict_single``'s; one host read a segment; launch
    counts (the route's encode, then B5 in every layer of every streamed
    step); the time to the first event beside the stream's."""
    import torch

    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine

    out = {}
    for route, c, rkw in (("pallas", cut, {}),
                          ("fused", cfg, {"use_fused": True,
                                          "pallas_encoder_block": True})):
        c32 = c.replace(dtype="float32")
        engine = DecodeEngine(boosted_params(c32), c32, tokenizer=tok,
                              device=DEVICE, **rkw)
        res = engine.decode_tokens(images)
        counts = res.token_count.tolist()
        # the longest decode that ends: the most segments
        ends = [n for n in counts if n < c32.max_seq_len]
        if not ends:
            raise AssertionError(f"modes stream {route}: no image ends")
        at = counts.index(max(ends))
        img = images[at]
        want = [tok.idx2char[t] for t in res.tokens[at, :counts[at]].tolist()]
        latex, conf = engine.predict_single(img)
        for seg in MODES_SEGMENTS:
            list(engine.predict_stream(img, segment_steps=seg))  # warm up
            torch.cuda.synchronize()
            events, stamps = [], []

            def stream():
                reads = engine.stream_reads
                t0 = time.perf_counter()
                for e in engine.predict_stream(img, segment_steps=seg):
                    stamps.append(time.perf_counter() - t0)
                    events.append(e)
                torch.cuda.synchronize()
                segments = engine.stream_reads - reads
                out[(route, seg)] = (stamps[0], time.perf_counter() - t0,
                                     segments)
                return segments * seg

            L = c32.num_decoder_layers

            def shape(steps):
                # the route's encode, then decoder_step: B5 in every layer
                expected = expected_launches(c32, route, 1, 0)
                expected[2] += L * steps
                return expected

            steps = counted(entries, f"stream {route} {seg}", stream, shape)
            streamed = [t for e in events[:-1] for t in e["tokens"]]
            final = events[-1]
            if (streamed != want or final["formula"] != latex
                    or abs(final["confidence"] - conf) > 1e-4):
                raise AssertionError(
                    f"modes stream {route} {seg}: the stream "
                    f"{' '.join(streamed)[:80]!r} / {final} differs from "
                    f"predict_single's {latex[:80]!r}, {conf}")
            if steps // seg != -(-(len(streamed) + 1) // seg):
                raise AssertionError(f"modes stream {route} {seg}: "
                                     f"{steps // seg} host reads for "
                                     f"{len(streamed) + 1} steps")
            first, whole, segments = out[(route, seg)]
            log(f"modes stream {route} {seg}: image {at}, "
                f"{len(streamed)} tokens + EOS, {segments} segments and "
                f"host reads, B5 {L} a step; first event {first * 1e3:.1f} "
                f"ms, the whole stream {whole * 1e3:.1f} ms "
                f"(predict_single's confidence {conf:.4f})")
    return out


def modes_engines(cfg, tok, entries, images):
    """The serving engines over the fused route, float32, EOS-boosted
    weights: 40 concurrent ``predict`` coroutines through ``BatchingEngine``
    (over the fused engine) and ``ContinuousServingEngine`` (over a
    32-slot fused ``ContinuousDecoder``), each result equal to its image
    decoded alone; launch counts; one waiter cancelled: the batcher drops
    it before its dispatch (``cancelled`` 1), the continuous engine frees
    its slot (``cancelled`` 1, every slot free at the end); stats and
    images/s."""
    import asyncio

    import torch

    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
    from handwritten_math_ocr_api_torch.serve.batcher import (
        BatchingEngine,
        ContinuousServingEngine,
    )

    fused = {"use_fused": True, "pallas_encoder_block": True}
    c32 = cfg.replace(dtype="float32")
    p = boosted_params(c32)
    engine = DecodeEngine(p, c32, tokenizer=tok, device=DEVICE, **fused)
    engine.warmup((1, 64))
    alone = [engine.predict_single(img) for img in images]
    # the longest decode among the requests the pool admits first: still
    # in its slot when cancelled
    steps = engine.decode_tokens(images[:CONT_SLOTS]).token_count.tolist()
    longest = steps.index(max(steps))

    def same(name, got):
        bad = [i for i, (g, w) in enumerate(zip(got, alone))
               if g[0] != w[0] or abs(g[1] - w[1]) > 1e-4]
        if bad:
            raise AssertionError(f"modes {name}: results differ from each "
                                 f"image decoded alone in {bad}")

    async def burst(eng, cancel=None):
        await eng.start()
        t0 = time.perf_counter()
        tasks = [asyncio.ensure_future(eng.predict(img)) for img in images]
        if cancel is not None:
            # inside the batcher's linger; mid-decode in a slot
            await asyncio.sleep(0.02)
            tasks[cancel].cancel()
        got = await asyncio.gather(*tasks, return_exceptions=True)
        wall = time.perf_counter() - t0
        await eng.stop()
        return got, wall

    out = {}
    served = CountedEngine(engine)
    batcher = BatchingEngine(served)
    got, wall = asyncio.run(burst(batcher))
    same("batcher", got)
    reset_counts()
    served.calls = served.steps = 0
    batcher = BatchingEngine(served)
    got, wall = asyncio.run(burst(batcher))
    torch.cuda.synchronize()
    counts = read_counts()
    expected = expected_launches(c32, "fused", served.calls, served.steps)
    log(f"modes batcher: {served.calls} decodes, {served.steps} steps, "
        f"launches {counts}, expected {expected}")
    check_counts(counts, expected)
    tally(entries, counts, "modes batcher")
    same("batcher", got)
    st = batcher.stats
    out["batcher"] = len(images) / wall
    log(f"modes batcher: {len(images)} concurrent requests in "
        f"{wall * 1e3:.1f} ms, images/s {len(images) / wall:.2f}; stats "
        f"batches_run {st['batches_run']} avg_batch_size "
        f"{st['avg_batch_size']:.2f} decode "
        f"{st['stages']['decode']['total_sec']:.3f} s queue_wait "
        f"{st['stages']['queue_wait']['total_sec']:.3f} s")
    batcher = BatchingEngine(served, batch_timeout_ms=200.0)
    got, _ = asyncio.run(burst(batcher, cancel=5))
    if not (isinstance(got[5], asyncio.CancelledError)
            and batcher.cancelled == 1
            and batcher.total_batch_occupancy == len(images) - 1):
        raise AssertionError(f"modes batcher: a cancelled waiter was not "
                             f"dropped ({batcher.stats})")
    same("batcher cancel", [g if i != 5 else alone[5]
                            for i, g in enumerate(got)])
    log("modes batcher: the waiter cancelled in the linger window took no "
        "row; cancelled 1")

    for cancel in (None, longest):
        dec = continuous_decoder(c32, p, tok, **fused)
        dec.warmup()
        reset_counts()
        dec.reset_stats()
        dec.inserts = 0
        serving = ContinuousServingEngine(dec)
        got, wall = asyncio.run(burst(serving, cancel=cancel))
        torch.cuda.synchronize()
        name = "continuous engine" + (" cancel" if cancel else "")
        tally(entries, continuous_counts(dec, c32, "fused", name),
              f"modes {name}")
        st = serving.stats
        if cancel is None:
            same(name, got)
            out["continuous"] = len(images) / wall
            log(f"modes {name}: {len(images)} concurrent requests in "
                f"{wall * 1e3:.1f} ms, images/s {len(images) / wall:.2f}; "
                f"stats segments_run {st['segments_run']} avg_occupancy "
                f"{st['avg_occupancy']:.4f} worker_step_s "
                f"{st['worker_step_s']} worker_other_s "
                f"{st['worker_other_s']} worker_iters {st['worker_iters']}")
        else:
            same(name, [g if i != cancel else alone[cancel]
                        for i, g in enumerate(got)])
            if not (isinstance(got[cancel], asyncio.CancelledError)
                    and st["cancelled_waiters"] == 1 and dec.cancelled == 1
                    and dec.idle
                    and sorted(dec._free) == list(range(CONT_SLOTS))):
                raise AssertionError(f"modes {name}: the cancelled "
                                     f"request's slot was not reclaimed "
                                     f"({st})")
            log(f"modes {name}: request {cancel} ({steps[cancel]} tokens "
                f"alone) cancelled in its slot after 20 ms: cancelled 1, "
                f"every slot free after the burst")
    return out


def serve_modes(cfg, tok, entries):
    """Phase "serve modes" (module docstring)."""
    import numpy as np

    from handwritten_math_ocr_api_torch import convert

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    images = rng.integers(0, 256, (N_IMAGES, cfg.img_h, cfg.img_w, 1),
                          dtype=np.uint8)
    many = np.random.default_rng(SEED + 7).integers(
        0, 256, (CONT_IMAGES, cfg.img_h, cfg.img_w, 1), dtype=np.uint8)
    np_params = convert.random_params(cfg, SEED)
    cut = cfg.replace(num_decoder_layers=DEFAULT_ROUTE_LAYERS)
    cut_params = convert.random_params(cut, SEED)
    rates = modes_sampling(cfg, np_params, cut, cut_params, tok, entries,
                           images)
    log(f"modes: sampling seconds {time.perf_counter() - t0:.1f}")
    modes_constrained(cfg, np_params, cut, cut_params, tok, entries, images)
    log(f"modes: constrained seconds {time.perf_counter() - t0:.1f}")
    streams = modes_streaming(cfg, cut, tok, entries, images)
    log(f"modes: streaming seconds {time.perf_counter() - t0:.1f}")
    engines = modes_engines(cfg, tok, entries, many)
    for route, (rate, idle) in rates.items():
        idle_s = "not measured" if idle is None else f"{idle:.3f}"
        log(f"route modes sample {route}: images/s {rate:.2f}, device idle "
            f"share {idle_s}")
    for (route, seg), (first, whole, segments) in streams.items():
        log(f"route modes stream {route} {seg}: first event "
            f"{first * 1e3:.1f} ms, stream {whole * 1e3:.1f} ms, "
            f"{segments} segments")
    for name, rate in engines.items():
        log(f"route modes {name}: images/s {rate:.2f} (float32, "
            f"{CONT_IMAGES} concurrent requests)")
    seconds = time.perf_counter() - t0
    log(f"serve modes: phase seconds {seconds:.1f}")


# ---------------------------------------------------------------------------
# Phase "serve app": the HTTP app on the card
# ---------------------------------------------------------------------------

APP_SEQUENTIAL = 8
APP_CONCURRENT = 32
APP_BATCH = 10
APP_STREAM_SEGMENT = 8
APP_LOAD_REQUESTS = 384   # a window of the printed load: 24 a client
APP_LOAD_CLIENTS = 16
APP_LOAD_WINDOWS = 3      # windows one after another, printed each
APP_UNLIMITED = dict(rate_limit_per_minute=10 ** 6,
                     rate_limit_per_hour=10 ** 6, rate_limit_per_day=10 ** 6,
                     rate_limit_anonymous_daily=10 ** 6,
                     max_concurrent_requests=10 ** 6)


def http_call(port, method, path, body=None, headers=None, timeout=300):
    """One request to 127.0.0.1:port on a fresh connection: (status,
    headers (lower-case names), body bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return (r.status, {k.lower(): v for k, v in r.getheaders()},
                r.read())
    finally:
        conn.close()


def app_json(port, method, path, body=None, headers=None):
    status, _, data = http_call(port, method, path, body, headers)
    if status != 200:
        raise AssertionError(f"app {method} {path}: {status} "
                             f"{data[:300]!r}")
    return json.loads(data)


def app_predict(port, png, path="/predict", multipart=False):
    """POST one PNG as JSON base64 (or a multipart upload): the reply's
    JSON, or a stream's events."""
    import base64

    if multipart:
        boundary = "mathocr-smoke-boundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="file"; filename="x.png"\r\nContent-Type: image/png'
                f"\r\n\r\n").encode() + png + f"\r\n--{boundary}--\r\n" \
            .encode()
        ctype = f"multipart/form-data; boundary={boundary}"
    else:
        body = json.dumps({"image_data": base64.b64encode(png).decode()})
        ctype = "application/json"
    status, headers, data = http_call(port, "POST", path, body,
                                      {"Content-Type": ctype})
    if status != 200 or "x-request-id" not in headers:
        raise AssertionError(f"app POST {path}: {status} {data[:300]!r}")
    if path.startswith("/predict/stream"):
        return [json.loads(line[len("data: "):])
                for line in data.decode().splitlines()
                if line.startswith("data: ")]
    return json.loads(data)


def app_model_dir(dtype):
    """A serving artifact of the shipped weights with ``dtype`` in its
    config: ``vocab.json`` copied, ``params`` linked, in a temporary
    directory (the caller removes it)."""
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="serve_app_")
    shutil.copy(os.path.join(MODEL_DIR, "vocab.json"), d)
    os.symlink(os.path.join(MODEL_DIR, "params"), os.path.join(d, "params"))
    with open(os.path.join(MODEL_DIR, "model_config.json")) as f:
        raw = json.load(f)
    raw["dtype"] = dtype
    with open(os.path.join(d, "model_config.json"), "w") as f:
        json.dump(raw, f)
    return d


def app_server(model_dir, **kw):
    """The port's app (``serve/app.create_app``) on 127.0.0.1, an
    ephemeral port, served from a thread of this process."""
    from handwritten_math_ocr_api_torch.core.config import ServeConfig
    from handwritten_math_ocr_api_torch.serve.app import create_app
    from handwritten_math_ocr_api_torch.serve.http import ServerThread

    cfg = ServeConfig(model_dir=model_dir, **{**APP_UNLIMITED, **kw})
    server = ServerThread(create_app(cfg, device=DEVICE), "127.0.0.1", 0)
    state = server.app["state"]
    if state.engine is None:
        server.stop()
        raise AssertionError("app: the model did not load (see the log)")
    return server, state


class CallLog:
    """The decodes an engine ran, recorded from any thread: (kind, steps)
    with kind greedy, beam or sample (one encode each)."""

    def __init__(self, engine):
        import threading

        self.calls = []
        self._lock = threading.Lock()
        decode_tokens, sample_tokens = engine.decode_tokens, \
            engine.sample_tokens

        def counted_decode(images, beam_size=None):
            res = decode_tokens(images, beam_size)
            self._add("beam" if beam_size and beam_size > 1 else "greedy",
                      res.steps)
            return res

        def counted_sample(images, **kw):
            res = sample_tokens(images, **kw)
            self._add("sample", res.steps)
            return res

        engine.decode_tokens = counted_decode
        engine.sample_tokens = counted_sample

    def _add(self, kind, steps):
        with self._lock:
            self.calls.append((kind, steps))

    def take(self):
        with self._lock:
            out, self.calls = self.calls, []
        return out


def stream_steps(n_tokens, seg=APP_STREAM_SEGMENT):
    """A stream's decoder steps: whole segments up to its EOS step."""
    return seg * -(-(n_tokens + 1) // seg)


def app_expected(cfg, calls, streams=()):
    """The launches of the decodes in ``calls`` and of streams of the
    given token counts on the fused route: per decode its encode and one
    B1 a greedy or sampled step, one B7 and one B8 a beam step; per
    stream its encode and B5 in every layer of every step."""
    total = [0] * len(kernel_counters())
    for kind, steps in calls:
        one = expected_launches(cfg, "fused", 1, steps, beam=kind == "beam")
        total = [a + b for a, b in zip(total, one)]
    for n in streams:
        one = expected_launches(cfg, "fused", 1, 0)
        one[2] += cfg.num_decoder_layers * stream_steps(n)
        total = [a + b for a, b in zip(total, one)]
    return total


def app_check_counts(entries, name, cfg, calls, streams=()):
    counts = read_counts()
    expected = app_expected(cfg, calls, streams)
    log(f"app {name}: {len(calls)} decodes "
        f"{sorted(set(k for k, _ in calls))}, {sum(s for _, s in calls)} "
        f"steps, {len(streams)} streams; launches {counts}, expected "
        f"{expected}")
    check_counts(counts, expected)
    tally(entries, counts, f"app {name}")


def same_result(name, got, want, tol):
    """got: a /predict reply; want: (latex, confidence or None)."""
    conf = got["confidence"]
    ok = got["formula"] == want[0] and (
        (conf is None and want[1] is None)
        or (conf is not None and want[1] is not None
            and abs(conf - want[1]) <= tol))
    if not ok:
        raise AssertionError(f"app {name}: {got['formula'][:80]!r} "
                             f"{conf} != {want[0][:80]!r} {want[1]}")


def app_pool(n, fn, args):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(n) as ex:
        return list(ex.map(fn, args))


def app_dynamic(cfg, tok, entries, pngs, images):
    """The float32 app, dynamic batching, fused route: every route and the
    mixed-concurrency check (module docstring, phase 10)."""
    import torch

    from handwritten_math_ocr_api_torch.core.tokenizer import (
        clean_latex_output,
    )
    from handwritten_math_ocr_api_torch.models.model import count_params
    from handwritten_math_ocr_api_torch.train.checkpoint import (
        leaves_with_paths,
        load_params_for_serving,
    )

    import base64

    d = app_model_dir("float32")
    server = None
    try:
        t0 = time.perf_counter()
        server, state = app_server(d, use_fused_decode=True,
                                   pallas_encoder_block=True,
                                   warmup_batch_sizes=(1,))
        port, engine = server.port, state.engine
        c32 = state.model_cfg
        log(f"app: float32 app up on port {port} in "
            f"{time.perf_counter() - t0:.1f} s (fused route)")
        health = app_json(port, "GET", "/health")
        status = app_json(port, "GET", "/status")
        info = app_json(port, "GET", "/model/info")
        tree = load_params_for_serving(d)[0]
        n_params = sum(x.numel() if hasattr(x, "numel") else x.size
                       for _, x in leaves_with_paths(tree))
        if not (health["healthy"] and status["device"] == DEVICE
                and info["device"] == DEVICE
                and info["model_parameters"] == n_params
                == count_params(tree)):
            raise AssertionError(f"app: /health {health}, /status "
                                 f"{status}, /model/info {info}, the tree "
                                 f"{n_params} parameters")
        log(f"app: /health healthy, /status device {status['device']}, "
            f"/model/info {info['model_parameters']} parameters (the "
            f"tree's {n_params})")
        calls = CallLog(engine)
        alone = [engine.predict_single(img) for img in images]
        beam_alone = [clean_latex_output(engine.predict_batch(
            img[None], beam_size=BEAM)[0]) for img in images[:2]]
        calls.take()

        # one after another: each equal to its direct engine call
        for i in range(APP_SEQUENTIAL):
            reset_counts()
            got = app_predict(port, pngs[i], multipart=i % 2 == 0)
            torch.cuda.synchronize()
            app_check_counts(entries, f"sequential {i}", c32, calls.take())
            same_result(f"sequential {i}", got, alone[i], 1e-6)
        log(f"app: {APP_SEQUENTIAL} requests one after another (multipart "
            f"and base64) equal to predict_single, confidence within 1e-6")

        # concurrent: the batcher coalesces them
        reset_counts()
        t0 = time.perf_counter()
        got = app_pool(APP_CONCURRENT, lambda i: app_predict(
            port, pngs[i]), range(APP_CONCURRENT))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        app_check_counts(entries, "concurrent", c32, calls.take())
        for i, g in enumerate(got):
            same_result(f"concurrent {i}", g, alone[i], 1e-4)
        log(f"app: {APP_CONCURRENT} concurrent requests equal to each "
            f"image alone in {wall * 1e3:.1f} ms")

        # /predict/batch with a bad entry
        entries_b64 = [base64.b64encode(p).decode()
                       for p in pngs[:APP_BATCH - 1]]
        entries_b64.insert(3, "%%%bad")  # 10 entries, the most a batch takes
        reset_counts()
        batch = app_json(port, "POST", "/predict/batch",
                         json.dumps({"images": entries_b64}),
                         {"Content-Type": "application/json"})
        app_check_counts(entries, "batch", c32, calls.take())
        want = engine.predict_with_confidence(images[:APP_BATCH - 1])
        calls.take()
        good = [r for r in batch["results"] if r["success"]]
        if (batch["successful_predictions"] != APP_BATCH - 1
                or batch["total_images"] != APP_BATCH
                or batch["results"][3]["success"]):
            raise AssertionError(f"app batch: {batch}")
        for i, (g, w) in enumerate(zip(good, want)):
            same_result(f"batch {i}", g, w, 1e-6)
        log(f"app: /predict/batch of {APP_BATCH} entries, one bad: "
            f"{batch['successful_predictions']} equal to "
            f"predict_with_confidence")

        # beam, top_k=1, stream
        for i in range(2):
            reset_counts()
            got = app_predict(port, pngs[i], f"/predict?beam_size={BEAM}")
            torch.cuda.synchronize()
            app_check_counts(entries, f"beam {i}", c32, calls.take())
            same_result(f"beam {i}", got, (beam_alone[i], None), 0)
            reset_counts()
            got = app_predict(port, pngs[i], "/predict?top_k=1&seed=5")
            torch.cuda.synchronize()
            app_check_counts(entries, f"top_k=1 {i}", c32, calls.take())
            same_result(f"top_k=1 {i}", got, alone[i], 1e-5)
        stream_alone = []
        for i in range(2):
            reads = engine.stream_reads
            reset_counts()
            events = app_predict(port, pngs[i], "/predict/stream?"
                                 f"segment_steps={APP_STREAM_SEGMENT}")
            torch.cuda.synchronize()
            n = sum(len(e.get("tokens", ())) for e in events)
            app_check_counts(entries, f"stream {i}", c32, calls.take(),
                             [n])
            final = events[-1]
            if not final.get("done") or engine.stream_reads - reads != \
                    stream_steps(n) // APP_STREAM_SEGMENT:
                raise AssertionError(f"app stream {i}: {final}, "
                                     f"{engine.stream_reads - reads} reads "
                                     f"for {n} tokens")
            same_result(f"stream {i}", final, alone[i], 1e-5)
            stream_alone.append(n)
        log(f"app: beam {BEAM} equal to predict_batch(beam_size={BEAM}), "
            f"top_k=1 to greedy, streams of segments of "
            f"{APP_STREAM_SEGMENT} to /predict with one host read a "
            f"segment")

        # mixed concurrency: the engine's launches from the batcher's and
        # several executor threads at once
        jobs = ([("greedy", i) for i in range(8)]
                + [("beam", i) for i in range(2)]
                + [("top1", i) for i in range(2)]
                + [("stream", i) for i in range(2)])
        paths = {"greedy": "/predict", "beam": f"/predict?beam_size={BEAM}",
                 "top1": "/predict?top_k=1&seed=5",
                 "stream": "/predict/stream?segment_steps="
                           f"{APP_STREAM_SEGMENT}"}
        reset_counts()
        got = app_pool(len(jobs), lambda job: app_predict(
            port, pngs[job[1]], paths[job[0]]), jobs)
        torch.cuda.synchronize()
        streams = [sum(len(e.get("tokens", ())) for e in g)
                   for (kind, _), g in zip(jobs, got) if kind == "stream"]
        app_check_counts(entries, "mixed", c32, calls.take(), streams)
        for (kind, i), g in zip(jobs, got):
            if kind == "beam":
                same_result(f"mixed beam {i}", g, (beam_alone[i], None), 0)
            elif kind == "stream":
                same_result(f"mixed stream {i}", g[-1], alone[i], 1e-4)
            else:
                same_result(f"mixed {kind} {i}", g, alone[i], 1e-4)
        if streams != stream_alone:
            raise AssertionError(f"app mixed: streams of {streams} tokens, "
                                 f"alone {stream_alone}")
        metrics = app_json(port, "GET", "/metrics")
        st = metrics["batching"]
        if st["mode"] != "dynamic" or st["batches_run"] < 1 or \
                st["images_decoded"] < APP_SEQUENTIAL + APP_CONCURRENT:
            raise AssertionError(f"app /metrics: {metrics}")
        log(f"app: mixed concurrency ({len(jobs)} requests: 8 greedy, 2 "
            f"beam {BEAM}, 2 top_k=1, 2 streams) each equal to its result "
            f"alone; /metrics batches_run {st['batches_run']} "
            f"images_decoded {st['images_decoded']} avg_batch_size "
            f"{st['avg_batch_size']:.2f}, predictions "
            f"{metrics['predictions']['total']}")
    finally:
        if server is not None:
            server.stop()
        import shutil

        shutil.rmtree(d, ignore_errors=True)


def app_continuous(cfg, tok, entries, pngs, images):
    """The float32 app with ``batching_mode="continuous"`` (fused, 32
    slots): 32 concurrent requests each equal to its image alone, launch
    counts; a client that disconnects mid-decode frees its slot."""
    import base64
    import socket

    import torch

    d = app_model_dir("float32")
    server = None
    try:
        server, state = app_server(d, use_fused_decode=True,
                                   pallas_encoder_block=True,
                                   batching_mode="continuous",
                                   num_slots=CONT_SLOTS)
        port, engine = server.port, state.engine
        c32 = state.model_cfg
        dec = state.batcher.decoder
        alone = [engine.predict_single(img) for img in images]
        counts = engine.decode_tokens(images).token_count.tolist()
        dec.inserts = 0
        insert = dec._insert

        def counted_insert(slots, imgs):
            dec.inserts += 1
            return insert(slots, imgs)

        dec._insert = counted_insert
        dec.reset_stats()
        reset_counts()
        t0 = time.perf_counter()
        got = app_pool(APP_CONCURRENT, lambda i: app_predict(
            port, pngs[i]), range(APP_CONCURRENT))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        tally(entries, continuous_counts(dec, c32, "fused", "app"),
              "app continuous")
        for i, g in enumerate(got):
            same_result(f"continuous {i}", g, alone[i], 1e-4)
        log(f"app continuous: {APP_CONCURRENT} concurrent requests equal to "
            f"each image alone in {wall * 1e3:.1f} ms; segments_run "
            f"{dec.segments_run}")

        # a client that disconnects while its request holds a slot: the
        # longest decode
        longest = counts.index(max(counts))
        body = json.dumps({"image_data": base64.b64encode(
            pngs[longest]).decode()}).encode()
        before = dec.cancelled
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\nContent-Type: "
                  b"application/json\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body)
        deadline = time.perf_counter() + 30
        while dec.stats["active_slots"] < 1:
            if time.perf_counter() > deadline:
                raise AssertionError("app continuous: the request never "
                                     "took a slot")
            time.sleep(0.0005)
        s.close()
        deadline = time.perf_counter() + 30
        while not (dec.cancelled > before and dec.idle):
            if time.perf_counter() > deadline:
                raise AssertionError(f"app continuous: the disconnected "
                                     f"request's slot was not freed "
                                     f"({dec.stats})")
            time.sleep(0.01)
        stats = app_json(port, "GET", "/metrics")["batching"]
        if stats["cancelled_waiters"] != 1 or stats["active_slots"] != 0:
            raise AssertionError(f"app continuous: {stats}")
        log(f"app continuous: a client that disconnected mid-decode "
            f"(request {longest}, {counts[longest]} tokens alone) freed its "
            f"slot: cancelled {dec.cancelled - before}, cancelled_waiters "
            f"{stats['cancelled_waiters']}, active_slots "
            f"{stats['active_slots']}")
    finally:
        if server is not None:
            server.stop()
        import shutil

        shutil.rmtree(d, ignore_errors=True)


def host_cpu():
    """The host's CPU model and vendor (``/proc/cpuinfo``'s first ``model
    name`` and ``vendor_id``, as that file gives them) and load
    averages."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = (f"{fields.get('model name', 'not read')} (vendor_id "
             f"{fields.get('vendor_id', 'not read')})")
    return model, os.getloadavg()


def app_load(pngs, windows=APP_LOAD_WINDOWS):
    """Printed, not gated: the shipped bf16 weights on the fused route,
    dynamic batching; one client's requests one after another (a single
    request's round trip), then ``windows`` windows one after another, in
    each ``APP_LOAD_CLIENTS`` clients each sending its next request as
    soon as the last one answers, ``APP_LOAD_REQUESTS`` in all:
    requests/s, p50/p95 latency and the stages of a request and a batch,
    for each window and over all of them. Returns (requests/s, p50, p95)
    over all windows and the windows' (requests/s, p50, p95, input ms)."""
    import numpy as np

    server, state = app_server(MODEL_DIR, use_fused_decode=True,
                               pallas_encoder_block=True,
                               warmup_batch_sizes=(1, 16))
    per_client = APP_LOAD_REQUESTS // APP_LOAD_CLIENTS
    runs = []
    try:
        port = server.port
        for png in pngs[:APP_LOAD_CLIENTS]:  # warm: builds, allocator
            app_predict(port, png)
        app_pool(APP_LOAD_CLIENTS, lambda i: app_predict(port, pngs[i]),
                 range(APP_LOAD_CLIENTS))
        single = []  # one client: a request's whole round trip
        for png in pngs[:APP_LOAD_CLIENTS]:
            t0 = time.perf_counter()
            app_predict(port, png)
            single.append(time.perf_counter() - t0)
        batcher = state.batcher

        def client(c):
            out = []
            for k in range(per_client):
                png = pngs[(c * per_client + k) % len(pngs)]
                t0 = time.perf_counter()
                app_predict(port, png)
                out.append(time.perf_counter() - t0)
            return out

        for _ in range(windows):
            state.request_timer.reset()  # each window's own stats
            batcher.timer.reset()
            batcher.batches_run = batcher.images_decoded = 0
            batcher.total_batch_occupancy = 0
            latencies = []
            t0 = time.perf_counter()
            for lat in app_pool(APP_LOAD_CLIENTS, client,
                                range(APP_LOAD_CLIENTS)):
                latencies += lat
            wall = time.perf_counter() - t0
            runs.append((np.array(latencies) * 1e3, wall,
                         app_json(port, "GET", "/metrics")))
    finally:
        server.stop()
    one = np.array(single) * 1e3
    log(f"app one client (bf16, fused): {len(one)} requests one after "
        f"another, latency p50 {np.percentile(one, 50):.1f} ms, min "
        f"{one.min():.1f} ms, max {one.max():.1f} ms")
    out = []
    for i, (lat, wall, metrics) in enumerate(runs):
        st, stages = metrics["batching"], metrics["request_stages"]
        bst = st["stages"]
        out.append((len(lat) / wall, float(np.percentile(lat, 50)),
                    float(np.percentile(lat, 95)),
                    stages["input"]["mean_sec"] * 1e3))
        log(f"app load window {i + 1} (bf16, fused, dynamic): {len(lat)} "
            f"requests from {APP_LOAD_CLIENTS} closed-loop clients in "
            f"{wall:.3f} s: requests/s {out[-1][0]:.2f}, latency p50 "
            f"{out[-1][1]:.1f} ms p95 {out[-1][2]:.1f} ms; batches_run "
            f"{st['batches_run']} avg_batch_size {st['avg_batch_size']:.2f}")
        log(f"app load window {i + 1} stages: a request's input (body to "
            f"uint8 pixels, in the executor) {out[-1][3]:.1f} ms and decode "
            f"(queued and decoded in its batch) "
            f"{stages['decode']['mean_sec'] * 1e3:.1f} ms on average; a "
            f"batch's decode {bst['decode']['mean_sec'] * 1e3:.1f} ms "
            f"({bst['decode']['count']} batches), an image's queue wait "
            f"{bst['queue_wait']['mean_sec'] * 1e3:.1f} ms")
    lat = np.concatenate([r[0] for r in runs])
    rate = len(lat) / sum(r[1] for r in runs)
    p50, p95 = (float(np.percentile(lat, q)) for q in (50, 95))
    log(f"app load, {len(runs)} windows: {len(lat)} requests, requests/s "
        f"{rate:.2f} (windows {min(r[0] for r in out):.2f}-"
        f"{max(r[0] for r in out):.2f}), latency p50 {p50:.1f} ms "
        f"(windows {min(r[1] for r in out):.1f}-"
        f"{max(r[1] for r in out):.1f}) p95 {p95:.1f} ms (windows "
        f"{min(r[2] for r in out):.1f}-{max(r[2] for r in out):.1f})")
    model, load = host_cpu()
    log(f"app load: on {nvidia_smi_line()}; host CPU {model}, "
        f"{os.cpu_count()} cores, load average {load[0]:.2f} "
        f"{load[1]:.2f} {load[2]:.2f}")
    return (rate, p50, p95), out


def serve_app(cfg, tok, entries):
    """Phase "serve app" (module docstring)."""
    import glob

    from handwritten_math_ocr_api_torch.data.png import decode_png

    t0 = time.perf_counter()
    paths = sorted(glob.glob(os.path.join(QUALITY_DATA, "test_formulas",
                                          "*.png")))[:APP_CONCURRENT]
    pngs = []
    for p in paths:
        with open(p, "rb") as f:
            pngs.append(f.read())
    images = [decode_png(b)[..., None] for b in pngs]
    app_dynamic(cfg, tok, entries, pngs, images)
    log(f"app: dynamic seconds {time.perf_counter() - t0:.1f}")
    app_continuous(cfg, tok, entries, pngs, images)
    log(f"app: continuous seconds {time.perf_counter() - t0:.1f}")
    (rate, p50, p95), _ = app_load(pngs)
    log(f"route app load bf16: requests/s {rate:.2f}, p50 {p50:.1f} ms, "
        f"p95 {p95:.1f} ms")
    log(f"serve app: phase seconds {time.perf_counter() - t0:.1f}")



TRAIN_FIXTURE = os.path.join(REPO_ROOT, "tests", "fixtures",
                             "torch_r4_train.json")
TRAIN_PARITY_IMAGES = 256
# (a): eval loss, grad norm and post-step loss within 1e-3 relative and the
# token accuracy within 0.002 of the JAX package's float32 CPU values
TRAIN_PARITY_RTOL = 1e-3
TRAIN_ACC_ATOL = 0.002
TRAIN_BATCH = 64
TRAIN_STEPS = 100
TRAIN_WARMUP = 50          # the learning rate's linear warmup steps
TRAIN_TIMED_FROM = 20      # steps before the host clock starts
TRAIN_WINDOW = 20          # the loss is averaged over the first and last
# the mean loss of the last TRAIN_WINDOW steps must lie this far under
# that of the first TRAIN_WINDOW: on an H100 the losses fell from a mean
# of 4.02 over steps 0-19 to about 2.8 at steps 80-99, 2.71 at 100-119
# and 2.59 at 180-199
TRAIN_LOSS_MARGIN = 1.0
TRAIN_WORKERS = 6          # loader threads (the machine has 8 cores)
TRAIN_DROPOUT = 0.1        # decoder dropout and Swin stochastic depth
RESUME_BATCH = 16
RESUME_AT = 3
RESUME_STEPS = 5
SERVE_TRAINED_IMAGES = 16


def _torch_tree(tree, dev):
    """Nested dicts/lists of numpy arrays -> float32 tensors on ``dev``."""
    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch.utils.tree import map_tree

    return map_tree(lambda a: (a if torch.is_tensor(a) else torch.from_numpy(
        np.array(a))).float().to(dev), tree)


def close_rel(name, got, want, rtol):
    if abs(got - want) > rtol * abs(want):
        raise AssertionError(f"{name}: {got} against {want} (JAX), beyond "
                             f"{rtol} relative")


def train_parity():
    """Phase 11 (a): the shipped weights in float32 (TF32 off) on the first
    TRAIN_PARITY_IMAGES test images, batches of 64, no augmentation,
    dropout and stochastic depth 0, against ``tests/fixtures/
    torch_r4_train.json`` (JAX on the CPU): the eval step's mean loss and
    the token accuracy, through the encoder's float32 kernels (their
    launches counted: B2 in every block and B3 at every merge of each
    encode); the first batch's gradient norm of one train step (no kernel
    launched) and its eval loss after that Adam step."""
    import dataclasses

    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch.core.config import TrainConfig
    from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
    from handwritten_math_ocr_api_torch.data.preprocess import normalize
    from handwritten_math_ocr_api_torch.train.checkpoint import (
        load_params_for_serving,
    )
    from handwritten_math_ocr_api_torch.train.optim import make_optimizer
    from handwritten_math_ocr_api_torch.train.step import (
        make_eval_step,
        make_train_step,
        state_from_params,
    )

    with open(TRAIN_FIXTURE) as f:
        fixture = json.load(f)
    dev = torch.device(DEVICE)
    params, _, vocab, idx2char, cfg = load_params_for_serving(MODEL_DIR)
    tok = Tokenizer(vocab, idx2char)
    c32 = cfg.replace(dtype="float32", dropout=0.0,
                      swin=dataclasses.replace(cfg.swin,
                                               stochastic_depth=0.0))
    tc = TrainConfig(learning_rate=fixture["learning_rate"],
                     label_smoothing=fixture["label_smoothing"],
                     grad_clip_norm=fixture["grad_clip_norm"])
    opt = make_optimizer(tc)

    def fresh():
        return state_from_params(_torch_tree(params, dev), opt, tc)

    eval_step = make_eval_step(c32, tc, device=dev)
    batches = list(quality_loader(tok, c32, TRAIN_PARITY_IMAGES))
    state = fresh()
    reset_counts()
    losses, correct, count = [], 0, 0
    for b in batches:
        loss, preds = eval_step(state, b["image"], b["caption"])
        losses.append(float(loss))
        tgt = b["caption"][:, 1:]
        mask = tgt != 0
        correct += int(((preds.cpu().numpy() == tgt) & mask).sum())
        count += int(mask.sum())
    check_counts(read_counts(), expected_launches(c32, "pallas",
                                                  len(batches), 0))
    first = batches[0]
    reset_counts()
    state, m = make_train_step(c32, tc, opt, device=dev)(
        state, normalize(first["image"]), first["caption"], SEED)
    check_counts(read_counts(), [0] * len(kernel_counters()))
    after, _ = eval_step(state, first["image"], first["caption"])
    got = {"eval_loss": float(np.mean(losses)),
           "token_accuracy": correct / count,
           "grad_norm": float(m["grad_norm"]),
           "loss_after_step": float(after)}
    want = {"eval_loss": fixture["eval_loss"],
            "token_accuracy": fixture["token_accuracy"],
            "grad_norm": fixture["first_batch"]["grad_norm"],
            "loss_after_step": fixture["first_batch"]["loss_after_step"]}
    log(f"train parity (float32, {len(batches) * QUALITY_BATCH} images): "
        f"port {got}, JAX {want}")
    for k in ("eval_loss", "grad_norm", "loss_after_step"):
        close_rel(f"train parity {k}", got[k], want[k], TRAIN_PARITY_RTOL)
    if abs(got["token_accuracy"] - want["token_accuracy"]) > TRAIN_ACC_ATOL:
        raise AssertionError(f"train parity token accuracy "
                             f"{got['token_accuracy']} against "
                             f"{want['token_accuracy']} (JAX)")


def train_stream(cfg, tok, n, seed, batch):
    """A loader of ``n`` synthetic stream samples (the typeset renderer)
    at ``cfg``'s size, batches of ``batch``, on TRAIN_WORKERS threads."""
    from handwritten_math_ocr_api_torch.data.dataset import DataLoader
    from handwritten_math_ocr_api_torch.data.synthetic import (
        SyntheticStreamDataset,
    )

    ds = SyntheticStreamDataset(tok, n, cfg.img_h, cfg.img_w,
                                cfg.max_seq_len, seed=seed)
    return DataLoader(ds, batch, num_workers=TRAIN_WORKERS,
                      drop_remainder=True)


def train_full_width(cfg, tok, dev):
    """Phase 11 (b): training at full width in bf16 from a fresh model
    (Swin-T, d_model 256, 8 decoder layers, ``memory_norm``; the grammar
    vocab; dropout and stochastic depth at TRAIN_DROPOUT), batch 64 of
    the synthetic stream, uint8 images augmented in the step, warmup
    TRAIN_WARMUP. No kernel launches in the train steps; the loss must
    fall by TRAIN_LOSS_MARGIN; images/s and ms a step on the host clock
    after TRAIN_TIMED_FROM steps, the loader's wait a step, the device's
    idle share of a profiled step, the peak of allocated device memory;
    then one eval step, whose encode launches B2 and B3. Returns the
    state."""
    import torch

    from handwritten_math_ocr_api_torch.core.config import (
        DataConfig,
        TrainConfig,
    )
    from handwritten_math_ocr_api_torch.train.step import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    tc = TrainConfig(warmup_steps=TRAIN_WARMUP)
    state, opt = create_train_state(cfg, tc, SEED, dev)
    step = make_train_step(cfg, tc, opt, DataConfig(), device=dev)
    loader = train_stream(cfg, tok, TRAIN_STEPS * TRAIN_BATCH, SEED,
                          TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, waits = [], []
    it = iter(loader)
    t_start = None
    try:
        for i in range(TRAIN_STEPS):
            if i == TRAIN_TIMED_FROM:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            t0 = time.perf_counter()
            batch = next(it)
            if i >= TRAIN_TIMED_FROM:
                waits.append(time.perf_counter() - t0)
            state, m = step(state, batch["image"], batch["caption"], SEED)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t_start
    finally:
        it.close()
    check_counts(read_counts(), [0] * len(kernel_counters()))
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu()
    head = float(losses[:TRAIN_WINDOW].mean())
    tail = float(losses[-TRAIN_WINDOW:].mean())
    timed = TRAIN_STEPS - TRAIN_TIMED_FROM
    ms = elapsed / timed * 1e3
    log(f"train full width: {TRAIN_STEPS} steps of {TRAIN_BATCH}, mean loss "
        f"of the first {TRAIN_WINDOW} {head:.4f}, of the last "
        f"{TRAIN_WINDOW} {tail:.4f} (fall {head - tail:.4f}, gate "
        f"{TRAIN_LOSS_MARGIN}); images/s {timed * TRAIN_BATCH / elapsed:.1f}"
        f" ms a step {ms:.1f} (host clock over {timed} steps), loader wait "
        f"a step {sum(waits) / len(waits) * 1e3:.2f} ms, "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; losses every 20 "
        f"steps {[round(float(x), 4) for x in losses[::20]]}")
    idle = profile_call(
        lambda: step(state, batch["image"], batch["caption"], SEED),
        "one train step", ms / 1e3, tries=1)
    log(f"train full width: device idle share of a profiled step "
        f"{'not measured' if idle is None else f'{idle:.3f}'}")
    if not head - tail > TRAIN_LOSS_MARGIN:
        raise AssertionError(f"train full width: the loss fell by "
                             f"{head - tail:.4f}, not more than "
                             f"{TRAIN_LOSS_MARGIN}")
    reset_counts()
    make_eval_step(cfg, tc, device=dev)(state, batch["image"],
                                        batch["caption"])
    check_counts(read_counts(), expected_launches(cfg, "pallas", 1, 0))
    log("train full width: no kernel launched in the train steps; the eval "
        "step's encode launched B2 and B3 as counted")
    return state


def train_resume(cfg, tok, dev):
    """Phase 11 (c): float32 at full width (batch RESUME_BATCH, warmup, EMA):
    a run saved after RESUME_AT steps and restored into a fresh state of
    other weights takes the next RESUME_STEPS steps with the losses of an
    uninterrupted run, bit for bit (deterministic algorithms on)."""
    import tempfile

    import torch

    from handwritten_math_ocr_api_torch.core.config import TrainConfig
    from handwritten_math_ocr_api_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from handwritten_math_ocr_api_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    c32 = cfg.replace(dtype="float32")
    tc = TrainConfig(warmup_steps=TRAIN_WARMUP, ema_decay=0.999)
    n = RESUME_AT + RESUME_STEPS
    batches = list(train_stream(c32, tok, n * RESUME_BATCH, SEED + 1,
                                RESUME_BATCH))

    def run(state, step, bs):
        out = []
        for b in bs:
            state, m = step(state, b["image"], b["caption"], SEED)
            out.append(float(m["loss"]))
        return state, out

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state, opt = create_train_state(c32, tc, SEED + 1, dev)
        step = make_train_step(c32, tc, opt, device=dev)
        _, whole = run(state, step, batches)
        state, _ = create_train_state(c32, tc, SEED + 1, dev)
        state, _ = run(state, step, batches[:RESUME_AT])
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, "resume", state, 0, 0.0)
            fresh, _ = create_train_state(c32, tc, SEED + 2, dev)
            state, _ = load_checkpoint(d, "resume", fresh)
        _, resumed = run(state, step, batches[RESUME_AT:])
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"train resume: losses of steps {RESUME_AT}-{n - 1} uninterrupted "
        f"{whole[RESUME_AT:]}, resumed {resumed}")
    if resumed != whole[RESUME_AT:]:
        raise AssertionError("train resume: the resumed losses differ from "
                             "the uninterrupted run's")


def train_serve(state, cfg, tok, dev):
    """Phase 11 (d): the trained weights written with
    ``save_params_for_serving`` and read back by ``load_params_for_serving``
    bit for bit (``tree_digest``), then served by ``DecodeEngine`` in
    float32 on the default and the fused route: SERVE_TRAINED_IMAGES stream
    images, the two routes' tokens equal."""
    import tempfile

    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch.data.preprocess import normalize
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
    from handwritten_math_ocr_api_torch.train.checkpoint import (
        load_params_for_serving,
        save_params_for_serving,
        tree_digest,
    )

    with tempfile.TemporaryDirectory() as d:
        save_params_for_serving(d, state.eval_params, tok.vocab, cfg)
        params, _, vocab, _, cfg2 = load_params_for_serving(d)
    if tree_digest(params) != tree_digest(state.eval_params):
        raise AssertionError("train serve: the artifact's tree is not the "
                             "saved one")
    if vocab != tok.vocab or cfg2 != cfg:
        raise AssertionError("train serve: vocab or config changed")
    batch = next(iter(train_stream(cfg, tok, SERVE_TRAINED_IMAGES, SEED + 3,
                                   SERVE_TRAINED_IMAGES)))
    images = normalize(batch["image"])
    c32 = cfg.replace(dtype="float32")
    out = {}
    for route, kw in (("default", {}),
                      ("fused", {"use_fused": True,
                                 "pallas_encoder_block": True})):
        engine = DecodeEngine(params, c32, tokenizer=tok, device=dev, **kw)
        reset_counts()
        res = engine.decode_tokens(images)
        torch.cuda.synchronize()
        out[route] = res.tokens.cpu()
        log(f"train serve {route}: {engine.last_steps} steps, launches "
            f"{read_counts()}, first prediction "
            f"{tok.decode(out[route][0].tolist())!r}")
    agree = (out["default"] == out["fused"]).float().mean().item()
    log(f"train serve: float32 tokens of the two routes agree {agree:.4f}; "
        f"targets {tok.decode(np.asarray(batch['caption'][0]).tolist())!r}")
    if not torch.equal(out["default"], out["fused"]):
        raise AssertionError("train serve: the routes' float32 tokens "
                             "differ")


def train_phase():
    """Phase 11, "train": parts (a)-(d)."""
    import dataclasses

    import torch

    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
    from handwritten_math_ocr_api_torch.data.synthetic import grammar_vocab

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    train_parity()
    log(f"train parity: seconds {time.perf_counter() - t0:.1f}")
    tok = Tokenizer(grammar_vocab())
    r4 = load_model_config(MODEL_DIR)
    cfg = r4.replace(vocab_size=len(tok), dropout=TRAIN_DROPOUT,
                     swin=dataclasses.replace(
                         r4.swin, stochastic_depth=TRAIN_DROPOUT))
    t0 = time.perf_counter()
    state = train_full_width(cfg, tok, dev)
    log(f"train full width: seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    train_resume(cfg, tok, dev)
    log(f"train resume: seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    train_serve(state, cfg.replace(dropout=0.0, swin=r4.swin), tok, dev)
    log(f"train serve: seconds {time.perf_counter() - t0:.1f}")


# -- phase 12: the ResNet encoders ------------------------------------------

RESNET_ENCODE_IMAGES = 16   # the trunk's encode timed at this batch
RESNET_CONT_IMAGES = 16     # res18trans requests through ContinuousDecoder
RESNET_TRAIN_BATCH = 16     # the float32 step held card against host
RESNET_STREAM_BATCH = 64    # the bf16 steps of the synthetic stream
RESNET_STREAM_STEPS = 30
RESNET_MEMORY_ATOL = 1e-4   # converted model against the reference module
RESNET_TRAIN_RTOL = 1e-4    # the card's float32 step against the host's


def resnet_kernels(rcfg, rparams, entries, bucket, rows):
    """Phase 12 (a): the decoder kernels that the ResNet model's served
    routes launch with cross K/V, at the ResNet memory of 10 columns,
    against their plain versions with phase 3's checks and tolerances
    (phase 3's functions on a ResNet config: B1 bf16 and int8 at the
    bucket and at one row, pos 0/74/149; B7 at the beam's rows, pos
    0/74/149 and ragged, both bundles; B7's ring entries at the continuous
    pool, both bundles), and B9 at the two cross K/V shapes
    (``resnet_dequant``). B10-B12 and the MQA entries at 10 columns are
    held by ``tests/test_torch_kernels_cuda.py``. Each time goes into its
    phase 3 entry as ``ms_lenc10`` (with ``bound_ms_lenc10``) beside its
    ``ms`` at 30 columns."""
    by_name = {e.d["name"]: e for e in entries}
    got = []
    for quantize in (False, True):
        got += [check_fused_step(rcfg, rparams, bucket, quantize),
                check_ragged_step(rcfg, rparams, rows, bucket, quantize),
                check_ragged_ring(rcfg, rparams, CONT_POOL, quantize)]
    for e in got:
        base = by_name[e.d["name"]].d
        base["ms_lenc10"] = e.d["ms"]
        base["bound_ms_lenc10"] = e.d["bound_ms"]
        base["max_abs_err_lenc10"] = e.d["max_abs_err"]
        if "ms_rows1" in e.d:
            base["ms_rows1_lenc10"] = e.d["ms_rows1"]
        log(f"resnet kernel {e.d['name']}: L_enc 10 ms {e.d['ms']:.4f} "
            f"bound_ms {e.d['bound_ms']:.4f} max_abs_err "
            f"{e.d['max_abs_err']:.3g}; L_enc 30 ms {base['ms']:.4f} "
            f"bound_ms {base['bound_ms']:.4f}")
    resnet_dequant(rcfg, rparams, by_name["dequant_matmul"], bucket, rows)


def resnet_dequant(rcfg, rparams, entry, batch, rows):
    """B9 at the int8 default route's cross K/V projections of the ResNet
    memory (``batch`` and ``rows`` images of 10 columns: 160 and 500
    rows) against its plain version, with phase 3's tolerance, timed
    beside the same projection at 30 columns (480 and 1500 rows, from
    phase 3's ``by_shape``)."""
    import torch

    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.ops import quant

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    D, L_enc = rcfg.d_model, rcfg.encoder_len
    ca = convert.to_torch(
        {"decoder": quant.quantize_decoder_params(rparams["decoder"])},
        rcfg, dev)["decoder"]["layers"][0]["cross_attn"]
    w_q, scale = ca["w_qkv_q"][:, D:2 * D], ca["w_qkv_scale"][D:2 * D]
    at30 = {s["M"]: s["ms"] for s in entry.d["by_shape"]
            if s["shape"] == "cross k"}
    out = {}
    for images in (batch, rows):
        M = images * L_enc
        x = torch.randn(M, D, generator=gen, device=dev).to(torch.bfloat16)
        got = quant.dequant_matmul(x, w_q, scale)
        want = quant.dequant_matmul_plain(x, w_q, scale)
        torch.cuda.synchronize()
        assert_close(f"resnet dequant_matmul cross k M {M}", got, want)
        ms = cuda_ms(lambda: quant.dequant_matmul(x, w_q, scale))
        nbytes = M * D * 2 + D * D + D * 4 + M * D * 2
        out[M] = ms
        log(f"resnet kernel dequant_matmul cross k: x ({M}, {D}) "
            f"max_abs_err {max_err(got, want):.3g} ms {ms:.4f} bound_ms "
            f"{bound_ms(nbytes, 2 * M * D * D):.5f}; at 30 columns "
            f"(M {images * 30}) ms {at30.get(images * 30, float('nan')):.4f}")
    entry.d["cross_ms_lenc10"] = out


def resnet_encode_ms(engine, images):
    """The encode of ``images`` (the trunk, its height pool and
    projection) on the engine's device: CUDA events over 10 calls after
    2, ms a call."""
    import torch

    x, _ = engine._pad_batch(images)
    with torch.inference_mode():
        for _ in range(2):
            engine._encode(x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            engine._encode(x)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / 10


def resnet_serve(rcfg, tok, entries):
    """Phase 12 (b): ``resnet18`` with seeded weights and perturbed
    BatchNorm statistics (rows run all 150 steps, as phase 4's) on the
    default route (decoder cut to DEFAULT_ROUTE_LAYERS) and the
    fused route, each through phase 4's ``serve``: greedy and beam 5 of
    10 images, launch counts (no encoder kernel), float32 tokens equal to
    the plain path, images/s and idle share; and the encode's time at
    RESNET_ENCODE_IMAGES images."""
    import numpy as np

    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine

    state = convert.random_state(rcfg, SEED)
    cut = rcfg.replace(num_decoder_layers=DEFAULT_ROUTE_LAYERS)
    routes = {"pallas resnet18": (cut, {}),
              "fused resnet18": (rcfg, {"use_fused": True,
                                        "pallas_encoder_block": True})}
    out = {}
    for route, (c, kw) in routes.items():
        t0 = time.perf_counter()
        out[route] = serve(c, convert.random_params(c, SEED), tok,
                           entries, route, model_state=state, **kw)
        log(f"serve {route}: {c.num_decoder_layers} decoder layers, phase "
            f"seconds {time.perf_counter() - t0:.1f}")
    images = np.random.default_rng(SEED + 12).integers(
        0, 256, (RESNET_ENCODE_IMAGES, rcfg.img_h, rcfg.img_w, 1),
        dtype=np.uint8)
    engine = DecodeEngine(convert.random_params(rcfg, SEED), rcfg,
                          tokenizer=tok, model_state=state, device=DEVICE)
    ms = resnet_encode_ms(engine, images)
    log(f"resnet18: encode of {RESNET_ENCODE_IMAGES} images (bf16 trunk, "
        f"height pool, projection, memory norm) ms {ms:.4f} (CUDA events, "
        f"10 calls)")
    return out


def resnet_trans(tok, entries):
    """Phase 12 (c): ``res18trans`` (8 transformer encoder layers; the
    EOS bias raised, ``boosted_params``: rows end at 1-150 steps) on the
    fused route: greedy ``predict_batch`` of 10 images in bf16 (launch
    counts), then RESNET_CONT_IMAGES requests through ``ContinuousDecoder``
    on the fused route in float32 (launch counts), equal to the fused
    engine's results and tokens."""
    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine

    cfg = load_model_config(MODEL_DIR).replace(encoder="res18trans")
    params, state = boosted_params(cfg), convert.random_state(cfg, SEED)
    fused = {"use_fused": True, "pallas_encoder_block": True}
    rng = np.random.default_rng(SEED + 13)
    images = rng.integers(0, 256, (max(N_IMAGES, RESNET_CONT_IMAGES),
                                   cfg.img_h, cfg.img_w, 1), dtype=np.uint8)
    engine = DecodeEngine(params, cfg, tokenizer=tok, model_state=state,
                          device=DEVICE, **fused)
    engine.warmup((N_IMAGES,), dtype=np.uint8)
    reset_counts()
    texts = engine.predict_batch(images[:N_IMAGES])
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, expected_launches(cfg, "fused", 1,
                                           engine.last_steps))
    tally(entries, counts, "fused res18trans")
    if len(texts) != N_IMAGES:
        raise AssertionError("res18trans predict_batch returned "
                             f"{len(texts)} texts")
    log(f"res18trans fused: predict_batch({N_IMAGES}) {engine.last_steps} "
        f"steps, launches as counted; first text {texts[0][:60]!r}")

    cfg32 = cfg.replace(dtype="float32")
    conts = images[:RESNET_CONT_IMAGES]
    dec = continuous_decoder(cfg32, params, tok, use_fused=True,
                             model_state=state)
    dec.warmup()
    reset_counts()
    results, got, wall = continuous_traffic(dec, conts)
    tally(entries, continuous_counts(dec, cfg32, "fused",
                                     "res18trans fused float32"),
          "continuous res18trans")
    engine32 = DecodeEngine(params, cfg32, tokenizer=tok, model_state=state,
                            device=DEVICE, use_fused=True)
    want = engine32.decode_tokens(conts)
    pairs = engine32.predict_with_confidence(conts)
    continuous_vs("res18trans fused float32", got, want, results, pairs)
    dec.close()
    log(f"res18trans continuous: {RESNET_CONT_IMAGES} requests in "
        f"{wall:.3f} s, float32 results and tokens equal to the fused "
        f"engine's")


def reference_resnet(cfg):
    """A seeded reference-layout ``resnet18`` model in plain ``torch.nn``:
    ``encoder.features`` (torchvision resnet18's children but the last
    two, 1-channel), ``encoder.projection`` and the reference decoder's
    modules; BatchNorm weights, biases and running statistics perturbed,
    so that eval mode reads them."""
    import torch
    from torch import nn

    class Holder(nn.Module):
        def __init__(self, **mods):
            super().__init__()
            for k, v in mods.items():
                setattr(self, k, v)

    class Block(nn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(cout)
            self.relu = nn.ReLU(inplace=True)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout)
            self.downsample = None
            if stride != 1 or cin != cout:
                self.downsample = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride, bias=False),
                    nn.BatchNorm2d(cout))

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            out = self.relu(self.bn1(self.conv1(x)))
            return self.relu(self.bn2(self.conv2(out)) + idt)

    torch.manual_seed(SEED)
    rc = cfg.resnet
    seq = [nn.Conv2d(1, rc.stage_channels[0], 7, 2, 3, bias=False),
           nn.BatchNorm2d(rc.stage_channels[0]), nn.ReLU(inplace=True),
           nn.MaxPool2d(3, 2, 1)]
    cin = rc.stage_channels[0]
    for i, (cout, n) in enumerate(zip(rc.stage_channels, rc.stage_blocks)):
        blocks = []
        for b in range(n):
            blocks.append(Block(cin, cout, 2 if (b == 0 and i > 0) else 1))
            cin = cout
        seq.append(nn.Sequential(*blocks))
    layer = nn.TransformerDecoderLayer(cfg.d_model, cfg.nhead,
                                       cfg.dim_feedforward, 0.0)
    decoder = Holder(embedding=nn.Embedding(cfg.vocab_size, cfg.d_model),
                     pos_encoder=nn.Embedding(cfg.max_seq_len, cfg.d_model),
                     decoder=nn.TransformerDecoder(layer,
                                                   cfg.num_decoder_layers),
                     fc_out=nn.Linear(cfg.d_model, cfg.vocab_size))
    model = Holder(encoder=Holder(features=nn.Sequential(*seq),
                                  projection=nn.Linear(cin, cfg.d_model)),
                   decoder=decoder)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(-0.1, 0.1)
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 1.5)
    return model.eval()


def resnet_convert(tok):
    """Phase 12 (d): a seeded reference-layout ``resnet18`` (full width)
    saved as a training bundle, made a serving artifact by ``python -m
    handwritten_math_ocr_api_torch convert-checkpoint``, then served in
    float32: the artifact holds the BatchNorm statistics, its tokens equal
    those of an engine on the in-memory converted tree, and its encoder
    memory lies within RESNET_MEMORY_ATOL of the reference module's own
    ``eval()`` forward on the card (TF32 off)."""
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch.compat import torch_convert
    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
    from handwritten_math_ocr_api_torch.train.checkpoint import (
        load_params_for_serving,
    )
    from handwritten_math_ocr_api_torch.utils import tree

    r4 = load_model_config(MODEL_DIR)
    # the reference model has no memory norm
    cfg = r4.replace(encoder="resnet18", memory_norm=False)
    model = reference_resnet(cfg)
    d = tempfile.mkdtemp(prefix="resnet_convert_")
    try:
        pth = os.path.join(d, "best_model.pth")
        torch.save({"model_state_dict": model.state_dict(), "epoch": 1}, pth)
        overrides = json.dumps({k: getattr(cfg, k) for k in (
            "img_h", "img_w", "d_model", "nhead", "dim_feedforward",
            "num_decoder_layers", "max_seq_len")} | {
            "dtype": "float32"})
        out = os.path.join(d, "artifact")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "handwritten_math_ocr_api_torch",
             "convert-checkpoint", pth, os.path.join(MODEL_DIR, "vocab.json"),
             out, "--encoder", "resnet18", "--model-overrides", overrides],
            cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise AssertionError(f"convert-checkpoint failed: {run.stderr}")
        log(f"resnet convert: convert-checkpoint in "
            f"{time.perf_counter() - t0:.1f} s: {run.stdout.strip()}")
        params, state, _, _, acfg = load_params_for_serving(out)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n_stats = len(tree.leaves(state))
    if not state.get("resnet") or n_stats != 2 * 20:
        raise AssertionError(f"the artifact holds {n_stats} BatchNorm "
                             "statistics, not 40")
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    p_mem, s_mem = torch_convert.convert_state_dict(sd, acfg)
    rng = np.random.default_rng(SEED + 14)
    images = rng.integers(0, 256, (N_IMAGES, acfg.img_h, acfg.img_w, 1),
                          dtype=np.uint8)
    engine = DecodeEngine(params, acfg, tokenizer=tok, model_state=state,
                          device=DEVICE)
    ref_engine = DecodeEngine(p_mem, acfg, tokenizer=tok, model_state=s_mem,
                              device=DEVICE)
    got, want = engine.decode_tokens(images), ref_engine.decode_tokens(images)
    if not torch.equal(got.tokens, want.tokens):
        raise AssertionError("the artifact's float32 tokens differ from the "
                             "in-memory converted tree's")
    x, B = engine._pad_batch(images)
    with torch.inference_mode():
        mem = engine._encode(x)[:B]
        ref = model.to(DEVICE)
        f = ref.encoder.features(x[:B].permute(0, 3, 1, 2))
        ref_mem = ref.encoder.projection(f.mean(dim=2).permute(0, 2, 1))
    err = max_err(mem, ref_mem)
    log(f"resnet convert: artifact tokens equal to the in-memory tree's "
        f"over {got.steps} steps (lengths {got.lengths.tolist()}); memory "
        f"against the reference module's eval() forward max_abs_err "
        f"{err:.3g} (gate {RESNET_MEMORY_ATOL}; |x| max "
        f"{ref_mem.abs().max().item():.3g}); {n_stats} statistics")
    if not err <= RESNET_MEMORY_ATOL:
        raise AssertionError(f"converted memory differs by {err}")


def resnet_train(tok):
    """Phase 12 (e): a float32 ``resnet18`` train step at batch
    RESNET_TRAIN_BATCH on the card and on the host from the same params,
    statistics, images, captions and seed (dropout 0, float images: no
    draw), loss and gradient norm within RESNET_TRAIN_RTOL relative and
    the batch's part of the new statistics, (new - 0.9 old) / 0.1, within
    RESNET_TRAIN_RTOL of each leaf's largest;
    then RESNET_STREAM_STEPS bf16 steps at batch RESNET_STREAM_BATCH of
    the synthetic stream (uint8, augmented in the step, dropout 0.1):
    images/s, ms a step, the idle share of a profiled step, peak memory;
    a finite loss and statistics that moved."""
    import numpy as np
    import torch

    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import (
        DataConfig,
        TrainConfig,
        load_model_config,
    )
    from handwritten_math_ocr_api_torch.data.synthetic import grammar_vocab
    from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
    from handwritten_math_ocr_api_torch.train import optim
    from handwritten_math_ocr_api_torch.train.step import (
        create_train_state,
        make_train_step,
        state_from_params,
    )
    from handwritten_math_ocr_api_torch.utils import tree

    r4 = load_model_config(MODEL_DIR)
    cfg = r4.replace(encoder="resnet18", dtype="float32", dropout=0.0)
    params, stats = convert.random_params(cfg, SEED), convert.random_state(
        cfg, SEED)
    rng = np.random.default_rng(SEED + 15)
    images = rng.standard_normal((RESNET_TRAIN_BATCH, cfg.img_h, cfg.img_w,
                                  1)).astype(np.float32)
    caps = rng.integers(4, cfg.vocab_size, (RESNET_TRAIN_BATCH, 40))
    caps[:, 0] = 1
    tc = TrainConfig()
    res = {}
    for dev in (torch.device(DEVICE), torch.device("cpu")):
        opt = optim.make_optimizer(tc)
        st = state_from_params(convert.to_torch(params, cfg, dev), opt, tc,
                               convert.state_to_torch(stats, dev))
        t0 = time.perf_counter()
        new, m = make_train_step(cfg, tc, opt, device=dev)(st, images, caps,
                                                           SEED)
        res[dev.type] = ({k: float(v) for k, v in m.items()},
                         [t.cpu() for t in tree.leaves(new.model_state)])
        log(f"resnet train {dev.type}: float32 step of "
            f"{RESNET_TRAIN_BATCH} in {time.perf_counter() - t0:.2f} s, "
            f"loss {res[dev.type][0]['loss']:.6f} grad_norm "
            f"{res[dev.type][0]['grad_norm']:.6f}")
    (mg, sg), (mc, sc) = res[DEVICE], res["cpu"]
    for k in ("loss", "grad_norm"):
        if abs(mg[k] - mc[k]) > RESNET_TRAIN_RTOL * abs(mc[k]):
            raise AssertionError(f"resnet train {k}: card {mg[k]} against "
                                 f"host {mc[k]}, beyond {RESNET_TRAIN_RTOL} "
                                 "relative")
    # new = 0.9 old + 0.1 batch, with old the same on both devices: hold
    # the batch's part, so that its error is not diluted tenfold
    old = tree.leaves(convert.state_to_torch(stats, "cpu"))
    worst = 0.0
    for a, b, o in zip(sg, sc, old):
        a, b = (a - 0.9 * o) / 0.1, (b - 0.9 * o) / 0.1
        worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
    log(f"resnet train: card against host, the batch statistics' largest "
        f"error relative to their leaf {worst:.3g} (gate "
        f"{RESNET_TRAIN_RTOL})")
    if not worst <= RESNET_TRAIN_RTOL:
        raise AssertionError(f"resnet train statistics differ by {worst}")

    gtok = Tokenizer(grammar_vocab())
    bcfg = r4.replace(encoder="resnet18", vocab_size=len(gtok),
                      dropout=TRAIN_DROPOUT)
    dev = torch.device(DEVICE)
    tc = TrainConfig(warmup_steps=TRAIN_WARMUP)
    state, opt = create_train_state(bcfg, tc, SEED, dev)
    before = [t.clone() for t in tree.leaves(state.model_state)]
    step = make_train_step(bcfg, tc, opt, DataConfig(), device=dev)
    loader = train_stream(bcfg, gtok, RESNET_STREAM_STEPS
                          * RESNET_STREAM_BATCH, SEED + 1,
                          RESNET_STREAM_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    it = iter(loader)
    timed_from = RESNET_STREAM_STEPS // 3
    try:
        for i in range(RESNET_STREAM_STEPS):
            if i == timed_from:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            batch = next(it)
            state, m = step(state, batch["image"], batch["caption"], SEED)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t_start
    finally:
        it.close()
    check_counts(read_counts(), [0] * len(kernel_counters()))
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu()
    timed = RESNET_STREAM_STEPS - timed_from
    ms = elapsed / timed * 1e3
    moved = max((a - b).abs().max().item()
                for a, b in zip(tree.leaves(state.model_state), before))
    log(f"resnet train stream: {RESNET_STREAM_STEPS} bf16 steps of "
        f"{RESNET_STREAM_BATCH}, images/s "
        f"{timed * RESNET_STREAM_BATCH / elapsed:.1f} ms a step {ms:.1f} "
        f"(host clock over {timed} steps), max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB, losses every 10 steps "
        f"{[round(float(x), 4) for x in losses[::10]]}, the statistics "
        f"moved by up to {moved:.3g}")
    idle = profile_call(
        lambda: step(state, batch["image"], batch["caption"], SEED),
        "one resnet18 train step", ms / 1e3, tries=1)
    log(f"resnet train stream: device idle share of a profiled step "
        f"{'not measured' if idle is None else f'{idle:.3f}'}")
    if not (torch.isfinite(losses).all() and moved > 0):
        raise AssertionError("resnet train stream: a loss is not finite or "
                             "the statistics did not move")


def resnet_phase(tok, entries, bucket, rows):
    """Phase 12, "resnet": parts (a)-(e)."""
    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import load_model_config

    rcfg = load_model_config(MODEL_DIR).replace(encoder="resnet18")
    t0 = time.perf_counter()
    resnet_kernels(rcfg, convert.random_params(rcfg, SEED), entries, bucket,
                   rows)
    log(f"resnet kernels: seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    summary = resnet_serve(rcfg, tok, entries)
    log(f"resnet serve: seconds {time.perf_counter() - t0:.1f}")
    for route, (greedy, beam) in summary.items():
        for mode, (rate, idle, *_) in (("greedy", greedy),
                                       (f"beam {BEAM}", beam)):
            idle_s = "not measured" if idle is None else f"{idle:.3f}"
            log(f"route {route} {mode}: images/s {rate:.2f}, device idle "
                f"share {idle_s} (of the best unprofiled predict_batch)")
    t0 = time.perf_counter()
    resnet_trans(tok, entries)
    log(f"resnet res18trans: seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    resnet_convert(tok)
    log(f"resnet convert: seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    resnet_train(tok)
    log(f"resnet train: seconds {time.perf_counter() - t0:.1f}")


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
    rows = N_IMAGES * BEAM
    t0 = time.perf_counter()
    entries = check_kernels(cfg, params, bucket, rows)
    entries.append(check_fused_step(cfg, np_params, bucket))
    entries.append(check_swin_block(cfg, np_params, params, bucket))
    entries.append(check_ragged_step(cfg, np_params, rows, bucket))
    entries.append(check_beam_reorder(cfg, rows))
    entries.append(check_dequant_matmul(cfg, np_params, bucket, rows))
    entries.append(check_fused_step(cfg, np_params, bucket, quantize=True))
    entries.append(check_ragged_step(cfg, np_params, rows, bucket,
                                     quantize=True))
    entries.append(check_layers_step(cfg, np_params, bucket))
    entries.append(check_whole_step(cfg, np_params, bucket))
    entries.append(check_whole_decode(cfg, np_params, bucket, False))
    entries.append(check_whole_decode(cfg, np_params, bucket, True))
    check_past_table(cfg, np_params, bucket)
    mqa = cfg.replace(nhead_kv=1)
    mqa_params = convert.random_params(mqa, SEED)
    entries.append(check_fused_step(mqa, mqa_params, bucket))
    entries.append(check_fused_step(mqa, mqa_params, bucket, quantize=True))
    entries.append(check_ragged_step(mqa, mqa_params, rows, bucket))
    entries.append(check_ragged_step(mqa, mqa_params, rows, bucket,
                                     quantize=True))
    entries.append(check_ragged_ring(cfg, np_params, CONT_POOL))
    entries.append(check_ragged_ring(cfg, np_params, CONT_POOL,
                                     quantize=True))
    entries.append(check_ragged_ring(mqa, mqa_params, CONT_POOL))
    entries.append(check_ragged_ring(mqa, mqa_params, CONT_POOL,
                                     quantize=True))
    log(f"kernels: phase seconds {time.perf_counter() - t0:.1f}")

    fused = {"use_fused": True, "pallas_encoder_block": True}
    cut = cfg.replace(num_decoder_layers=DEFAULT_ROUTE_LAYERS)
    cut_params = convert.random_params(cut, SEED)
    routes = {"pallas": (cut, cut_params, {}),
              "fused": (cfg, np_params, fused),
              "pallas_int8": (cut, cut_params, {"quantize": True}),
              "fused_int8": (cfg, np_params, {**fused, "quantize": True})}
    summary = {}
    for route, (c, p, kw) in routes.items():
        t0 = time.perf_counter()
        summary[route] = serve(c, p, tok, entries, route, **kw)
        log(f"serve {route}: {c.num_decoder_layers} decoder layers, phase "
            f"seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    summary.update(serve_grouped(cfg, tok, entries))
    log(f"serve mqa: phase seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    serve_continuous(cfg, tok, entries)
    log(f"serve continuous: phase seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    quality(tok, entries)
    log(f"quality: phase seconds {time.perf_counter() - t0:.1f}")
    for route, (greedy, beam) in summary.items():
        modes = [("greedy", greedy)] + ([(f"beam {BEAM}", beam)]
                                        if beam is not None else [])
        for mode, (rate, idle, *_, tokens) in modes:
            idle_s = "not measured" if idle is None else f"{idle:.3f}"
            log(f"route {route} {mode}: images/s {rate:.2f}, device idle "
                f"share {idle_s} (of the best unprofiled predict_batch)")
            if route.endswith("_int8"):
                base = summary[route[:-len("_int8")]]
                ref = base[0][-1] if mode == "greedy" else base[1][-1]
                log(f"route {route} {mode}: bf16 tokens agree with route "
                    f"{route[:-len('_int8')]}'s "
                    f"{(tokens == ref).float().mean().item():.4f} "
                    f"(int8 against bf16 weights; not held)")

    t0 = time.perf_counter()
    arms = serve_variants(cfg, np_params, tok, entries)
    log(f"variants: phase seconds {time.perf_counter() - t0:.1f}")
    for arm, (rate, idle, steps) in arms.items():
        idle_s = "not measured" if idle is None else f"{idle:.3f}"
        log(f"variant {arm}: images/s {rate:.2f}, device idle share "
            f"{idle_s} (of the best unprofiled decode), {steps} steps")

    serve_modes(cfg, tok, entries)
    serve_app(cfg, tok, entries)
    t0 = time.perf_counter()
    train_phase()
    log(f"train: phase seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    resnet_phase(tok, entries, bucket, rows)
    log(f"resnet: phase seconds {time.perf_counter() - t0:.1f}")

    log(json.dumps({"kernels": [e.d for e in entries]}))
    log(f"total seconds {time.perf_counter() - t_start:.1f}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
