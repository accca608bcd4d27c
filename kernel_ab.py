#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against each other on one GPU.

    python3 kernel_ab.py steps DIR [DIR ...]  # the decoder-step kernels:
                                              # the tree against other
                                              # copies of the package
    python3 kernel_ab.py decode             # B12 with an L2 policy and at
                                            # other row groups
    python3 kernel_ab.py dequant            # B9's tile shapes and phases
    python3 kernel_ab.py encoder            # B4's clusters, B3's tiles and
                                            # both kernels' phases
    python3 kernel_ab.py routes DIR [DIR ...]  # served images/s of the
                                               # fused routes, the tree
                                               # against other copies
    python3 kernel_ab.py app DIR [DIR ...]     # the HTTP app's load, the
                                               # tree against other copies

``steps`` times the kernels on the cluster layer code
(``csrc/decoder_cluster.cuh``) from the package of this checkout and from
the one under each DIR (a directory holding a
``handwritten_math_ocr_api_torch/``, such as a ``git archive`` of an
earlier commit), in turns (each DIR, the tree, the tree, each DIR in
reverse), each in a process of its own (the packages share a name), on the
same seeded inputs: B1 (bf16) and B11 at the greedy bucket (16 rows) and
the last slot (pos 149), B7 (bf16, logits) at the beam's 50 rows at pos
149, B10 in both cache layouts at 16 rows and pos 149, and B12 (bf16 and
int8 bundles) for a whole decode of 16 rows over 150 steps; then, where the
package takes MQA (``nhead_kv=1``), B1's and B7's MQA entries (bf16 and
int8 bundles) at the same rows and slot; then, where the package takes
B7's segment ring, its ring entry (bf16, logits; MHA and MQA) at the
continuous pool's 48 rows at pos 149 with segments from slot 86 (63 ring
rows), beside the non-ring entry at the same rows and slot.

``decode`` builds ``csrc/whole_decode.cu`` again as it is, with an L2
evict_last policy on its weight copies, and at each other rows-a-group count
(``DECODE_VARIANTS``: text edits of ``csrc/``), and times B12 (bf16 and int8
bundles, 16 rows, 150 steps) in each, in ``DECODE_ROUNDS`` rounds that run the
variants in turn forwards and backwards (median, quartiles, and the rounds in
which each beat the planned launch). Every variant decodes the seeded bundle
and ``chip_smoke``'s EOS-boosted one (rows that finish beside live ones in
their group) ``DECODE_REPEATS`` times; every run is held against the plain
decode by ``chip_smoke.hold_decode`` (the row groups split the attention and
LayerNorm sums differently, so bf16 tokens may part at near-ties) and
``chip_smoke.finishing`` (PAD after EOS, counts, lengths), and the runs that
differ bit for bit from the variant's first run are counted (an ordering fault,
such as a TMA read of a slot before its write is visible, would show there).

``dequant`` builds ``csrc/dequant_matmul.cu`` with an extra entry that
launches any of its bf16 tile shapes (template arguments: warps splitting
K, m16 tiles a block, n8 tiles a warp) and times each at the default
int8 route's shapes beside ``torch.matmul`` on the weight dequantized
beforehand; then, at the cross K/V projection's shape, builds it again
with one phase taken out at a time (the math, the B fragments' loads and
conversion, the global stores) to show where its time goes.

``encoder`` times the bf16 whole Swin block kernel (B4) at the 16-image
bucket on each fused stage of Swin-T (shift 3) with every cluster size the
stage's width takes (with 4 n8 tiles a warp, at 8 and at 16 warps a
block), and patch merging (B3) at each merge with each tile
width, beside the unfused block (``swin_block(..., use_pallas_block=
False)``: LayerNorm, cuBLAS, B2 and GELU) and layer norm + one matmul on
the gathered rows; then builds each kernel again with one phase taken out
at a time (``ENCODER_PHASES``: text edits of ``csrc/``; the outputs are
then wrong, only the times count) to show where the time goes.

``routes`` times ``DecodeEngine.predict_batch`` (wall time, the host's
launches included) of the package under each DIR and of the tree, in turns
as ``steps`` does, on ``chip_smoke``'s seeded weights and images (10
images): the fused route in bf16 and int8 (``quantize``) at full depth,
and MQA (``nhead_kv=1``) fused int8, each greedy (``ROUTE_ROUNDS``
rounds) and beam 5 (``ROUTE_ROUNDS // 2``), after a warm-up call of each;
images/s of the median and of the best round.

``app`` runs ``chip_smoke.app_load`` (the shipped bf16 weights on the
HTTP app, fused route, dynamic batching, 16 closed-loop clients, three
windows of ``APP_LOAD_REQUESTS`` requests) on the package under each DIR
and on the tree, in turns as ``steps`` does, each side with the
``chip_smoke.py`` beside its package (which serves that package's app as
its own smoke run does): requests/s, p50/p95 latency and a request's input
stage (upload to pixels) of each window.

Device time from ``chip_smoke.cuda_ms`` (the profiler); the card's name and
power limit are printed first. Numbers compare only within one run.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
TILES = [(8, 1, 2), (8, 1, 4), (8, 1, 8), (4, 2, 4), (4, 2, 8), (2, 4, 4),
         (2, 4, 8), (1, 8, 4), (1, 8, 8)]
# the phases taken out of the bf16 kernel (its source text, replaced)
PHASES = {
    "all": [],
    "no math": [("s1 = min(steps, s0 + per_part);", "s1 = s0;")],
    "no B loads": [("    load_b_i8<NT>(ws + s * 16 * BN, BN, lane, b);",
                    "    for (int j = 0; j < NT; ++j)\n"
                    "      b[j][0] = b[j][1] = 0x3F803F80u + s;")],
    "no y stores": [("    if (m < M && n < N) {\n      float sum",
                     "    if (m < M && n < N && m < 0) {\n      float sum")],
}

# the phases taken out of B4 and B3: (kernel, [(file in csrc/, old text,
# new text)]); "all" takes none out
ENCODER_PHASES = {
    "all": [],
    "no products": [("mma_pass.cuh", "for (int kk = 0; kk < kKt / 16; ++kk)",
                     "for (int kk = 0; kk < 0; ++kk)")],
    "no weight copies": [("mma_pass.cuh", "if (i < st.copies) cp_async16(",
                          "if (i < 0) cp_async16(")],
    "no attention": [("swin_block.cu", "item < 4 * hpb;", "item < 0;")],
    "no exchange": [("swin_block.cu", "if (cs == 1) return;",
                     "if (cs > 0) return;")],
    "no MLP": [("swin_block.cu", "const int chunks = a.hid / a.hcc;",
                "const int chunks = 0;")],
    "no gather": [("patch_merging.cu",
                   "cp_async16(to, x + ((static_cast<size_t>(b) * H",
                   "if (b < 0) cp_async16(to, x + ((static_cast<size_t>(b)"
                   " * H")],
}


# B12 with its weight copies under an L2 evict_last policy: the copy
# helper, and the weight boxes' copies calling it
L2_EVICT_LAST = [
    ("decoder_cluster.cuh",
     "__device__ __forceinline__ void tensor_copy4(",
     r"""__device__ __forceinline__ void tensor_copy3_hint(
    void* dst, const CUtensorMap* map, int c0, int c1, int c2,
    uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], "
      "%6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tensor_copy4("""),
    ("decoder_cluster.cuh", "        tensor_copy3(stage_at(st) +",
     "        tensor_copy3_hint(stage_at(st) +")]


def rows_a_group(rows: int):
    """B12's launch at ``rows`` rows a group instead of the planned shape."""
    old = ("      kernel, L, B, T_out, D, H, H, F, L_enc, T_out - 1, &s, "
           "hres);\n")
    return [("whole_decode.cu", old,
             old + f"  s = cluster_step::make_shape<W, C>(L, B, T_out, D, H, "
                   f"H, F, L_enc, T_out - 1, {rows}, hres);\n")]


# B12's variants: (file in csrc/, old text, new text) edits
DECODE_VARIANTS = {"planned": [], "L2 evict_last": L2_EVICT_LAST,
                   **{f"{n} rows a group": rows_a_group(n)
                      for n in (1, 4, 8, 16)}}
# decodes of each bundle a variant runs and compares bit for bit
DECODE_REPEATS = 10
# timed rounds of every variant (alternating their order)
DECODE_ROUNDS = 10


def quartiles(t):
    """The first and third quartiles of the times ``t``."""
    q = statistics.quantiles(t, n=4)
    return q[0], q[2]


def steps_in_process(root: str, label: str) -> None:
    """One side of ``steps``: the package under ``root``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import handwritten_math_ocr_api_torch as pkg
    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.ops import fused_step as fs
    from handwritten_math_ocr_api_torch.ops import whole_decode as wd

    if not pkg.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {pkg.__file__}, not {root}'s package")
    cfg = load_model_config(cs.MODEL_DIR).replace(dtype="bfloat16")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    L, T, D = cfg.num_decoder_layers, cfg.max_seq_len, cfg.d_model
    B, L_enc, pos = 16, cfg.encoder_len, cfg.max_seq_len - 1

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    np_params = convert.random_params(cfg, cs.SEED)
    st = fs.build_stacked_full(np_params["decoder"], cfg, dev)
    sk, sv, ck, cv = (randn(L, B, T, D), randn(L, B, T, D),
                      randn(L, B, L_enc, D), randn(L, B, L_enc, D))
    x = randn(B, D)
    sk2, sv2 = sk.clone(), sv.clone()
    b1 = cs.cuda_ms(lambda: fs.fused_decoder_layers_step_v2(
        st, cfg, x, sk, sv, ck, cv, pos), iters=50)
    b11 = cs.cuda_ms(lambda: fs.fused_decoder_layers_step(
        st, cfg, x, sk2, sv2, ck, cv, pos), iters=50)
    R = 50
    rk, rv, rck, rcv = (randn(L, R, T, D), randn(L, R, T, D),
                        randn(L, R, L_enc, D), randn(L, R, L_enc, D))
    prev = torch.randint(0, cfg.vocab_size, (R,), generator=gen, device=dev,
                         dtype=torch.int32)
    at = torch.full((R,), pos, dtype=torch.int32, device=dev)
    b7 = cs.cuda_ms(lambda: fs.fused_ragged_step(
        st, cfg, prev, at, rk, rv, rck, rcv, return_logits=True), iters=50)
    tk, tv = sk.transpose(1, 2).contiguous(), sv.transpose(1, 2).contiguous()
    b10 = {tm: cs.cuda_ms(lambda: fs.fused_whole_step(
        st, cfg, prev[:B], *((tk, tv) if tm else (sk, sv)), ck, cv, pos,
        time_major=tm), iters=50) for tm in (True, False)}
    dec = convert.to_torch({"decoder": np_params["decoder"]}, cfg,
                           dev)["decoder"]
    memory = randn(B, L_enc, D)
    resident = {int8: wd.build_resident(dec, cfg, int8)
                for int8 in (False, True)}
    b12 = {int8: cs.cuda_ms(lambda: wd.fused_whole_decode(
        resident[int8], cfg, memory), iters=3, warmup=1)
        for int8 in (False, True)}
    print(f"steps {label}: B1 bf16 {b1:.4f} ms, B11 {b11:.4f} ms "
          f"({B} rows, pos {pos}); B7 bf16 {b7:.4f} ms ({R} rows, logits); "
          f"B10 time-major {b10[True]:.4f} ms, batch-major "
          f"{b10[False]:.4f} ms ({B} rows); B12 a decode bf16 "
          f"{b12[False]:.3f} ms, int8 {b12[True]:.3f} ms ({B} rows)",
          flush=True)

    mqa = cfg.replace(nhead_kv=1)
    try:
        mqa_params = convert.random_params(mqa, cs.SEED)
    except NotImplementedError:
        print(f"steps {label}: MQA not in this package", flush=True)
        return
    kvd = mqa.kv_dim
    mk, mv, rmk, rmv = (randn(L, B, T, kvd), randn(L, B, T, kvd),
                        randn(L, R, T, kvd), randn(L, R, T, kvd))
    times = []
    for int8 in (False, True):
        mst = fs.build_stacked_full(mqa_params["decoder"], mqa, dev)
        if int8:
            mst = fs.quantize_stacked(mst)
        times.append(cs.cuda_ms(lambda: fs.fused_decoder_layers_step_v2(
            mst, mqa, x, mk, mv, ck, cv, pos), iters=50))
        times.append(cs.cuda_ms(lambda: fs.fused_ragged_step(
            mst, mqa, prev, at, rmk, rmv, rck, rcv, return_logits=True),
            iters=50))
    print(f"steps {label}: MQA B1 bf16 {times[0]:.4f} ms, int8 "
          f"{times[2]:.4f} ms ({B} rows, pos {pos}); MQA B7 bf16 "
          f"{times[1]:.4f} ms, int8 {times[3]:.4f} ms ({R} rows, logits)",
          flush=True)

    P, S = 48, 64   # chip_smoke's CONT_POOL and CONT_RING (an older
    # package's chip_smoke lacks them)
    ring_times = {}
    for name, c, params in (("MHA", cfg, np_params), ("MQA", mqa,
                                                     mqa_params)):
        pst = fs.build_stacked_full(params["decoder"], c, dev)
        kvd = c.kv_dim
        pk, pv, qk, qv = (randn(L, P, T, kvd), randn(L, P, T, kvd),
                          randn(L, P, S, kvd), randn(L, P, S, kvd))
        pck, pcv = randn(L, P, L_enc, D), randn(L, P, L_enc, D)
        pprev = torch.randint(0, c.vocab_size, (P,), generator=gen,
                              device=dev, dtype=torch.int32)
        ppos = torch.full((P,), pos, dtype=torch.int32, device=dev)
        seg = torch.full((P,), pos - (S - 1), dtype=torch.int32, device=dev)
        try:
            ring = cs.cuda_ms(lambda: fs.fused_ragged_step(
                pst, c, pprev, ppos, pk, pv, pck, pcv, seg_start=seg,
                ring_k=qk, ring_v=qv, return_logits=True), iters=50)
        except TypeError:
            print(f"steps {label}: B7's ring not in this package",
                  flush=True)
            return
        flat = cs.cuda_ms(lambda: fs.fused_ragged_step(
            pst, c, pprev, ppos, pk, pv, pck, pcv, return_logits=True),
            iters=50)
        ring_times[name] = (ring, flat)
    print(f"steps {label}: B7 ring bf16 {ring_times['MHA'][0]:.4f} ms, "
          f"without the ring {ring_times['MHA'][1]:.4f} ms; MQA B7 ring "
          f"{ring_times['MQA'][0]:.4f} ms, without {ring_times['MQA'][1]:.4f}"
          f" ms ({P} rows, pos {pos}, segments from {pos - (S - 1)}, "
          f"logits)", flush=True)


ROUTE_ROUNDS = 10


def load_tree_smoke(root: str = ROOT):
    """The ``chip_smoke`` of ``root`` (this checkout's by default: its
    constants and its app load), whichever package ``sys.path`` finds
    first."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def import_package(root: str):
    sys.path.insert(0, root)
    import handwritten_math_ocr_api_torch as pkg

    if not pkg.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {pkg.__file__}, not {root}'s package")


def routes_in_process(root: str, label: str) -> None:
    """One side of ``routes``: the package under ``root``."""
    import time

    import numpy as np
    import torch

    import_package(root)
    cs = load_tree_smoke()
    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.core.tokenizer import (
        Tokenizer,
        load_vocab,
    )
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine

    cfg = load_model_config(cs.MODEL_DIR)
    tok = Tokenizer(*load_vocab(os.path.join(cs.MODEL_DIR, "vocab.json")))
    rng = np.random.default_rng(cs.SEED)
    images = rng.integers(0, 256, (cs.N_IMAGES, cfg.img_h, cfg.img_w, 1),
                          dtype=np.uint8)
    fused = {"use_fused": True, "pallas_encoder_block": True}
    mqa = cfg.replace(nhead_kv=1)
    for name, c, kw in (("fused", cfg, fused),
                        ("fused_int8", cfg, {**fused, "quantize": True}),
                        ("fused_mqa_int8", mqa, {**fused,
                                                 "quantize": True})):
        engine = DecodeEngine(convert.random_params(c, cs.SEED), c,
                              tokenizer=tok, device=cs.DEVICE, **kw)
        engine.warmup((cs.N_IMAGES,), dtype=np.uint8)
        row = []
        for mode, beam, rounds in (("greedy", None, ROUTE_ROUNDS),
                                   (f"beam {cs.BEAM}", cs.BEAM,
                                    ROUTE_ROUNDS // 2)):
            engine.predict_batch(images, beam_size=beam)  # warm
            torch.cuda.synchronize()
            times = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                engine.predict_batch(images, beam_size=beam)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            row.append(f"{mode} images/s median "
                       f"{cs.N_IMAGES / statistics.median(times):.2f} best "
                       f"{cs.N_IMAGES / min(times):.2f} ({engine.last_steps}"
                       f" steps)")
        print(f"routes {label}: {name}: " + "; ".join(row), flush=True)
        del engine
        torch.cuda.empty_cache()


def app_in_process(root: str, label: str) -> None:
    """One side of ``app``: the package under ``root``."""
    import glob

    import_package(root)
    cs = load_tree_smoke(root)
    paths = sorted(glob.glob(os.path.join(
        cs.QUALITY_DATA, "test_formulas", "*.png")))[:cs.APP_CONCURRENT]
    pngs = []
    for p in paths:
        with open(p, "rb") as f:
            pngs.append(f.read())
    (rate, p50, p95), windows = cs.app_load(pngs)
    print(f"app {label}: requests/s {rate:.2f}, p50 {p50:.1f} ms, p95 "
          f"{p95:.1f} ms; windows (requests/s, p50, p95, input ms) "
          + ", ".join(f"({r:.2f}, {a:.1f}, {b:.1f}, {i:.1f})"
                      for r, a, b, i in windows), flush=True)


def in_turns(kind: str, others) -> None:
    """Each DIR, the tree, the tree, each DIR in reverse: one process each
    (the packages share a name)."""
    runs = [(d, os.path.basename(os.path.normpath(d))) for d in others]
    for root, label in [*runs, (ROOT, "tree"), (ROOT, "tree"),
                        *runs[::-1]]:
        subprocess.run([sys.executable, __file__, f"_{kind}", root, label],
                       check=True, cwd=ROOT)


def decode() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import (
        EOS_ID,
        PAD_ID,
        load_model_config,
    )
    from handwritten_math_ocr_api_torch.ops import _build
    from handwritten_math_ocr_api_torch.ops import fused_step as fs
    from handwritten_math_ocr_api_torch.ops import whole_decode as wd

    build = os.path.join(_build.BUILD_ROOT, "kernel_ab_decode")
    with concurrent.futures.ThreadPoolExecutor(len(DECODE_VARIANTS)) as pool:
        futures = {name: pool.submit(
            build_csrc_variant, ["whole_decode.cu"], ("whole_decode",),
            edits, os.path.join(build, name.replace(" ", "_")))
            for name, edits in DECODE_VARIANTS.items()}
        libs = {name: f.result() for name, f in futures.items()}
    cfg = load_model_config(cs.MODEL_DIR).replace(dtype="bfloat16")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 8)
    B, L_enc, D = 16, cfg.encoder_len, cfg.d_model
    np_dec = convert.random_params(cfg, cs.SEED)["decoder"]
    bias = np.array(np_dec["fc_out"]["b"], np.float32)
    bias[EOS_ID] += cs.EOS_BOOST
    bundles = {  # name: (decoder, memory), as chip_smoke's phase 3
        "seeded": (np_dec, torch.randn(B, L_enc, D, generator=gen,
                                       device=dev).bfloat16()),
        "EOS-boosted": ({**np_dec, "fc_out": {**np_dec["fc_out"],
                                              "b": bias}},
                        torch.from_numpy(np.random.default_rng(9)
                                         .standard_normal((B, L_enc, D))
                                         .astype(np.float32))
                        .to(dev, torch.bfloat16))}
    # planned by the tree's library, before a variant's replaces it
    geos = {int8: fs.cluster_geometry("whole_decode", cfg, B,
                                      cfg.max_seq_len, L_enc, torch.bfloat16,
                                      int8, cfg.vocab_size)
            for int8 in (False, True)}
    try:
        for int8 in (False, True):
            row = []
            for bundle, (np_dec, memory) in bundles.items():
                dec = convert.to_torch({"decoder": np_dec}, cfg,
                                       dev)["decoder"]
                resident = wd.build_resident(dec, cfg, int8)
                want, logits = wd.fused_whole_decode_plain(
                    resident, cfg, memory, return_logits=True)
                for name, lib in libs.items():
                    _build._lib = lib
                    runs = [wd.fused_whole_decode(resident, cfg, memory)
                            for _ in range(DECODE_REPEATS)]
                    differ = sum(
                        not all(torch.equal(a, b) for a, b in zip(r, runs[0]))
                        for r in runs[1:])
                    what = f"B12 {'int8' if int8 else 'bf16'} {name} {bundle}"
                    for r in runs:
                        cs.finishing(r, EOS_ID, PAD_ID)
                        cs.hold_decode(what, r, want, logits)
                    ends = cs.steps_per_row(runs[0].tokens, EOS_ID)
                    print(f"{what}: {DECODE_REPEATS} runs held, {differ} "
                          f"differ bit for bit from the first; steps a row "
                          f"{ends}", flush=True)
                if bundle == "seeded":
                    timed = (resident, memory)
            # rounds of every variant, in turn forwards and backwards
            times = {name: [] for name in libs}
            for i in range(DECODE_ROUNDS):
                for name in list(libs)[::1 if i % 2 == 0 else -1]:
                    _build._lib = libs[name]
                    times[name].append(cs.cuda_ms(
                        lambda: wd.fused_whole_decode(timed[0], cfg,
                                                      timed[1]),
                        iters=5, warmup=1))
            for name, t in times.items():
                wins = sum(a < b for a, b in zip(t, times["planned"]))
                row.append(f"{name} {statistics.median(t):.3f} (quartiles "
                           f"{' '.join(f'{q:.3f}' for q in quartiles(t))}; "
                           f"faster than planned in {wins} of "
                           f"{DECODE_ROUNDS} rounds)")
            print(f"decode B12 {'int8' if int8 else 'bf16'} {B} rows, "
                  f"planned {geos[int8]['rows']} rows a group, median ms "
                  f"of {DECODE_ROUNDS} rounds: " + ", ".join(row),
                  flush=True)
    finally:
        _build._lib = None


def build_variant(edits, out: str) -> ctypes.CDLL:
    """dequant_matmul.cu with the (old, new) text `edits` and an entry
    ``tile_launch(x, w, scale, y, M, K, N, ldw, tile, stream)`` launching
    TILES[tile]."""
    from handwritten_math_ocr_api_torch.ops import _build

    with open(os.path.join(_build.CSRC, "dequant_matmul.cu")) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"dequant_matmul.cu has no {old!r}")
        src = src.replace(old, new)
    cases = "\n".join(
        f"    case {i}: return launch_mma<{kw}, {mw}, {nt}>(x, w, s, y, M, "
        f"K, N, ldw, st);" for i, (kw, mw, nt) in enumerate(TILES))
    entry = (
        'extern "C" int tile_launch(const void* x, const void* w, '
        "const void* s, void* y, int M, int K, int N, int ldw, int tile, "
        "void* stream) {\n"
        "  cudaStream_t st = static_cast<cudaStream_t>(stream);\n"
        f"  switch (tile) {{\n{cases}\n  }}\n  return -2;\n}}\n")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".cu", "w") as f:
        f.write(src + "\n" + entry)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-shared", "-o", out + ".so", out + ".cu"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out + ".so")
    lib.tile_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return lib


def build_csrc_variant(sources, prefixes, edits, out: str) -> ctypes.CDLL:
    """The ``sources`` of ``csrc/``, with the (file, old, new) text
    `edits` applied to them and the headers they include, as one library
    with the entries of ``_build.SIGNATURES`` whose names start with
    ``prefixes``."""
    import glob
    import shutil

    from handwritten_math_ocr_api_torch.ops import _build

    os.makedirs(out, exist_ok=True)
    names = list(sources) + [
        os.path.basename(h) for h in glob.glob(os.path.join(_build.CSRC,
                                                            "*.cuh"))]
    for name in names:
        shutil.copy(os.path.join(_build.CSRC, name), os.path.join(out, name))
    for name, old, new in edits:
        with open(os.path.join(out, name)) as f:
            src = f.read()
        if old not in src:
            raise RuntimeError(f"{name} has no {old!r}")
        with open(os.path.join(out, name), "w") as f:
            f.write(src.replace(old, new))
    lib_path = os.path.join(out, "lib.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", out,
                           "-shared", "-o", lib_path,
                           *(os.path.join(out, name) for name in sources)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on {out}:\n{done.stdout}"
                           f"{done.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith(prefixes):
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = ctypes.c_int
    return lib


def encoder() -> None:
    import torch

    import chip_smoke as cs
    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.models import swin
    from handwritten_math_ocr_api_torch.ops import _build
    from handwritten_math_ocr_api_torch.ops import patch_merging as pm
    from handwritten_math_ocr_api_torch.ops import swin_block as sb

    build = os.path.join(_build.BUILD_ROOT, "kernel_ab")
    with concurrent.futures.ThreadPoolExecutor(len(ENCODER_PHASES)) as pool:
        futures = {name: pool.submit(
            build_csrc_variant, ["swin_block.cu", "patch_merging.cu"],
            ("swin_block", "patch_merging"), edits,
            os.path.join(build, name.replace(" ", "_")))
            for name, edits in ENCODER_PHASES.items()}
        libs = {name: f.result() for name, f in futures.items()}
    cfg = load_model_config(cs.MODEL_DIR)
    np_params = convert.random_params(cfg, cs.SEED)
    params = convert.to_torch(np_params, cfg, "cuda")
    enc = sb.with_float32_biases(np_params["encoder"], params["encoder"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 6)
    B, ws = 16, cfg.swin.window_size
    launch_plan, tile_plan = sb.launch_plan, pm.tile_plan
    try:
        for i, (h, w, c, nh, _, _, _) in enumerate(cs.stage_shapes(cfg, B)):
            hid = int(c * cfg.swin.mlp_ratio)
            x = torch.randn(B, h, w, c, generator=gen, device=dev).bfloat16()
            if sb.fits_vmem(c, ws, -(-w // ws) * ws, hid):
                p = enc["stages"][i]["blocks"][1]
                chosen = launch_plan(B, h, w, c, nh, hid, ws,
                                     _build.sm_count(dev))
                want = sb.fused_swin_block_plain(p, x, ws, ws // 2, nh)
                row = []
                for phase, lib in libs.items():
                    _build._lib = lib
                    if "gather" in phase:
                        continue
                    plans = [sb.smem_plan(c, nh, hid, ws, cluster)
                             for cluster in sb.cluster_sizes(c, nh)]
                    # the narrower warp tiles also with the other number of
                    # warps a block (8 or 16)
                    plans += [pl._replace(warp_rows=6 - pl.warp_rows)
                              for pl in plans if pl.n_tiles == 4]
                    for plan in plans:
                        if phase != "all" and plan != chosen:
                            continue
                        sb.launch_plan = lambda *a, plan=plan: plan
                        got = sb.fused_swin_block(p, x, ws, ws // 2, nh)
                        if phase == "all":
                            cs.assert_close(f"swin_block {plan}", got, want)
                        ms = cs.cuda_ms(lambda: sb.fused_swin_block(
                            p, x, ws, ws // 2, nh))
                        row.append(f"{phase} cluster {plan.cluster} warps "
                                   f"{4 * plan.warp_rows} {ms:.4f}")
                    sb.launch_plan = launch_plan
                _build._lib = None
                blk = params["encoder"]["stages"][i]["blocks"][1]
                unfused = cs.cuda_ms(lambda: swin.swin_block(
                    blk, x, ws, ws // 2, nh, kernels=True,
                    use_pallas_block=False))
                print(f"encoder swin_block stage {i + 1} x {tuple(x.shape)} "
                      f"chosen cluster {chosen.cluster} unfused "
                      f"{unfused:.4f} ms: " + ", ".join(row), flush=True)
            if i == len(cfg.swin.depths) - 1:
                continue
            p = params["encoder"]["merges"][i]
            M = B * (h // 2) * (w // 2)
            chosen = tile_plan(M, c, _build.sm_count(dev))
            want = pm.patch_merging_plain(p, x)
            row = []
            for phase, lib in libs.items():
                if phase not in ("all", "no products", "no weight copies",
                                 "no gather"):
                    continue
                _build._lib = lib
                for cols in (32, 64, 128, 192, 256):
                    smem = 2 * (pm.ROWS * (4 * c + 8) + pm.STAGES * pm.KT
                                * (cols + 8))
                    tiles = (cols, smem)
                    if smem > pm.SMEM_LIMIT or (2 * c) % cols or (
                            phase != "all" and tiles != chosen):
                        continue
                    pm.tile_plan = lambda *a, t=tiles: t
                    got = pm.fused_patch_merging(p, x)
                    if phase == "all":
                        cs.assert_close(f"patch_merging {cols}", got, want)
                    ms = cs.cuda_ms(lambda: pm.fused_patch_merging(p, x))
                    row.append(f"{phase} 32x{cols} {ms:.4f}")
                pm.tile_plan = tile_plan
            _build._lib = None
            cat = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                             x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            g, b = p["norm"]["scale"].bfloat16(), p["norm"]["bias"].bfloat16()
            wr = p["reduction"]["w"].bfloat16()
            unfused = cs.cuda_ms(lambda: torch.nn.functional.layer_norm(
                cat, cat.shape[-1:], g, b, 1e-5) @ wr)
            print(f"encoder patch_merging {i + 1} x {tuple(x.shape)} chosen "
                  f"32x{chosen[0]} unfused {unfused:.4f} ms: "
                  + ", ".join(row), flush=True)
    finally:
        sb.launch_plan, pm.tile_plan = launch_plan, tile_plan
        _build._lib = None


def dequant() -> None:
    import torch

    import chip_smoke as cs
    from handwritten_math_ocr_api_torch import convert
    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.ops import _build, quant

    torch.backends.cuda.matmul.allow_tf32 = False
    build = os.path.join(_build.BUILD_ROOT, "kernel_ab")
    libs = {name: build_variant(edits,
                                os.path.join(build, name.replace(" ", "_")))
            for name, edits in PHASES.items()}
    cfg = load_model_config(cs.MODEL_DIR)
    dec = convert.to_torch({"decoder": quant.quantize_decoder_params(
        convert.random_params(cfg, cs.SEED)["decoder"])}, cfg, "cuda")[
        "decoder"]
    D = cfg.d_model
    sa, ca = dec["layers"][0]["self_attn"], dec["layers"][0]["cross_attn"]
    ffn = dec["layers"][0]["ffn"]
    shapes = [("qkv", sa["w_qkv_q"], sa["w_qkv_scale"]),
              ("out", sa["w_out_q"], sa["w_out_scale"]),
              ("fc1", ffn["fc1"]["w_q"], ffn["fc1"]["w_scale"]),
              ("fc2", ffn["fc2"]["w_q"], ffn["fc2"]["w_scale"])]
    cross_k = ("cross k", ca["w_qkv_q"][:, D:2 * D],
               ca["w_qkv_scale"][D:2 * D])
    cases = [(*w, M) for M in (16, 50) for w in shapes]
    cases += [(*cross_k, M) for M in (480, 1500)]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    stream = _build.stream_handle(torch.device("cuda"))
    for name, w_q, scale, M in cases:
        K, N = w_q.shape
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        w_deq = (w_q.float() * scale).bfloat16()
        want = quant.dequant_matmul_plain(x, w_q, scale)
        y = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        phases = PHASES if name == "cross k" and M == 1500 else ["all"]
        row = [f"matmul {cs.cuda_ms(lambda: torch.matmul(x, w_deq)):.4f}"]
        for phase in phases:
            for i, tile in enumerate(TILES):
                def run():
                    code = libs[phase].tile_launch(
                        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                        y.data_ptr(), M, K, N, w_q.stride(0), i, stream)
                    if code:
                        raise RuntimeError(f"tile {tile}: code {code}")
                try:
                    run()
                except RuntimeError:
                    row.append(f"{phase} {tile} refused")
                    continue
                torch.cuda.synchronize()
                if phase == "all":
                    cs.assert_close(f"{name} {tile}", y, want)
                row.append(f"{phase} {tile} {cs.cuda_ms(run):.4f}")
        print(f"dequant {name} M {M} K {K} N {N} ms: " + ", ".join(row),
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sides = {"_steps": steps_in_process, "_routes": routes_in_process,
             "_app": app_in_process}
    if len(sys.argv) == 4 and sys.argv[1] in sides:
        sides[sys.argv[1]](sys.argv[2], sys.argv[3])
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(cs.nvidia_smi_line(), flush=True)
    if sys.argv[1:2] in (["steps"], ["routes"], ["app"]) \
            and len(sys.argv) >= 3:
        in_turns(sys.argv[1], [os.path.abspath(d) for d in sys.argv[2:]])
    elif sys.argv[1:] == ["decode"]:
        decode()
    elif sys.argv[1:] == ["dequant"]:
        dequant()
    elif sys.argv[1:] == ["encoder"]:
        encoder()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
