"""Every CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``cuda``: each test skips without a CUDA device (the CPU runs the
plain versions only, and ``tests/test_torch_*.py`` hold those against the
JAX package). On the GPU machine, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's ``conftest.py`` configures JAX, which that
machine does not have; this file imports torch and the port only.)

Shapes are the served ones of the ``serving_model_r4`` configuration
(Swin-T at 96x320; decoder d_model 256, 8 heads, 8 layers, FFN 512, vocab
138, T 150) at batch 1 and at a served batch, weights from
``convert.random_params`` (nonzero biases and norms), inputs from a seeded
``torch.Generator``. Tolerances, as ``chip_smoke.py``'s: bf16 atol 2e-2 +
rtol 2e-2 (the kernel and the plain version sum in other orders and so
round an output one or two bf16 steps apart); the decoder steps atol 5e-2
+ rtol 2e-2 in bf16 (8 layers of bf16-rounded matmul inputs); float32
atol 1e-4 + rtol 1e-4 for one kernel and 1e-3 for the decoder steps
(summation order only); the ragged step's argmax equal in float32; the
beam cache reorder exactly (a copy). The int8 bundle of the decoder steps
rounds its matmul inputs to bf16 in float32 too, so it is held at the bf16
step tolerance in both dtypes, and its float32 argmax only where the plain
logits' top two lie further apart than twice their largest error. The
whole step (B10) and the whole decode (B12) are held so too in bf16: a
token may differ from the plain version's only where the plain logits'
top two lie within the step tolerance (a near-tie), and a decode's tokens
must agree up to such a step in each row; in float32 they are equal, and
the whole decode's log-prob sums within 1e-2 (150 float32 log-probs).
The decoder kernels are also held at the ResNet encoders' memory of 10
columns (``RESNET``), with the same tolerances. Device admission's pull
(``ops/admission.py``) is held exactly against its plain install, on a
publication made after its launch, and through a device-admission
``ContinuousDecoder`` against host admission (float32).
"""

import numpy as np
import pytest
import torch

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core.config import (
    EOS_ID,
    PAD_ID,
    ModelConfig,
)
from handwritten_math_ocr_api_torch.models import swin
from handwritten_math_ocr_api_torch.ops import beam_reorder as br
from handwritten_math_ocr_api_torch.ops import cache_attention as ca
from handwritten_math_ocr_api_torch.ops import fused_step as fs
from handwritten_math_ocr_api_torch.ops import patch_merging as pm
from handwritten_math_ocr_api_torch.ops import quant
from handwritten_math_ocr_api_torch.ops import swin_block as sb
from handwritten_math_ocr_api_torch.ops import whole_decode as wd
from handwritten_math_ocr_api_torch.ops import window_attention as wa

pytestmark = pytest.mark.cuda

CFG = ModelConfig(vocab_size=138, dropout=0.0, memory_norm=True)
DTYPES = ["bfloat16", "float32"]
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}
STEP_TOL = {"bfloat16": (5e-2, 2e-2), "float32": (1e-3, 1e-3)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def np_params():
    return convert.random_params(CFG, seed=0)


def _randn(dev, dtype, *shape, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev).to(
        getattr(torch, dtype))


def _close(got, want, tol):
    torch.cuda.synchronize()
    atol, rtol = tol
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _launched(wrapper, fn, attr="launches"):
    before = getattr(wrapper, attr)
    out = fn()
    assert getattr(wrapper, attr) == before + 1
    return out


# Swin-T at 96x320, window 7: per stage (padded H, padded W, heads); the
# windows are (H / 7) * (W / 7): 48, 12, 3, 2
STAGES = [(28, 84, 3), (14, 42, 6), (7, 21, 12), (7, 14, 24)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("stage", range(len(STAGES)))
def test_window_attention(dev, np_params, dtype, B, stage):
    """Every stage shape of the served batch, with the unshifted block's
    (1, nh, N, N) mask (read for every window), the same mask expanded to
    (nW, nh, N, N), and the shifted block's mask."""
    params = convert.to_torch(np_params, CFG.replace(dtype=dtype), dev)
    p = params["encoder"]["stages"][stage]["blocks"][1]["attn"]
    ph, pw, nh = STAGES[stage]
    nW, N, dh = (ph // 7) * (pw // 7), 49, 32
    plain = swin.attention_mask(p, 7, nh, ph, pw, 0, 0)
    shifted = swin.attention_mask(p, 7, nh, ph, pw, 0 if ph <= 7 else 3,
                                  0 if pw <= 7 else 3)
    assert plain.shape[0] == 1 and shifted.shape[0] == nW
    q, k, v = (_randn(dev, dtype, B, nW, nh, N, dh, seed=i)
               for i in range(3))
    for mask in (plain.contiguous(),
                 plain.expand(nW, nh, N, N).contiguous(),
                 shifted.contiguous()):
        got = _launched(wa.window_attention_core,
                        lambda: wa.window_attention_core(q, k, v, mask))
        _close(got, wa.window_attention_core_plain(q, k, v, mask),
               TOL[dtype])


def test_kernels_refuse_shapes(dev, np_params):
    """Shapes the bf16 window kernel, the cache attention kernel, the Swin
    block kernel (a head dim that is not a multiple of 8) and the patch
    merging kernel (a C that is not a multiple of 16) do not take raise
    ValueError on the card, with no launch counted."""
    bf16 = torch.bfloat16
    q = torch.zeros(1, 3, 2, 49, 24, dtype=bf16, device=dev)  # dh 24
    mask = torch.zeros(3, 2, 49, 49, device=dev)
    before = wa.window_attention_core.launches
    with pytest.raises(ValueError):
        wa.window_attention_core(q, q, q, mask)
    q = torch.zeros(1, 3, 2, 65, 32, dtype=bf16, device=dev)  # N 65
    mask = torch.zeros(3, 2, 65, 65, device=dev)
    with pytest.raises(ValueError):
        wa.window_attention_core(q, q, q, mask)
    assert wa.window_attention_core.launches == before

    before = (ca.cache_append_attention.launches, ca.decode_attention.launches)
    q = torch.zeros(2, 8, 1, 24, dtype=bf16, device=dev)  # 48-byte rows
    cache = torch.zeros(2, 8, 150, 24, dtype=bf16, device=dev)
    with pytest.raises(ValueError):
        ca.cache_append_attention(q, q, q, cache, cache.clone(), 3)
    with pytest.raises(ValueError):
        ca.decode_attention(q, cache, cache, 3)
    q = torch.zeros(2, 8, 1, 32, dtype=bf16, device=dev)
    flat = torch.zeros(2 * 8 * 150 * 32 + 1, dtype=bf16, device=dev)
    shifted = flat[1:].view(2, 8, 150, 32)  # 2 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        ca.cache_append_attention(q, q, q, shifted, shifted, 3)
    with pytest.raises(ValueError, match="16-byte"):
        ca.decode_attention(q, shifted, shifted, 3)
    assert (ca.cache_append_attention.launches,
            ca.decode_attention.launches) == before

    # Swin block: C 60 with 3 heads (head dim 20)
    params = convert.to_torch(np_params, CFG.replace(dtype="bfloat16"), dev)
    blk = sb.with_float32_biases(np_params["encoder"], params["encoder"])
    x = torch.zeros(1, 7, 7, 60, dtype=bf16, device=dev)
    before = sb.fused_swin_block.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        sb.fused_swin_block(blk["stages"][0]["blocks"][0], x, 7, 0, 3)
    assert sb.fused_swin_block.launches == before

    # patch merging: C 12
    before = pm.fused_patch_merging.launches
    merge = {"norm": {"scale": torch.ones(48, device=dev),
                      "bias": torch.zeros(48, device=dev)},
             "reduction": {"w": torch.zeros(48, 24, dtype=bf16, device=dev)}}
    with pytest.raises(ValueError, match="multiple of 16"):
        pm.fused_patch_merging(merge, torch.zeros(1, 4, 4, 12, dtype=bf16,
                                                  device=dev))
    assert pm.fused_patch_merging.launches == before


# the three merges of Swin-T at 96x320 at batch 1 and 16: (merge, H, W, B);
# and one whose M (15 tokens) is not a multiple of any row tile
MERGES = [(i, 24 >> i, 80 >> i, B) for i in range(3) for B in (1, 16)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("merge", [*MERGES, (0, 6, 10, 1)])
def test_patch_merging(dev, np_params, dtype, merge):
    i, h, w, B = merge
    params = convert.to_torch(np_params, CFG.replace(dtype=dtype), dev)
    p = params["encoder"]["merges"][i]
    x = _randn(dev, dtype, B, h, w, 96 << i, seed=B + i)
    got = _launched(pm.fused_patch_merging,
                    lambda: pm.fused_patch_merging(p, x))
    _close(got, pm.patch_merging_plain(p, x), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 16, 50])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_cache_append_and_decode_attention(dev, dtype, B, Dh):
    """Greedy (16 rows) and the default beam route (50 rows: G = 400) at
    the served head dim 32 and at 64 and 128, at the first slots, around a
    16-byte copy's tail and at the last slots. A wave of the kernel holds
    40 KB of K and V: float32 at Dh 64 and 128 takes the prefix in several
    waves (the online softmax)."""
    H, T = 8, 150
    k_cache, v_cache = (_randn(dev, dtype, B, H, T, Dh, seed=i)
                        for i in range(2))
    for pos in (0, 1, 7, 8, 74, 148, 149):
        q, kn, vn = (_randn(dev, dtype, B, H, 1, Dh, seed=pos + i)
                     for i in range(3))
        k2, v2 = k_cache.clone(), v_cache.clone()
        got = _launched(ca.cache_append_attention,
                        lambda: ca.cache_append_attention(
                            q, kn, vn, k_cache, v_cache, pos))
        want = ca.cache_append_attention_plain(q, kn, vn, k2, v2, pos)
        _close(got, want, TOL[dtype])
        assert torch.equal(k_cache, k2) and torch.equal(v_cache, v2)
        got = _launched(ca.decode_attention,
                        lambda: ca.decode_attention(q, k_cache, v_cache,
                                                    pos))
        _close(got, ca.decode_attention_plain(q, k_cache, v_cache, pos),
               TOL[dtype])
        assert torch.equal(k_cache, k2) and torch.equal(v_cache, v2)


# B1/B11's batch sizes, each its own launch shape on an H100 (cluster
# groups of 1, 1, 2, 4 and 8 rows: the fewest rows a group whose clusters
# the card holds at once): one row, the five of a small batch, the greedy
# bucket, 40 rows and the largest served bucket; its slots: the
# first, either side of a self-cache copy box's end (16 slots), a middle
# and the last
STEP_BATCHES = [1, 5, 16, 40, 64]
STEP_POSITIONS = (0, 1, 16, 17, 74, 149)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", STEP_BATCHES)
def test_fused_decoder_step(dev, np_params, dtype, B):
    cfg = CFG.replace(dtype=dtype)
    stacked = fs.build_stacked(np_params["decoder"], cfg, dev)
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    sk, sv = (_randn(dev, dtype, L, B, T, D, seed=i) for i in range(2))
    ck, cv = (_randn(dev, dtype, L, B, L_enc, D, seed=2 + i)
              for i in range(2))
    x = _randn(dev, dtype, B, D, seed=4)
    for pos in STEP_POSITIONS:
        got = _launched(fs.fused_decoder_layers_step_v2,
                        lambda: fs.fused_decoder_layers_step_v2(
                            stacked, cfg, x, sk, sv, ck, cv, pos))
        want = fs.fused_decoder_layers_step_v2_plain(stacked, cfg, x, sk, sv,
                                                     ck, cv, pos)
        for g, w in zip(got, want):
            _close(g, w, STEP_TOL[dtype])


@pytest.mark.parametrize("B", STEP_BATCHES)
def test_fused_decoder_step_int8(dev, np_params, B):
    cfg = CFG.replace(dtype="bfloat16")
    stacked = fs.quantize_stacked(fs.build_stacked(np_params["decoder"], cfg,
                                                   dev))
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    sk, sv = (_randn(dev, "bfloat16", L, B, T, D, seed=i) for i in range(2))
    ck, cv = (_randn(dev, "bfloat16", L, B, L_enc, D, seed=2 + i)
              for i in range(2))
    x = _randn(dev, "bfloat16", B, D, seed=4)
    for pos in STEP_POSITIONS:
        got = _launched(fs.fused_decoder_layers_step_v2,
                        lambda: fs.fused_decoder_layers_step_v2(
                            stacked, cfg, x, sk, sv, ck, cv, pos),
                        "int8_launches")
        want = fs.fused_decoder_layers_step_v2_plain(stacked, cfg, x, sk, sv,
                                                     ck, cv, pos)
        for g, w in zip(got, want):
            _close(g, w, STEP_TOL["bfloat16"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", STEP_BATCHES)
def test_layers_step_in_place(dev, np_params, dtype, B):
    """B11: x_out and the written slot within the step tolerance of the
    plain step's; every other slot of the caches bit for bit unchanged."""
    cfg = CFG.replace(dtype=dtype)
    stacked = fs.build_stacked(np_params["decoder"], cfg, dev)
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    sk, sv = (_randn(dev, dtype, L, B, T, D, seed=i) for i in range(2))
    ck, cv = (_randn(dev, dtype, L, B, L_enc, D, seed=2 + i)
              for i in range(2))
    x = _randn(dev, dtype, B, D, seed=4)
    for pos in STEP_POSITIONS:
        got_k, got_v = sk.clone(), sv.clone()
        want_k, want_v = sk.clone(), sv.clone()
        got = _launched(fs.fused_decoder_layers_step,
                        lambda: fs.fused_decoder_layers_step(
                            stacked, cfg, x, got_k, got_v, ck, cv, pos))
        want = fs.fused_decoder_layers_step_plain(stacked, cfg, x, want_k,
                                                  want_v, ck, cv, pos)
        _close(got[0], want[0], STEP_TOL[dtype])
        other = torch.arange(T, device=dev) != pos
        for g, w, old in ((got_k, want_k, sk), (got_v, want_v, sv)):
            _close(g[:, :, pos], w[:, :, pos], STEP_TOL[dtype])
            assert torch.equal(g[:, :, other], old[:, :, other])


@pytest.mark.parametrize("change,quantized", [
    ({"dim_feedforward": 200}, False),  # 25 FFN columns a block
    ({"dim_feedforward": 192}, True),   # 24 int8 columns a block, not 16k
    ({"d_model": 320}, False),          # a head's row of 5 16-byte vectors
])
def test_fused_decoder_step_refuses_shapes(dev, change, quantized):
    """A model the cluster kernels do not split raises ValueError on the
    card (their C entries' refusal), with no launch counted: B1, B11 and
    the ragged step (B7)."""
    cfg = CFG.replace(dtype="bfloat16", num_decoder_layers=1, **change)
    stacked = fs.build_stacked_full(
        convert.random_params(cfg, seed=1)["decoder"], cfg, dev)
    if quantized:
        stacked = fs.quantize_stacked(stacked)
    bf16 = torch.bfloat16
    L, B, T, D, L_enc = 1, 2, 8, cfg.d_model, 4
    zeros = torch.zeros
    sk = zeros(L, B, T, D, dtype=bf16, device=dev)
    ck = zeros(L, B, L_enc, D, dtype=bf16, device=dev)
    x = zeros(B, D, dtype=bf16, device=dev)
    before = (fs.fused_decoder_layers_step_v2.launches,
              fs.fused_decoder_layers_step_v2.int8_launches,
              fs.fused_decoder_layers_step.launches)
    ragged_before = (fs.fused_ragged_step.launches,
                     fs.fused_ragged_step.int8_launches)
    with pytest.raises(ValueError, match="does not take"):
        fs.fused_decoder_layers_step_v2(stacked, cfg, x, sk, sk, ck, ck, 3)
    if not quantized:
        with pytest.raises(ValueError, match="does not take"):
            fs.fused_decoder_layers_step(stacked, cfg, x, sk, sk.clone(), ck,
                                         ck, 3)
    rows = torch.zeros(B, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="does not take"):
        fs.fused_ragged_step(stacked, cfg, rows, rows + 3, sk, sk, ck, ck)
    assert (fs.fused_decoder_layers_step_v2.launches,
            fs.fused_decoder_layers_step_v2.int8_launches,
            fs.fused_decoder_layers_step.launches) == before
    assert (fs.fused_ragged_step.launches,
            fs.fused_ragged_step.int8_launches) == ragged_before


def _hold_picks(nxt, want_nxt, logits, atol):
    """Greedy picks equal wherever the plain logits' top two lie further
    apart than ``atol``."""
    top2 = logits.topk(2, dim=-1).values
    clear = top2[..., 0] - top2[..., 1] > atol
    assert torch.equal(nxt[clear], want_nxt[clear])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("B", [1, 5, 16, 40, 50, 64])
def test_whole_step(dev, np_params, dtype, time_major, B):
    """B10 in both layouts, at the batch sizes the cluster kernel groups
    differently (50 rows: groups of 4, the last one partial): nxt as the
    plain step's (equal in float32; in bf16 except at near-ties), logp
    and the fresh rows within the step tolerance; time-major caches
    written at pos, every other slot bit for bit unchanged."""
    cfg = CFG.replace(dtype=dtype)
    stacked = fs.build_stacked_full(np_params["decoder"], cfg, dev)
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    shape = (L, T, B, D) if time_major else (L, B, T, D)
    sk, sv = (_randn(dev, dtype, *shape, seed=i) for i in range(2))
    ck, cv = (_randn(dev, dtype, L, B, L_enc, D, seed=2 + i)
              for i in range(2))
    gen = torch.Generator(device=dev).manual_seed(8)
    prev = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    for pos in (0, 74, 149):
        got_k, got_v = sk.clone(), sv.clone()
        want_k, want_v = sk.clone(), sv.clone()
        got = _launched(fs.fused_whole_step,
                        lambda: fs.fused_whole_step(
                            stacked, cfg, prev, got_k, got_v, ck, cv, pos,
                            time_major=time_major))
        want = fs.fused_whole_step_plain(stacked, cfg, prev, want_k, want_v,
                                         ck, cv, pos, time_major=time_major)
        # the plain step's logits, for the near-tie rule
        cache_k = want_k.transpose(1, 2) if time_major else want_k
        cache_v = want_v.transpose(1, 2) if time_major else want_v
        logits = fs.fused_ragged_step_plain(
            stacked, cfg, prev, torch.full((B,), pos, dtype=torch.int32,
                                           device=dev),
            cache_k, cache_v, ck, cv, return_logits=True)[0]
        torch.cuda.synchronize()
        if dtype == "float32":
            assert torch.equal(got[0], want[0])
        else:
            _hold_picks(got[0], want[0], logits, STEP_TOL[dtype][0])
        _close(got[1], want[1], STEP_TOL[dtype])
        if time_major:
            other = torch.arange(T, device=dev) != pos
            for g, w, old in ((got_k, want_k, sk), (got_v, want_v, sv)):
                _close(g[:, pos], w[:, pos], STEP_TOL[dtype])
                assert torch.equal(g[:, other], old[:, other])
        else:
            assert torch.equal(got_k, sk) and torch.equal(got_v, sv)
            for g, w in zip(got[2:], want[2:]):
                _close(g, w, STEP_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("time_major", [True, False])
def test_whole_step_dead_row(dev, np_params, dtype, time_major):
    """Rows whose prev lies outside the vocabulary beside good ones in
    their cluster's group (16 rows at the last slot: groups of 2, rows 1
    and 6 dead): nxt -1, logp NaN and NaN fresh rows in those rows only
    (time-major: at slot pos, no other slot touched), the other rows as
    the plain step gives them."""
    import chip_smoke

    cfg = CFG.replace(dtype=dtype)
    stacked = fs.build_stacked_full(np_params["decoder"], cfg, dev)
    L, T, D, L_enc, B, V = 8, 150, 256, cfg.encoder_len, 16, cfg.vocab_size
    pos = T - 1      # the launch is planned at pos, the geometry at T - 1
    shape = (L, T, B, D) if time_major else (L, B, T, D)
    sk, sv = (_randn(dev, dtype, *shape, seed=20 + i) for i in range(2))
    ck, cv = (_randn(dev, dtype, L, B, L_enc, D, seed=22 + i)
              for i in range(2))
    prev = (torch.arange(B, dtype=torch.int32, device=dev) * 7 + 3) % V
    prev[1], prev[6] = -1, V
    dead = (prev < 0) | (prev >= V)
    geo = fs.cluster_geometry("whole_step", cfg, B, T, L_enc,
                              getattr(torch, dtype), V=V)
    assert geo["rows"] >= 2
    assert chip_smoke.mixed_groups(dead.tolist(), geo["rows"])
    got_k, got_v = sk.clone(), sv.clone()
    want_k, want_v = sk.clone(), sv.clone()
    got = _launched(fs.fused_whole_step,
                    lambda: fs.fused_whole_step(
                        stacked, cfg, prev, got_k, got_v, ck, cv, pos,
                        time_major=time_major))
    want = fs.fused_whole_step_plain(stacked, cfg, prev.clamp(0, V - 1),
                                     want_k, want_v, ck, cv, pos,
                                     time_major=time_major)
    torch.cuda.synchronize()
    assert got[0][dead].tolist() == [-1, -1]
    assert torch.isnan(got[1][dead]).all()
    if dtype == "float32":
        assert torch.equal(got[0][~dead], want[0][~dead])
    _close(got[1][~dead], want[1][~dead], STEP_TOL[dtype])
    if time_major:
        other = torch.arange(T, device=dev) != pos
        rows = [(g[:, pos], w[:, pos], g, old)
                for g, w, old in ((got_k, want_k, sk), (got_v, want_v, sv))]
        for g_row, w_row, g, old in rows:
            assert torch.equal(g[:, other], old[:, other])
            assert torch.isnan(g_row[:, dead].float()).all()
            _close(g_row[:, ~dead], w_row[:, ~dead], STEP_TOL[dtype])
    else:
        assert torch.equal(got_k, sk) and torch.equal(got_v, sv)
        for g, w in zip(got[2:], want[2:]):
            assert torch.isnan(g[:, dead].float()).all()
            _close(g[:, ~dead], w[:, ~dead], STEP_TOL[dtype])


def _hold_decode(got, want, logits, atol):
    """Each row's tokens equal the plain decode's up to its first
    difference, which must come where the plain logits' top two lie
    within ``atol``; rows without one have equal counts. Returns the
    rows that agree throughout."""
    same = []
    for r in range(got.tokens.shape[0]):
        differ = (got.tokens[r] != want.tokens[r]).nonzero()
        if len(differ):
            t = int(differ[0])
            top2 = logits[r, t].topk(2).values
            assert float(top2[0] - top2[1]) < atol, (r, t)
        else:
            assert got.token_count[r] == want.token_count[r]
            same.append(r)
    return same


@pytest.mark.parametrize("bundle", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("B", [1, 5, 16, 17])
def test_whole_decode(dev, np_params, bundle, B):
    """B12 over 150 steps from random encoder memory, against its plain
    version, at the batch sizes the cluster decode groups differently (17
    rows: groups of 2, the last one partial):
    float32 tokens, lengths and counts equal and log-prob sums within
    1e-2; bf16 and the int8 bundle (bf16 caches) held by
    ``_hold_decode``."""
    dtype = "float32" if bundle == "float32" else "bfloat16"
    cfg = CFG.replace(dtype=dtype)
    params = convert.to_torch(np_params, cfg, dev)
    resident = wd.build_resident(params["decoder"], cfg, bundle == "int8")
    memory = _randn(dev, dtype, B, cfg.encoder_len, cfg.d_model, seed=9)
    attr = "int8_launches" if bundle == "int8" else "launches"
    got = _launched(wd.fused_whole_decode,
                    lambda: wd.fused_whole_decode(resident, cfg, memory),
                    attr)
    want, logits = wd.fused_whole_decode_plain(resident, cfg, memory,
                                               return_logits=True)
    torch.cuda.synchronize()
    assert got.tokens.shape == (B, cfg.max_seq_len)
    assert torch.equal(got.lengths, (got.tokens != 0).sum(-1))
    if bundle == "float32":
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.token_count, want.token_count)
        torch.testing.assert_close(got.logprob_sum, want.logprob_sum,
                                   atol=1e-2, rtol=0)
    else:
        _hold_decode(got, want, logits, STEP_TOL["bfloat16"][0])


@pytest.mark.parametrize("bundle", ["bfloat16", "float32", "int8"])
def test_whole_decode_eos(dev, np_params, bundle):
    """B12 on chip_smoke's EOS-boosted bundle and 16-row memory, whose
    rows end at different steps and some never, with rows that finish
    beside live ones in their cluster's group (groups of 2): tokens (PAD
    after each EOS), lengths, counts and log-prob sums of the finished and
    the live rows against the plain version; float32 equal (sums within
    1e-2), bf16 and int8 held by ``_hold_decode`` with the sums of the
    rows that agree within 0.5 (chip_smoke's WHOLE_DECODE_LP_ATOL: 150
    bf16 log-probs)."""
    import chip_smoke

    dtype = "float32" if bundle == "float32" else "bfloat16"
    cfg = CFG.replace(dtype=dtype)
    dec = dict(np_params["decoder"])
    b = np.array(dec["fc_out"]["b"], np.float32)
    b[EOS_ID] += chip_smoke.EOS_BOOST
    dec["fc_out"] = {**dec["fc_out"], "b": b}
    params = convert.to_torch({"decoder": dec}, cfg, dev)
    resident = wd.build_resident(params["decoder"], cfg, bundle == "int8")
    rng = np.random.default_rng(9)
    B, T = 16, cfg.max_seq_len
    memory = torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)).to(
        dev, getattr(torch, dtype))
    geo = fs.cluster_geometry("whole_decode", cfg, B, T, cfg.encoder_len,
                              getattr(torch, dtype), bundle == "int8",
                              cfg.vocab_size)
    attr = "int8_launches" if bundle == "int8" else "launches"
    got = _launched(wd.fused_whole_decode,
                    lambda: wd.fused_whole_decode(resident, cfg, memory),
                    attr)
    want, logits = wd.fused_whole_decode_plain(resident, cfg, memory,
                                               return_logits=True)
    torch.cuda.synchronize()
    ends = chip_smoke.finishing(got, EOS_ID, PAD_ID)
    finished = [e for e in ends if e is not None]
    assert None in ends and len(set(finished)) > 1, ends
    assert geo["rows"] >= 2
    assert chip_smoke.mixed_groups(
        chip_smoke.steps_per_row(got.tokens, EOS_ID), geo["rows"]), ends
    if bundle == "float32":
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.token_count, want.token_count)
        torch.testing.assert_close(got.logprob_sum, want.logprob_sum,
                                   atol=1e-2, rtol=0)
    else:
        same = _hold_decode(got, want, logits, STEP_TOL["bfloat16"][0])
        assert torch.equal(got.lengths[same], want.lengths[same])
        torch.testing.assert_close(got.logprob_sum[same],
                                   want.logprob_sum[same], atol=0.5, rtol=0)


@pytest.mark.parametrize("change,quantized", [
    ({"dim_feedforward": 200}, False),  # 25 FFN columns a block
    ({"dim_feedforward": 192}, True),   # 24 int8 columns a block, not 16k
    ({"d_model": 320}, False),          # a head's row of 5 16-byte vectors
])
def test_whole_step_and_decode_refuse_shapes(dev, change, quantized):
    """A model the cluster kernels do not split raises ValueError on the
    card (their C entries' refusal), with no launch counted: B10 (float
    bundles only) and B12."""
    cfg = CFG.replace(dtype="bfloat16", num_decoder_layers=1, **change)
    np_dec = convert.random_params(cfg, seed=1)["decoder"]
    bf16 = torch.bfloat16
    B, T, D, L_enc = 2, 8, cfg.d_model, 4
    if not quantized:
        stacked = fs.build_stacked_full(np_dec, cfg, dev)
        sk = torch.zeros(1, B, T, D, dtype=bf16, device=dev)
        ck = torch.zeros(1, B, L_enc, D, dtype=bf16, device=dev)
        prev = torch.zeros(B, dtype=torch.int32, device=dev)
        before = fs.fused_whole_step.launches
        for time_major in (False, True):
            caches = sk.transpose(1, 2).contiguous() if time_major else sk
            with pytest.raises(ValueError, match="does not take"):
                fs.fused_whole_step(stacked, cfg, prev, caches,
                                    caches.clone(), ck, ck, 3,
                                    time_major=time_major)
        assert fs.fused_whole_step.launches == before
    dec = convert.to_torch({"decoder": np_dec}, cfg, dev)["decoder"]
    resident = wd.build_resident(dec, cfg, quantized)
    memory = torch.zeros(B, L_enc, D, dtype=bf16, device=dev)
    before = (wd.fused_whole_decode.launches,
              wd.fused_whole_decode.int8_launches)
    with pytest.raises(ValueError, match="does not take"):
        wd.fused_whole_decode(resident, cfg, memory, T)
    assert (wd.fused_whole_decode.launches,
            wd.fused_whole_decode.int8_launches) == before


def test_whole_step_and_decode_geometry(dev):
    """B10's and B12's launch shapes at the greedy bucket: groups of at
    most 16 rows on 8-block clusters, every row counted once; B12's
    planned with its resident head."""
    for dtype in (torch.bfloat16, torch.float32):
        geo = fs.cluster_geometry("whole_step", CFG, 16, 150,
                                  CFG.encoder_len, dtype, V=CFG.vocab_size)
        assert geo["blocks"] == 8 and 1 <= geo["rows"] <= 16
        assert geo["clusters"] == -(-16 // geo["rows"])
        for quantized in (False, True):
            geo = fs.cluster_geometry("whole_decode", CFG, 16, 150,
                                      CFG.encoder_len, dtype, quantized,
                                      CFG.vocab_size)
            assert geo["blocks"] == 8 and 1 <= geo["rows"] <= 16
            assert geo["clusters"] == -(-16 // geo["rows"])
            assert geo["active_clusters"] >= 1 and geo["stages"] >= 1


def _dequant_cases(dec, batch):
    """(name, w_q, scale, M) at every shape the default int8 route serves:
    a layer's six projections and the head at ``batch`` rows, the cross
    K/V projection of the memory (a column slice)."""
    D, L_enc = CFG.d_model, CFG.encoder_len
    sa, ca = dec["layers"][0]["self_attn"], dec["layers"][0]["cross_attn"]
    ffn = dec["layers"][0]["ffn"]
    return [("qkv", sa["w_qkv_q"], sa["w_qkv_scale"], batch),
            ("out", sa["w_out_q"], sa["w_out_scale"], batch),
            ("cross q", ca["w_qkv_q"][:, :D], ca["w_qkv_scale"][:D], batch),
            ("cross out", ca["w_out_q"], ca["w_out_scale"], batch),
            ("fc1", ffn["fc1"]["w_q"], ffn["fc1"]["w_scale"], batch),
            ("fc2", ffn["fc2"]["w_q"], ffn["fc2"]["w_scale"], batch),
            ("head", dec["fc_out"]["w_q"], dec["fc_out"]["w_scale"], batch),
            ("cross k", ca["w_qkv_q"][:, D:2 * D], ca["w_qkv_scale"][D:2 * D],
             batch * L_enc),
            ("cross v", ca["w_qkv_q"][:, 2 * D:], ca["w_qkv_scale"][2 * D:],
             batch * L_enc)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 16, 50])
def test_dequant_matmul(dev, np_params, dtype, batch):
    """Both entries (bf16 x, float32 x) at every served shape: the
    138-column head (byte loads) and the strided column slices included."""
    cfg = CFG.replace(dtype=dtype)
    dec = convert.to_torch(
        {"decoder": quant.quantize_decoder_params(np_params["decoder"])},
        cfg, dev)["decoder"]
    for i, (name, w_q, scale, M) in enumerate(_dequant_cases(dec, batch)):
        x = _randn(dev, dtype, M, w_q.shape[0], seed=10 + i)
        got = _launched(quant.dequant_matmul,
                        lambda: quant.dequant_matmul(x, w_q, scale))
        assert got.dtype == x.dtype and tuple(got.shape) == (M, w_q.shape[1])
        _close(got, quant.dequant_matmul_plain(x, w_q, scale), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [
    (1, 200, 48),     # K a multiple of 8, not of the 16-row k-step
    (50, 100, 20),    # K not a multiple of 8 (x staged by element), N < 32
    (300, 72, 138),   # many row blocks, the unaligned head width
    (64, 512, 768),   # the most rows of one block
    (65, 256, 256),   # one row past it: the tall tiles
])
def test_dequant_matmul_ragged_edges(dev, dtype, M, K, N):
    """Shapes past the served ones: K not a multiple of the kernel's
    k-step (and of 8), columns and rows past a tile's edge, a weight with
    unaligned rows; and a column slice of a wider matrix."""
    w, scale = quant.quantize_weight(
        0.05 * _randn(dev, "float32", K, 3 * N, seed=M + K + N))
    x = _randn(dev, dtype, M, K, seed=K)
    for w_q, s in ((w[:, :N].contiguous(), scale[:N].contiguous()),
                   (w[:, N:2 * N], scale[N:2 * N])):
        got = _launched(quant.dequant_matmul,
                        lambda: quant.dequant_matmul(x, w_q, s))
        _close(got, quant.dequant_matmul_plain(x, w_q, s), TOL[dtype])


# the fused stages of Swin-T at 96x320: (stage, H, W); and a stage-1 map
# padded in both dimensions (9 x 11 to 14 x 14), whose padded tokens are
# real keys beside the product's 49 -> 64 padding rows
SWIN_MAPS = [(0, 24, 80), (1, 12, 40), (2, 6, 20), (0, 9, 11)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 2, 3, 16])
@pytest.mark.parametrize("stage", range(len(SWIN_MAPS)))
def test_swin_block(dev, np_params, dtype, B, stage):
    """Batch 1, 2, 3 (a cluster partly filled) and the 16-image bucket,
    unshifted and shifted, with the engine's bundle (float32 biases)."""
    params = convert.to_torch(np_params, CFG.replace(dtype=dtype), dev)
    encoder = sb.with_float32_biases(np_params["encoder"], params["encoder"])
    i, h, w = SWIN_MAPS[stage]
    p = encoder["stages"][i]["blocks"][1]
    c, nh = 96 << i, CFG.swin.num_heads[i]
    x = _randn(dev, dtype, B, h, w, c, seed=B)
    for shift in (0, 3):
        got = _launched(sb.fused_swin_block,
                        lambda: sb.fused_swin_block(p, x, 7, shift, nh))
        _close(got, sb.fused_swin_block_plain(p, x, 7, shift, nh),
               TOL[dtype])


@pytest.mark.parametrize("B", [1, 16])
def test_swin_block_geometry(dev, B):
    """The bf16 block kernel's launch shape at each fused stage: the
    cluster the plan picks for the card's SMs, a grid of windows x cluster
    blocks, and at least one such cluster fitting on the card; stage 3 at
    the bucket runs on more than its 48 windows."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, h, w in SWIN_MAPS[:3]:
        c, nh = 96 << i, CFG.swin.num_heads[i]
        geo = sb.block_geometry(B, h, w, c, nh, 4 * c, 7, dev)
        plan = sb.launch_plan(B, h, w, c, nh, 4 * c, 7, sms)
        assert geo["cluster"] == plan.cluster and geo["smem"] == plan.smem
        assert geo["windows"] == B * -(-h // 7) * -(-w // 7)
        assert geo["blocks"] == geo["windows"] * geo["cluster"]
        assert geo["active_clusters"] >= 1
        if i == 2 and B == 16:
            assert geo["blocks"] > 48


# B7's row counts: one row, five rows (one a group), the greedy bucket
# (groups of 2), the beam's 50 rows (13 groups of 4, the last partial),
# the largest served bucket and more rows than one group a cluster of the
# card holds at once
RAGGED_ROWS = [1, 5, 16, 50, 64, 130]


def _ragged_inputs(dev, cfg, R, seed):
    """Caches, cross K/V and prev for R rows; positions: all at the first
    slot, all at the last, a random vector, and 0 and T - 1 alternating in
    one launch."""
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    sk, sv = (_randn(dev, cfg.dtype, L, R, T, D, seed=seed + i)
              for i in range(2))
    ck, cv = (_randn(dev, cfg.dtype, L, R, L_enc, D, seed=seed + 2 + i)
              for i in range(2))
    gen = torch.Generator(device=dev).manual_seed(seed)
    prev = torch.randint(0, cfg.vocab_size, (R,), generator=gen,
                         device=dev, dtype=torch.int32)
    i32 = torch.int32
    positions = (torch.full((R,), 0, dtype=i32, device=dev),
                 torch.full((R,), T - 1, dtype=i32, device=dev),
                 torch.randint(0, T, (R,), generator=gen, device=dev,
                               dtype=i32),
                 torch.arange(R, device=dev, dtype=i32) % 2 * (T - 1))
    return prev, positions, (sk, sv, ck, cv)


def _ragged_bundle(np_params, cfg, dev, bundle):
    stacked = fs.build_stacked_full(np_params["decoder"], cfg, dev)
    return fs.quantize_stacked(stacked) if bundle == "int8" else stacked


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", RAGGED_ROWS)
def test_ragged_step(dev, np_params, dtype, R):
    """Both head modes against the plain step: logits, logp and the fresh
    rows within the step tolerance, the argmax equal in float32."""
    cfg = CFG.replace(dtype=dtype)
    stacked = _ragged_bundle(np_params, cfg, dev, "float")
    prev, positions, caches = _ragged_inputs(dev, cfg, R, seed=R)
    for pos in positions:
        for logits in (True, False):
            got = _launched(fs.fused_ragged_step,
                            lambda: fs.fused_ragged_step(
                                stacked, cfg, prev, pos, *caches,
                                return_logits=logits))
            want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos,
                                              *caches, return_logits=logits)
            if not logits:
                if dtype == "float32":
                    assert torch.equal(got[0], want[0])
                got, want = got[1:], want[1:]
            for g, w in zip(got, want):
                _close(g, w, STEP_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", RAGGED_ROWS)
def test_ragged_step_int8(dev, np_params, dtype, R):
    """The int8 bundle (bf16 matmul inputs in both dtypes): the bf16 step
    tolerance, the argmax equal wherever the plain logits' top two lie
    further apart than twice the largest logits error."""
    cfg = CFG.replace(dtype=dtype)
    stacked = _ragged_bundle(np_params, cfg, dev, "int8")
    prev, positions, caches = _ragged_inputs(dev, cfg, R, seed=R + 7)
    for pos in positions:
        got = _launched(fs.fused_ragged_step,
                        lambda: fs.fused_ragged_step(
                            stacked, cfg, prev, pos, *caches,
                            return_logits=True), "int8_launches")
        want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                          return_logits=True)
        for g, w in zip(got, want):
            _close(g, w, STEP_TOL["bfloat16"])
        logits_err = (got[0] - want[0]).abs().max()
        top2 = want[0].topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 2 * logits_err
        nxt = _launched(fs.fused_ragged_step,
                        lambda: fs.fused_ragged_step(
                            stacked, cfg, prev, pos, *caches),
                        "int8_launches")
        want_nxt = fs.fused_ragged_step_plain(stacked, cfg, prev, pos,
                                              *caches)
        assert torch.equal(nxt[0][clear], want_nxt[0][clear])
        for g, w in zip(nxt[1:], want_nxt[1:]):
            _close(g, w, STEP_TOL["bfloat16"])


@pytest.mark.parametrize("bundle", ["float", "int8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_step_dead_row(dev, np_params, dtype, bundle):
    """Rows whose pos or prev is out of range beside good ones in their
    cluster's group (16 rows: groups of 2, rows 1 and 3 dead): NaN outputs
    and nxt -1 in those rows only, the other rows as the plain step gives
    them; and a tie in the logits (two equal head columns with the largest
    bias) resolved to the lower index."""
    import chip_smoke

    cfg = CFG.replace(dtype=dtype)
    stacked = dict(_ragged_bundle(np_params, cfg, dev, bundle))
    R, T, V = 16, 150, cfg.vocab_size
    prev, positions, caches = _ragged_inputs(dev, cfg, R, seed=11)
    w_head, b_head = stacked["w_head"].clone(), stacked["b_head"].clone()
    w_head[:, 7] = w_head[:, 3]
    b_head[0, 3] = b_head[0, 7] = 50.0
    stacked["w_head"], stacked["b_head"] = w_head, b_head
    tol = STEP_TOL["bfloat16" if bundle == "int8" else dtype]
    attr = "int8_launches" if bundle == "int8" else "launches"
    pos = positions[3].clone()
    bad_pos, bad_prev = pos.clone(), prev.clone()
    bad_pos[1] = T        # past the cache
    bad_prev[3] = V       # past the vocabulary
    dead = torch.zeros(R, dtype=torch.bool, device=dev)
    dead[1] = dead[3] = True
    geo = fs.cluster_geometry("ragged_step", cfg, R, T, cfg.encoder_len,
                              getattr(torch, dtype), bundle == "int8", V)
    assert geo["rows"] >= 2
    assert chip_smoke.mixed_groups(dead.tolist(), geo["rows"])
    for logits in (True, False):
        got = _launched(fs.fused_ragged_step,
                        lambda: fs.fused_ragged_step(
                            stacked, cfg, bad_prev, bad_pos, *caches,
                            return_logits=logits), attr)
        want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                          return_logits=logits)
        torch.cuda.synchronize()
        outs = got
        if not logits:
            assert got[0][dead].tolist() == [-1, -1]
            assert got[0][~dead].tolist() == [3] * (R - 2)  # lower index
            outs, want = got[1:], want[1:]
        for g, w in zip(outs, want):
            rows = dead if g.dim() < 3 else (slice(None), dead)
            live = ~dead if g.dim() < 3 else (slice(None), ~dead)
            assert torch.isnan(g[rows].float()).all()
            _close(g[live], w[live], tol)


def test_ragged_step_geometry(dev):
    """B7's launch shape at the beam's 50 rows: groups of at most 16 rows
    on 8-block clusters, every group's rows counted once."""
    for dtype, quantized in ((torch.bfloat16, False), (torch.bfloat16, True),
                             (torch.float32, False)):
        geo = fs.cluster_geometry("ragged_step", CFG, 50, 150,
                                  CFG.encoder_len, dtype, quantized,
                                  CFG.vocab_size)
        assert geo["blocks"] == 8 and 1 <= geo["rows"] <= 16
        assert geo["clusters"] == -(-50 // geo["rows"])
        assert geo["active_clusters"] >= 1 and geo["stages"] >= 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", [1, 50])
def test_beam_cache_gather(dev, dtype, R):
    L, T, D = 8, 150, 256
    sk, sv = (_randn(dev, dtype, L, R, T, D, seed=i) for i in range(2))
    gen = torch.Generator(device=dev).manual_seed(6)
    src = torch.randint(0, R, (R,), generator=gen, device=dev,
                        dtype=torch.int32)
    for t_ext in (37, 150):
        got = _launched(br.beam_cache_gather,
                        lambda: br.beam_cache_gather(sk, sv, src, t_ext))
        want = br.beam_cache_gather_plain(sk, sv, src, t_ext)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        out = (torch.zeros_like(sk), torch.zeros_like(sv))
        br.beam_cache_gather(sk, sv, src, t_ext, out=out)
        torch.cuda.synchronize()
        for o, w in zip(out, want):
            assert torch.equal(o[:, :, :t_ext], w)
            assert not o[:, :, t_ext:].any()


# Multi-query self-attention (nhead_kv=1): B1's and B7's MQA kernels (one
# KV head of Dh = 32 lanes, w_qkv of D + 2 Dh = 320 columns), the beam
# cache reorder at those lanes and the dequant matmul at the narrow qkv
# widths (MQA 320, GQA-2 384)
MQA = CFG.replace(nhead_kv=1)
MQA_BATCHES = [1, 16, 40]
MQA_POSITIONS = (0, 74, 149)


@pytest.fixture(scope="module")
def mqa_params():
    return convert.random_params(MQA, seed=0)


def _mqa_step_inputs(dev, dtype, B):
    L, T, L_enc = 8, 150, MQA.encoder_len
    sk, sv = (_randn(dev, dtype, L, B, T, MQA.kv_dim, seed=i)
              for i in range(2))
    ck, cv = (_randn(dev, dtype, L, B, L_enc, MQA.d_model, seed=2 + i)
              for i in range(2))
    return _randn(dev, dtype, B, MQA.d_model, seed=4), (sk, sv, ck, cv)


@pytest.mark.parametrize("bundle", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("B", MQA_BATCHES)
def test_fused_decoder_step_mqa(dev, mqa_params, bundle, B):
    """B1's MQA entries (bf16, float32 and int8 bundles) at the first, a
    middle and the last slot: x_out and the fresh K/V rows of one KV head
    within the step tolerance of the plain step (int8: bf16's)."""
    dtype = "bfloat16" if bundle == "int8" else bundle
    cfg = MQA.replace(dtype=dtype)
    stacked = fs.build_stacked(mqa_params["decoder"], cfg, dev)
    attr = "mqa_launches"
    if bundle == "int8":
        stacked, attr = fs.quantize_stacked(stacked), "mqa_int8_launches"
    x, caches = _mqa_step_inputs(dev, dtype, B)
    for pos in MQA_POSITIONS:
        got = _launched(fs.fused_decoder_layers_step_v2,
                        lambda: fs.fused_decoder_layers_step_v2(
                            stacked, cfg, x, *caches, pos), attr)
        want = fs.fused_decoder_layers_step_v2_plain(stacked, cfg, x,
                                                     *caches, pos)
        assert tuple(got[1].shape) == (8, B, cfg.kv_dim)
        for g, w in zip(got, want):
            _close(g, w, STEP_TOL[dtype])


@pytest.mark.parametrize("bundle", ["bfloat16", "int8"])
@pytest.mark.parametrize("R", [16, 50])
def test_ragged_step_mqa(dev, mqa_params, bundle, R):
    """B7's MQA entries (bf16 and int8 bundles) at the greedy bucket's and
    the beam's rows, each row at its own slot (all at the first, all at
    the last, a random vector, 0 and T - 1 alternating): both head modes
    within the bf16 step tolerance, the argmax equal wherever the plain
    logits' top two lie further apart than twice the largest logits
    error."""
    cfg = MQA.replace(dtype="bfloat16")
    stacked = fs.build_stacked_full(mqa_params["decoder"], cfg, dev)
    attr = "mqa_launches"
    if bundle == "int8":
        stacked, attr = fs.quantize_stacked(stacked), "mqa_int8_launches"
    L, T, L_enc = 8, 150, cfg.encoder_len
    sk, sv = (_randn(dev, "bfloat16", L, R, T, cfg.kv_dim, seed=R + i)
              for i in range(2))
    ck, cv = (_randn(dev, "bfloat16", L, R, L_enc, cfg.d_model,
                     seed=R + 2 + i) for i in range(2))
    gen = torch.Generator(device=dev).manual_seed(R)
    prev = torch.randint(0, cfg.vocab_size, (R,), generator=gen, device=dev,
                         dtype=torch.int32)
    i32 = torch.int32
    positions = (torch.zeros(R, dtype=i32, device=dev),
                 torch.full((R,), T - 1, dtype=i32, device=dev),
                 torch.randint(0, T, (R,), generator=gen, device=dev,
                               dtype=i32),
                 torch.arange(R, device=dev, dtype=i32) % 2 * (T - 1))
    caches = (sk, sv, ck, cv)
    for pos in positions:
        got = _launched(fs.fused_ragged_step,
                        lambda: fs.fused_ragged_step(
                            stacked, cfg, prev, pos, *caches,
                            return_logits=True), attr)
        want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                          return_logits=True)
        assert tuple(got[1].shape) == (L, R, cfg.kv_dim)
        for g, w in zip(got, want):
            _close(g, w, STEP_TOL["bfloat16"])
        logits_err = (got[0] - want[0]).abs().max()
        top2 = want[0].topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 2 * logits_err
        nxt = _launched(fs.fused_ragged_step,
                        lambda: fs.fused_ragged_step(
                            stacked, cfg, prev, pos, *caches), attr)
        want_nxt = fs.fused_ragged_step_plain(stacked, cfg, prev, pos,
                                              *caches)
        assert torch.equal(nxt[0][clear], want_nxt[0][clear])
        for g, w in zip(nxt[1:], want_nxt[1:]):
            _close(g, w, STEP_TOL["bfloat16"])


def test_mqa_geometry_and_refusals(dev, mqa_params):
    """The MQA kernels' launch shapes (B1 at 16 rows, B7 at 50) match the
    MHA kernels' (the same shared memory a block); GQA-2 is refused by B1
    and B7 (ValueError, no launch counted), by B11 (NotImplementedError),
    and by every geometry entry; B10 and B12 refuse MQA."""
    for kernel, rows, V in (("fused_step", 16, 0),
                            ("ragged_step", 50, CFG.vocab_size)):
        for quantized in (False, True):
            args = (rows, 150, CFG.encoder_len, torch.bfloat16, quantized, V)
            assert (fs.cluster_geometry(kernel, MQA, *args)
                    == fs.cluster_geometry(kernel, CFG, *args))
    gqa = CFG.replace(nhead_kv=2, dtype="bfloat16", num_decoder_layers=1)
    for kernel in fs.CLUSTER_KERNELS:
        with pytest.raises(ValueError, match="does not take"):
            fs.cluster_geometry(kernel, gqa, 16, 150, CFG.encoder_len,
                                torch.bfloat16, False, CFG.vocab_size)
    for kernel in ("whole_step", "whole_decode"):
        with pytest.raises(ValueError, match="does not take"):
            fs.cluster_geometry(kernel, MQA, 16, 150, CFG.encoder_len,
                                torch.bfloat16, False, CFG.vocab_size)
    stacked = fs.build_stacked_full(
        convert.random_params(gqa, seed=1)["decoder"], gqa, dev)
    bf16 = torch.bfloat16
    L, B, T, L_enc = 1, 2, 8, 4
    sk = torch.zeros(L, B, T, gqa.kv_dim, dtype=bf16, device=dev)
    ck = torch.zeros(L, B, L_enc, gqa.d_model, dtype=bf16, device=dev)
    x = torch.zeros(B, gqa.d_model, dtype=bf16, device=dev)
    rows = torch.zeros(B, dtype=torch.int32, device=dev)
    counters = [(w, a) for w in (fs.fused_decoder_layers_step_v2,
                                 fs.fused_ragged_step)
                for a in ("launches", "int8_launches", "mqa_launches",
                          "mqa_int8_launches")]
    before = [getattr(w, a) for w, a in counters]
    with pytest.raises(ValueError, match="does not take"):
        fs.fused_decoder_layers_step_v2(stacked, gqa, x, sk, sk, ck, ck, 3)
    with pytest.raises(ValueError, match="does not take"):
        fs.fused_ragged_step(stacked, gqa, rows, rows + 3, sk, sk, ck, ck)
    with pytest.raises(NotImplementedError, match="MHA only"):
        fs.fused_decoder_layers_step(stacked, gqa, x, sk, sk.clone(), ck, ck,
                                     3)
    assert [getattr(w, a) for w, a in counters] == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_beam_cache_gather_mqa(dev, dtype):
    """B8 over MQA self caches: 32 lanes a row (a 64-byte bf16 row, four
    16-byte vectors), the beam's 50 rows, the whole cache and a prefix."""
    L, R, T = 8, 50, 150
    sk, sv = (_randn(dev, dtype, L, R, T, MQA.kv_dim, seed=20 + i)
              for i in range(2))
    gen = torch.Generator(device=dev).manual_seed(7)
    src = torch.randint(0, R, (R,), generator=gen, device=dev,
                        dtype=torch.int32)
    for t_ext in (1, 37, 150):
        got = _launched(br.beam_cache_gather,
                        lambda: br.beam_cache_gather(sk, sv, src, t_ext))
        want = br.beam_cache_gather_plain(sk, sv, src, t_ext)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nhead_kv", [1, 2])
def test_dequant_matmul_grouped_qkv(dev, dtype, nhead_kv):
    """B9 on the default int8 route's self-attention projection under MQA
    (N = 320) and GQA-2 (N = 384), at one row, the greedy bucket and the
    beam's rows: one launch of all D + 2 kvd columns."""
    cfg = CFG.replace(nhead_kv=nhead_kv, dtype=dtype)
    dec = convert.to_torch(
        {"decoder": quant.quantize_decoder_params(
            convert.random_params(cfg, seed=2)["decoder"])}, cfg,
        dev)["decoder"]
    sa = dec["layers"][0]["self_attn"]
    assert sa["w_qkv_q"].shape[1] == cfg.d_model + 2 * cfg.kv_dim
    for M in (1, 16, 50):
        x = _randn(dev, dtype, M, cfg.d_model, seed=M)
        got = _launched(quant.dequant_matmul,
                        lambda: quant.dequant_matmul(x, sa["w_qkv_q"],
                                                     sa["w_qkv_scale"]))
        _close(got, quant.dequant_matmul_plain(x, sa["w_qkv_q"],
                                               sa["w_qkv_scale"]),
               TOL[dtype])


# B7's segment-ring entries (continuous batching's fused segments) and its
# run rows (n_chunks): the continuous decoder's ring of max_segment_steps
# rows at the pool of 32 slots plus scratch (48 rows, three 16-row chunks)
RING_S = 64


def _ring_inputs(dev, cfg, R, seed):
    """Caches, cross K/V, a ring of random rows, prev; positions over the
    cache and segment starts 0, pos and pos - (S - 1) in turn (rows with
    start 0 at a slot below S)."""
    L, T, L_enc = 8, 150, cfg.encoder_len
    sk, sv = (_randn(dev, cfg.dtype, L, R, T, cfg.kv_dim, seed=seed + i)
              for i in range(2))
    ck, cv = (_randn(dev, cfg.dtype, L, R, L_enc, cfg.d_model,
                     seed=seed + 2 + i) for i in range(2))
    rk, rv = (_randn(dev, cfg.dtype, L, R, RING_S, cfg.kv_dim,
                     seed=seed + 4 + i) for i in range(2))
    gen = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    prev = torch.randint(0, cfg.vocab_size, (R,), generator=gen, device=dev,
                         dtype=i32)
    pos = torch.randint(0, T, (R,), generator=gen, device=dev, dtype=i32)
    kind = torch.arange(R, device=dev) % 3
    pos = torch.where(kind == 0, pos % RING_S, pos)
    seg = torch.where(kind == 0, 0, torch.where(kind == 1, pos,
                                                pos - (RING_S - 1)))
    seg = seg.clamp(min=0).to(i32)
    return prev, pos, seg, (sk, sv, ck, cv), (rk, rv)


def _ring_cfg(np_params, mqa_params, dev, bundle, kv):
    """(cfg, stacked, launch count attribute) of a bundle and head mode."""
    mqa = kv == "mqa"
    dtype = "bfloat16" if bundle == "int8" else bundle
    cfg = (MQA if mqa else CFG).replace(dtype=dtype)
    params = mqa_params if mqa else np_params
    stacked = _ragged_bundle(params, cfg, dev,
                             "int8" if bundle == "int8" else "float")
    attr = ("ring_" + ("mqa_" if mqa else "")
            + ("int8_launches" if bundle == "int8" else "launches"))
    return cfg, stacked, attr


@pytest.mark.parametrize("bundle", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("kv", ["mha", "mqa"])
@pytest.mark.parametrize("R", [16, 48])
def test_ragged_step_ring(dev, np_params, mqa_params, bundle, kv, R):
    """B7's ring entries against the plain ring step: the logits (and the
    argmax head's logp) and the fresh rows within the step tolerance (int8:
    bf16's), the argmax equal in float32 and, under int8, wherever the
    plain logits' top two lie further apart than twice the largest logits
    error."""
    cfg, stacked, attr = _ring_cfg(np_params, mqa_params, dev, bundle, kv)
    prev, pos, seg, caches, (rk, rv) = _ring_inputs(dev, cfg, R, seed=R)
    ring = {"seg_start": seg, "ring_k": rk, "ring_v": rv}
    tol = STEP_TOL["bfloat16" if bundle == "int8" else cfg.dtype]
    got = _launched(fs.fused_ragged_step,
                    lambda: fs.fused_ragged_step(stacked, cfg, prev, pos,
                                                 *caches, return_logits=True,
                                                 **ring), attr)
    want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                      return_logits=True, **ring)
    for g, w in zip(got, want):
        _close(g, w, tol)
    logits_err = (got[0] - want[0]).abs().max()
    top2 = want[0].topk(2, dim=-1).values
    clear = top2[:, 0] - top2[:, 1] > 2 * logits_err
    nxt = _launched(fs.fused_ragged_step,
                    lambda: fs.fused_ragged_step(stacked, cfg, prev, pos,
                                                 *caches, **ring), attr)
    want_nxt = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                          **ring)
    if bundle == "float32":
        assert torch.equal(nxt[0], want_nxt[0])
    else:
        assert torch.equal(nxt[0][clear], want_nxt[0][clear])
    for g, w in zip(nxt[1:], want_nxt[1:]):
        _close(g, w, tol)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 2, 3])
def test_ragged_step_n_chunks(dev, np_params, ring, n_chunks):
    """The first n_chunks 16-row chunks of a 48-row pool (bf16, with and
    without the ring): those rows as the plain step gives them, the
    launch planned for them (cluster_geometry at those rows)."""
    cfg = CFG.replace(dtype="bfloat16")
    stacked = _ragged_bundle(np_params, cfg, dev, "float")
    R, run = 48, 16 * n_chunks
    prev, pos, seg, caches, (rk, rv) = _ring_inputs(dev, cfg, R, seed=5)
    kw = ({"seg_start": seg, "ring_k": rk, "ring_v": rv} if ring else {})
    got = _launched(fs.fused_ragged_step,
                    lambda: fs.fused_ragged_step(stacked, cfg, prev, pos,
                                                 *caches, n_chunks=n_chunks,
                                                 return_logits=True, **kw),
                    "ring_launches" if ring else "launches")
    want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                      n_chunks=n_chunks, return_logits=True,
                                      **kw)
    _close(got[0][:run], want[0][:run], STEP_TOL["bfloat16"])
    for g, w in zip(got[1:], want[1:]):
        _close(g[:, :run], w[:, :run], STEP_TOL["bfloat16"])
    geo = fs.cluster_geometry("ragged_step", cfg, run, 150, cfg.encoder_len,
                              torch.bfloat16, False, cfg.vocab_size)
    assert geo["clusters"] == -(-run // geo["rows"])


@pytest.mark.parametrize("bundle", ["float32", "int8"])
def test_ragged_step_ring_dead_row(dev, np_params, bundle):
    """Rows whose segment start lies past their slot (row 1) or S or more
    slots before it (row 3) beside good ones in their groups: NaN outputs
    and nxt -1 in those rows only, the others as the plain step gives
    them."""
    import chip_smoke

    cfg, stacked, attr = _ring_cfg(np_params, None, dev, bundle, "mha")
    R = 16
    prev, pos, seg, caches, (rk, rv) = _ring_inputs(dev, cfg, R, seed=13)
    pos[1], pos[3] = 40, 120
    seg[1], seg[3] = 41, 120 - RING_S
    good = seg.clone()
    good[1], good[3] = 40, 120
    dead = torch.zeros(R, dtype=torch.bool, device=dev)
    dead[1] = dead[3] = True
    geo = fs.cluster_geometry("ragged_step", cfg, R, 150, cfg.encoder_len,
                              getattr(torch, cfg.dtype), bundle == "int8",
                              cfg.vocab_size)
    assert chip_smoke.mixed_groups(dead.tolist(), geo["rows"])
    tol = STEP_TOL["bfloat16" if bundle == "int8" else cfg.dtype]
    for logits in (True, False):
        got = _launched(fs.fused_ragged_step,
                        lambda: fs.fused_ragged_step(
                            stacked, cfg, prev, pos, *caches, seg_start=seg,
                            ring_k=rk, ring_v=rv, return_logits=logits),
                        attr)
        want = fs.fused_ragged_step_plain(
            stacked, cfg, prev, pos, *caches, seg_start=good, ring_k=rk,
            ring_v=rv, return_logits=logits)
        torch.cuda.synchronize()
        outs = got
        if not logits:
            assert got[0][dead].tolist() == [-1, -1]
            assert (got[0][~dead] >= 0).all()
            outs, want = got[1:], want[1:]
        for g, w in zip(outs, want):
            rows = dead if g.dim() < 3 else (slice(None), dead)
            live = ~dead if g.dim() < 3 else (slice(None), ~dead)
            assert torch.isnan(g[rows].float()).all()
            _close(g[live], w[live], tol)


# The ResNet encoders' memory: W / 32 = 10 columns at 96x320 (the Swin
# trunk's 30), the cross K/V length of every decoder kernel on their
# served routes: each cluster plan sizes its cross items and TMA boxes
# from it. The decoder is the same (np_params' decoder tree).
RESNET = CFG.replace(encoder="resnet18")


@pytest.mark.parametrize("bundle", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("B", [1, 5, 16, 64])
def test_decoder_steps_at_resnet_memory(dev, np_params, bundle, B):
    """B1 (float and int8 bundles) and B11 (float) at L_enc 10 against
    their plain versions at every slot of STEP_POSITIONS: outputs within
    the step tolerance (int8: bf16's); B11's other slots unchanged."""
    dtype = "float32" if bundle == "float32" else "bfloat16"
    cfg = RESNET.replace(dtype=dtype)
    assert cfg.encoder_len == 10
    stacked = fs.build_stacked(np_params["decoder"], cfg, dev)
    if bundle == "int8":
        stacked = fs.quantize_stacked(stacked)
    attr = "int8_launches" if bundle == "int8" else "launches"
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    sk, sv = (_randn(dev, dtype, L, B, T, D, seed=i) for i in range(2))
    ck, cv = (_randn(dev, dtype, L, B, L_enc, D, seed=2 + i)
              for i in range(2))
    x = _randn(dev, dtype, B, D, seed=4)
    tol = STEP_TOL[dtype]
    for pos in STEP_POSITIONS:
        got = _launched(fs.fused_decoder_layers_step_v2,
                        lambda: fs.fused_decoder_layers_step_v2(
                            stacked, cfg, x, sk, sv, ck, cv, pos), attr)
        want = fs.fused_decoder_layers_step_v2_plain(stacked, cfg, x, sk, sv,
                                                     ck, cv, pos)
        for g, w in zip(got, want):
            _close(g, w, tol)
        if bundle == "int8":
            continue
        got_k, got_v = sk.clone(), sv.clone()
        want_k, want_v = sk.clone(), sv.clone()
        got = _launched(fs.fused_decoder_layers_step,
                        lambda: fs.fused_decoder_layers_step(
                            stacked, cfg, x, got_k, got_v, ck, cv, pos))
        want = fs.fused_decoder_layers_step_plain(stacked, cfg, x, want_k,
                                                  want_v, ck, cv, pos)
        _close(got[0], want[0], tol)
        other = torch.arange(T, device=dev) != pos
        for g, w, old in ((got_k, want_k, sk), (got_v, want_v, sv)):
            _close(g[:, :, pos], w[:, :, pos], tol)
            assert torch.equal(g[:, :, other], old[:, :, other])


@pytest.mark.parametrize("bundle", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("R", [1, 16, 50])
def test_ragged_step_at_resnet_memory(dev, np_params, bundle, R):
    """B7 at L_enc 10, both head modes, at the positions of
    ``_ragged_inputs``: logits and fresh rows within the step tolerance
    (int8: bf16's); the argmax equal in float32 and, in bf16 and int8,
    wherever the plain logits' top two lie further apart than twice the
    largest logits error."""
    dtype = "float32" if bundle == "float32" else "bfloat16"
    cfg = RESNET.replace(dtype=dtype)
    stacked = _ragged_bundle(np_params, cfg, dev,
                             "int8" if bundle == "int8" else "float")
    attr = "int8_launches" if bundle == "int8" else "launches"
    tol = STEP_TOL[dtype]
    prev, positions, caches = _ragged_inputs(dev, cfg, R, seed=R + 3)
    for pos in positions:
        got = _launched(fs.fused_ragged_step,
                        lambda: fs.fused_ragged_step(
                            stacked, cfg, prev, pos, *caches,
                            return_logits=True), attr)
        want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                          return_logits=True)
        for g, w in zip(got, want):
            _close(g, w, tol)
        top2 = want[0].topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 2 * (got[0] - want[0]).abs().max()
        nxt = _launched(fs.fused_ragged_step,
                        lambda: fs.fused_ragged_step(
                            stacked, cfg, prev, pos, *caches), attr)
        want_nxt = fs.fused_ragged_step_plain(stacked, cfg, prev, pos,
                                              *caches)
        if bundle == "float32":
            assert torch.equal(nxt[0], want_nxt[0])
        else:
            assert torch.equal(nxt[0][clear], want_nxt[0][clear])
        for g, w in zip(nxt[1:], want_nxt[1:]):
            _close(g, w, tol)


@pytest.mark.parametrize("bundle", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("R", [16, 48])
def test_ragged_step_ring_at_resnet_memory(dev, np_params, bundle, R):
    """B7's ring entries at L_enc 10 (continuous batching's 10-column
    cross slots), held as ``test_ragged_step_ring`` holds them."""
    dtype = "float32" if bundle == "float32" else "bfloat16"
    cfg = RESNET.replace(dtype=dtype)
    stacked = _ragged_bundle(np_params, cfg, dev,
                             "int8" if bundle == "int8" else "float")
    attr = "ring_int8_launches" if bundle == "int8" else "ring_launches"
    prev, pos, seg, caches, (rk, rv) = _ring_inputs(dev, cfg, R, seed=R + 1)
    ring = {"seg_start": seg, "ring_k": rk, "ring_v": rv}
    tol = STEP_TOL[dtype]
    got = _launched(fs.fused_ragged_step,
                    lambda: fs.fused_ragged_step(stacked, cfg, prev, pos,
                                                 *caches, return_logits=True,
                                                 **ring), attr)
    want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                      return_logits=True, **ring)
    for g, w in zip(got, want):
        _close(g, w, tol)
    top2 = want[0].topk(2, dim=-1).values
    clear = top2[:, 0] - top2[:, 1] > 2 * (got[0] - want[0]).abs().max()
    nxt = _launched(fs.fused_ragged_step,
                    lambda: fs.fused_ragged_step(stacked, cfg, prev, pos,
                                                 *caches, **ring), attr)
    want_nxt = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, *caches,
                                          **ring)
    if bundle == "float32":
        assert torch.equal(nxt[0], want_nxt[0])
    else:
        assert torch.equal(nxt[0][clear], want_nxt[0][clear])
    for g, w in zip(nxt[1:], want_nxt[1:]):
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("B", [1, 16, 50])
def test_whole_step_at_resnet_memory(dev, np_params, dtype, time_major, B):
    """B10 at L_enc 10 in both layouts, held as ``test_whole_step``: nxt
    equal in float32 (in bf16 except at near-ties), logp and the fresh
    rows within the step tolerance."""
    cfg = RESNET.replace(dtype=dtype)
    stacked = fs.build_stacked_full(np_params["decoder"], cfg, dev)
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    shape = (L, T, B, D) if time_major else (L, B, T, D)
    sk, sv = (_randn(dev, dtype, *shape, seed=i) for i in range(2))
    ck, cv = (_randn(dev, dtype, L, B, L_enc, D, seed=2 + i)
              for i in range(2))
    gen = torch.Generator(device=dev).manual_seed(8)
    prev = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    for pos in (0, 74, 149):
        got_k, got_v = sk.clone(), sv.clone()
        want_k, want_v = sk.clone(), sv.clone()
        got = _launched(fs.fused_whole_step,
                        lambda: fs.fused_whole_step(
                            stacked, cfg, prev, got_k, got_v, ck, cv, pos,
                            time_major=time_major))
        want = fs.fused_whole_step_plain(stacked, cfg, prev, want_k, want_v,
                                         ck, cv, pos, time_major=time_major)
        cache_k = want_k.transpose(1, 2) if time_major else want_k
        cache_v = want_v.transpose(1, 2) if time_major else want_v
        logits = fs.fused_ragged_step_plain(
            stacked, cfg, prev, torch.full((B,), pos, dtype=torch.int32,
                                           device=dev),
            cache_k, cache_v, ck, cv, return_logits=True)[0]
        torch.cuda.synchronize()
        if dtype == "float32":
            assert torch.equal(got[0], want[0])
        else:
            _hold_picks(got[0], want[0], logits, STEP_TOL[dtype][0])
        _close(got[1], want[1], STEP_TOL[dtype])
        if time_major:
            for g, w in ((got_k, want_k), (got_v, want_v)):
                _close(g[:, pos], w[:, pos], STEP_TOL[dtype])
        else:
            for g, w in zip(got[2:], want[2:]):
                _close(g, w, STEP_TOL[dtype])


@pytest.mark.parametrize("bundle", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("B", [1, 16])
def test_whole_decode_at_resnet_memory(dev, np_params, bundle, B):
    """B12 over 150 steps from random 10-column memory, held as
    ``test_whole_decode``: float32 tokens and counts equal, log-prob sums
    within 1e-2; bf16 and int8 by ``_hold_decode``."""
    dtype = "float32" if bundle == "float32" else "bfloat16"
    cfg = RESNET.replace(dtype=dtype)
    params = convert.to_torch(np_params, cfg, dev)
    resident = wd.build_resident(params["decoder"], cfg, bundle == "int8")
    memory = _randn(dev, dtype, B, cfg.encoder_len, cfg.d_model, seed=19)
    attr = "int8_launches" if bundle == "int8" else "launches"
    got = _launched(wd.fused_whole_decode,
                    lambda: wd.fused_whole_decode(resident, cfg, memory),
                    attr)
    want, logits = wd.fused_whole_decode_plain(resident, cfg, memory,
                                               return_logits=True)
    torch.cuda.synchronize()
    if bundle == "float32":
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.token_count, want.token_count)
        torch.testing.assert_close(got.logprob_sum, want.logprob_sum,
                                   atol=1e-2, rtol=0)
    else:
        _hold_decode(got, want, logits, STEP_TOL["bfloat16"][0])


# -- device admission's pull (csrc/admission_pull.cu) ------------------------


def _pull_setup(dev, dtype, constrained, S=33, P=64, seed=40):
    """Phase 6's pool at the serving config's cross K/V: pools, caches and
    a small state of random values."""
    from handwritten_math_ocr_api_torch.decode.constrain import STACK_DEPTH
    from handwritten_math_ocr_api_torch.ops import admission as adm

    L, H, Dh, T = 8, CFG.nhead, CFG.head_dim, CFG.max_seq_len
    row = (H, CFG.encoder_len, Dh)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ints(hi, *shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    pool = tuple(_randn(dev, dtype, P, L, *row, seed=seed + i)
                 for i in range(2))
    cross = tuple(_randn(dev, dtype, L, S, *row, seed=seed + 2 + i)
                  for i in range(2))
    state = adm.PullState(
        prev=ints(138, S), pos=ints(T, S), active=ints(2, S).bool(),
        finished=ints(2, S).bool(), tokens=ints(138, S, T),
        lp_sum=torch.randn((S,), generator=gen, device=dev),
        count=ints(T, S),
        con=((ints(9, S, STACK_DEPTH), ints(STACK_DEPTH, S), ints(3, S),
              ints(2, S).bool(), ints(2, S).bool())
             if constrained else None),
        occupant=ints(5, S, dtype=torch.int64))
    return pool, cross, state


def _pull_copy(cross, state):
    from handwritten_math_ocr_api_torch.ops import admission as adm

    return (tuple(t.clone() for t in cross),
            adm.PullState(*(t.clone() for t in state[:7]),
                          None if state.con is None
                          else tuple(t.clone() for t in state.con),
                          state.occupant.clone()))


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_admission_pull_matches_plain(dev, dtype, constrained):
    """Six entries (the second cancelled, one out of the pool's range) and
    eight pulls: the kernel's cross K/V, state, pushdown rows, occupants,
    cursor and records equal the plain install's exactly, one entry a
    pull, the cancelled and the out-of-range entries skipped."""
    from handwritten_math_ocr_api_torch.ops import admission as adm

    pool, cross, state = _pull_setup(dev, dtype, constrained)
    plan = [(5, 7), (11, 7), (63, 32), (0, 0), (64, 3), (2, 31)]
    runs = []
    for pull in (adm.admission_pull, adm.admission_pull_plain):
        mb = adm.Mailbox(64, dev)
        for p, slot in plan:
            mb.publish(mb.reserve(), p, slot)
        mb.cancel(2)
        c, st = _pull_copy(cross, state)
        before = adm.admission_pull.launches
        for step in range(8):
            pull(mb, *pool, *c, st, seg=3, step=step)
        torch.cuda.synchronize()
        counted = adm.admission_pull.launches - before
        runs.append((mb, c, st, counted))
    (mk, ck, sk, nk), (mp, cp, sp, np_) = runs
    assert (nk, np_) == (8, 0)
    for a, b in zip(ck, cp):
        assert torch.equal(a, b)
    for a, b in zip(sk[:7], sp[:7]):
        assert torch.equal(a, b)
    if constrained:
        for a, b in zip(sk.con, sp.con):
            assert torch.equal(a, b)
    assert torch.equal(sk.occupant, sp.occupant)
    assert torch.equal(mk.cursor, mp.cursor) and int(mk.cursor) == 6
    np.testing.assert_array_equal(mk.entries[:6], mp.entries[:6])
    assert [mk.taken(s) for s in range(1, 7)] == [
        (3, 0), None, (3, 1), (3, 2), None, (3, 3)]
    assert mk.consumed(2) and mk.consumed(5)
    assert torch.equal(ck[0][:, 32], pool[0][63])
    assert bool(sk.active[32]) and int(sk.occupant[32]) == 3
    mk.close()
    mp.close()


def test_admission_pull_reads_a_late_publication(dev):
    """A pull queued behind 200 ms of work on the stream takes an entry the
    host publishes after the launch: the kernel reads the mapped mailbox
    when it runs."""
    from handwritten_math_ocr_api_torch.ops import admission as adm

    pool, cross, state = _pull_setup(dev, "bfloat16", False, seed=50)
    mb = adm.Mailbox(64, dev)
    c, st = _pull_copy(cross, state)
    torch.cuda.synchronize()
    torch.cuda._sleep(4 * 10 ** 8)
    adm.admission_pull(mb, *pool, *c, st, seg=1, step=0)
    mb.publish(mb.reserve(), 9, 4)   # after the launch was queued
    torch.cuda.synchronize()
    assert mb.taken(1) == (1, 0)
    assert torch.equal(c[1][:, 4], pool[1][9])
    assert int(st.pos[4]) == 0 and int(st.prev[4]) == 1
    mb.close()


def test_device_admission_decoder_on_card(dev):
    """``ContinuousDecoder(admission="device")`` on the card (a small Swin
    config, float32): its results equal host admission's with batch-1
    encodes, one pull launched a scheduled step, and its staging on the
    side stream published by its thread."""
    from handwritten_math_ocr_api_torch.core.config import SwinConfig
    from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
    from handwritten_math_ocr_api_torch.decode import continuous as cont
    from handwritten_math_ocr_api_torch.ops import admission as adm

    cfg = ModelConfig(
        d_model=32, nhead=4, dim_feedforward=64, dropout=0.0,
        num_decoder_layers=2, max_seq_len=12, vocab_size=20,
        dtype="float32", swin=SwinConfig(embed_dim=8, depths=(1, 1),
                                         num_heads=(2, 2), window_size=4,
                                         stochastic_depth=0.0))
    params = convert.random_params(cfg, seed=3)
    params["decoder"]["fc_out"]["b"][EOS_ID] += 3.0
    vocab = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
             **{f"t{i}": i for i in range(4, 20)}}
    images = np.random.default_rng(4).integers(
        0, 256, (7, cfg.img_h, cfg.img_w, 1), dtype=np.uint8)
    out = {}
    for admission in ("host", "device"):
        dec = cont.ContinuousDecoder(params, cfg, Tokenizer(vocab),
                                     num_slots=3, segment_steps=4,
                                     encode_buckets=(1,),
                                     admission=admission, device=dev)
        before = adm.admission_pull.launches
        out[admission] = dec.run_all(list(images))
        pulls = adm.admission_pull.launches - before
        assert pulls == (dec.steps_scheduled if admission == "device"
                         else 0)
        dec.close()
    assert [r[0] for r in out["device"]] == [r[0] for r in out["host"]]
    for (_, a), (_, b) in zip(out["device"], out["host"]):
        assert abs(a - b) < 1e-4


# host threads launching at once: a server's executor threads (beam,
# sampled and streamed requests) beside the batcher's and the continuous
# scheduler's; each thread its own row count, so that the launches differ
# in cluster shape and tensor maps
THREAD_ROWS = (1, 3, 5, 16)
THREAD_LAUNCHES = 20


def test_concurrent_launches(dev, np_params):
    """4 threads x 20 launches each of B1, B7 and B4, started together (the
    launch caches of ``csrc/common.cuh`` and ``decoder_cluster.cuh`` cold
    for their tensors): every output equal, bit for bit, to the same launch
    made alone afterwards, and every launch counted."""
    import threading

    cfg = CFG.replace(dtype="bfloat16")
    dec = np_params["decoder"]
    step_bundle = fs.build_stacked(dec, cfg, dev)
    ragged_bundle = fs.build_stacked_full(dec, cfg, dev)
    params = convert.to_torch(np_params, cfg, dev)
    block = sb.with_float32_biases(
        np_params["encoder"], params["encoder"])["stages"][0]["blocks"][1]
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    inputs = []
    for t, B in enumerate(THREAD_ROWS):
        s = 10 * t
        step = (_randn(dev, "bfloat16", B, D, seed=s),
                *(_randn(dev, "bfloat16", L, B, T, D, seed=s + 1 + i)
                  for i in range(2)),
                *(_randn(dev, "bfloat16", L, B, L_enc, D, seed=s + 3 + i)
                  for i in range(2)))
        prev, positions, caches = _ragged_inputs(dev, cfg, B, seed=s + 5)
        image = _randn(dev, "bfloat16", B, 24, 80, 96, seed=s + 6)
        inputs.append((step, prev, positions[2], caches, image))

    def launches(t, i):
        step, prev, pos, caches, image = inputs[t]
        return (fs.fused_decoder_layers_step_v2(step_bundle, cfg, *step,
                                                (7 * i + t) % T),
                fs.fused_ragged_step(ragged_bundle, cfg, prev, pos, *caches,
                                     return_logits=True),
                (sb.fused_swin_block(block, image, 7, 3 * (i % 2), 3),))

    wrappers = (fs.fused_decoder_layers_step_v2, fs.fused_ragged_step,
                sb.fused_swin_block)
    before = [w.launches for w in wrappers]
    start = threading.Barrier(len(THREAD_ROWS))
    together = [None] * len(THREAD_ROWS)
    errors = []

    def worker(t):
        try:
            start.wait()
            together[t] = [launches(t, i) for i in range(THREAD_LAUNCHES)]
            torch.cuda.synchronize()
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(len(THREAD_ROWS))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    n = len(THREAD_ROWS) * THREAD_LAUNCHES
    assert [w.launches for w in wrappers] == [b + n for b in before]
    for t in range(len(THREAD_ROWS)):
        for i in range(THREAD_LAUNCHES):
            alone = launches(t, i)
            torch.cuda.synchronize()
            for got_k, want_k in zip(together[t][i], alone):
                for g, w in zip(got_k, want_k):
                    assert torch.equal(g, w), (THREAD_ROWS[t], i)
