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
beam cache reorder exactly (a copy).
"""

import pytest
import torch

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core.config import ModelConfig
from handwritten_math_ocr_api_torch.models import swin
from handwritten_math_ocr_api_torch.ops import beam_reorder as br
from handwritten_math_ocr_api_torch.ops import cache_attention as ca
from handwritten_math_ocr_api_torch.ops import fused_step as fs
from handwritten_math_ocr_api_torch.ops import patch_merging as pm
from handwritten_math_ocr_api_torch.ops import swin_block as sb
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


def _launched(wrapper, fn):
    before = wrapper.launches
    out = fn()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 16])
def test_window_attention(dev, np_params, dtype, B):
    params = convert.to_torch(np_params, CFG.replace(dtype=dtype), dev)
    p = params["encoder"]["stages"][0]["blocks"][1]["attn"]
    nW, nh, N, dh = 48, 3, 49, 32
    mask = swin.attention_mask(p, 7, nh, 28, 84, 3, 3)
    mask = mask.expand(nW, nh, N, N).contiguous()
    q, k, v = (_randn(dev, dtype, B, nW, nh, N, dh, seed=i)
               for i in range(3))
    got = _launched(wa.window_attention_core,
                    lambda: wa.window_attention_core(q, k, v, mask))
    _close(got, wa.window_attention_core_plain(q, k, v, mask), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 16])
def test_patch_merging(dev, np_params, dtype, B):
    params = convert.to_torch(np_params, CFG.replace(dtype=dtype), dev)
    p = params["encoder"]["merges"][0]
    x = _randn(dev, dtype, B, 24, 80, 96)
    got = _launched(pm.fused_patch_merging,
                    lambda: pm.fused_patch_merging(p, x))
    _close(got, pm.patch_merging_plain(p, x), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 16])
def test_cache_append_and_decode_attention(dev, dtype, B):
    H, T, Dh = 8, 150, 32
    k_cache, v_cache = (_randn(dev, dtype, B, H, T, Dh, seed=i)
                        for i in range(2))
    for pos in (0, 74, 149):
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 16])
def test_fused_decoder_step(dev, np_params, dtype, B):
    cfg = CFG.replace(dtype=dtype)
    stacked = fs.build_stacked(np_params["decoder"], cfg, dev)
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    sk, sv = (_randn(dev, dtype, L, B, T, D, seed=i) for i in range(2))
    ck, cv = (_randn(dev, dtype, L, B, L_enc, D, seed=2 + i)
              for i in range(2))
    x = _randn(dev, dtype, B, D, seed=4)
    for pos in (0, 149):
        got = _launched(fs.fused_decoder_layers_step_v2,
                        lambda: fs.fused_decoder_layers_step_v2(
                            stacked, cfg, x, sk, sv, ck, cv, pos))
        want = fs.fused_decoder_layers_step_v2_plain(stacked, cfg, x, sk, sv,
                                                     ck, cv, pos)
        for g, w in zip(got, want):
            _close(g, w, STEP_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_swin_block(dev, np_params, dtype, stage):
    """Batch 1 and 2, unshifted and shifted, with the engine's bundle
    (float32 biases)."""
    params = convert.to_torch(np_params, CFG.replace(dtype=dtype), dev)
    encoder = sb.with_float32_biases(np_params["encoder"], params["encoder"])
    p = encoder["stages"][stage]["blocks"][1]
    h, w, c = 24 >> stage, 80 >> stage, 96 << stage
    nh = CFG.swin.num_heads[stage]
    for B in (1, 2):
        x = _randn(dev, dtype, B, h, w, c, seed=B)
        for shift in (0, 3):
            got = _launched(sb.fused_swin_block,
                            lambda: sb.fused_swin_block(p, x, 7, shift, nh))
            _close(got, sb.fused_swin_block_plain(p, x, 7, shift, nh),
                   TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", [1, 50])
def test_ragged_step(dev, np_params, dtype, R):
    cfg = CFG.replace(dtype=dtype)
    stacked = fs.build_stacked_full(np_params["decoder"], cfg, dev)
    L, T, D, L_enc = 8, 150, 256, cfg.encoder_len
    sk, sv = (_randn(dev, dtype, L, R, T, D, seed=i) for i in range(2))
    ck, cv = (_randn(dev, dtype, L, R, L_enc, D, seed=2 + i)
              for i in range(2))
    gen = torch.Generator(device=dev).manual_seed(5)
    prev = torch.randint(0, cfg.vocab_size, (R,), generator=gen,
                         device=dev, dtype=torch.int32)
    for pos in (torch.full((R,), 0, dtype=torch.int32, device=dev),
                torch.full((R,), 149, dtype=torch.int32, device=dev),
                torch.randint(0, T, (R,), generator=gen, device=dev,
                              dtype=torch.int32)):
        for logits in (True, False):
            got = _launched(fs.fused_ragged_step,
                            lambda: fs.fused_ragged_step(
                                stacked, cfg, prev, pos, sk, sv, ck, cv,
                                return_logits=logits))
            want = fs.fused_ragged_step_plain(stacked, cfg, prev, pos, sk, sv,
                                              ck, cv, return_logits=logits)
            if not logits:
                if dtype == "float32":
                    assert torch.equal(got[0], want[0])
                got, want = got[1:], want[1:]
            for g, w in zip(got, want):
                _close(g, w, STEP_TOL[dtype])


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
