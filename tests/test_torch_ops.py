"""The port's small kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, and the
JAX kernel runs in Pallas interpret mode, as ``tests/test_ops.py`` runs it.
Inputs are made with numpy from a seed and fed to both in float32. The
tolerances cover float32 summation order only: the two sides compute the
same float32 arithmetic in different orders (1e-5 relative for sums of a
few dozen terms, 1e-4 where a LayerNorm and a 4C-term product stack up).
The CUDA kernels themselves are held against these plain versions on the
card, by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.ops.cache_attention import (
    cache_append_attention as j_cache_attention,
)
from handwritten_math_ocr_api_tpu.ops.decode_attention import (
    decode_attention as j_decode_attention,
)
from handwritten_math_ocr_api_tpu.ops.patch_merging import (
    fused_patch_merging as j_patch_merging,
)
from handwritten_math_ocr_api_tpu.ops.window_attention import (
    fused_window_attention as j_fused_window_attention,
    window_attention_core as j_window_attention_core,
)

from handwritten_math_ocr_api_torch.ops import _build
from handwritten_math_ocr_api_torch.ops import cache_attention as ca
from handwritten_math_ocr_api_torch.ops import patch_merging as pm
from handwritten_math_ocr_api_torch.ops import window_attention as wa

import torch_threads  # noqa: F401  (one CPU thread: see the module)

ATOL, RTOL = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("B,nW,nh,N,dh", [(2, 3, 2, 49, 8), (1, 2, 4, 16, 32)])
def test_window_attention_core_matches_pallas(B, nW, nh, N, dh):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, nW, nh, N, dh)).astype(np.float32)
               for _ in range(3))
    mask = rng.standard_normal((nW, nh, N, N)).astype(np.float32)
    mask[..., ::3] = -100.0  # shift-mask fill
    want = j_window_attention_core(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(mask), nh,
                                   interpret=True)
    before = wa.window_attention_core.launches
    got = wa.window_attention_core(_t(q), _t(k), _t(v), _t(mask))
    assert wa.window_attention_core.launches == before  # CPU: no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(
        got.numpy(), wa.window_attention_core_plain(
            _t(q), _t(k), _t(v), _t(mask)).numpy())


@pytest.mark.parametrize("mask_windows", [1, 6])
def test_fused_window_attention_matches_jax(mask_windows):
    """With the qkv/output projections around the core; a mask shared by
    all windows (unshifted block) or one per window (shifted)."""
    rng = np.random.default_rng(1)
    B, nW, N, C, nh = 2, 6, 49, 16, 2
    p = {"w_qkv": rng.standard_normal((C, 3 * C)) * 0.2,
         "b_qkv": rng.standard_normal(3 * C) * 0.1,
         "w_out": rng.standard_normal((C, C)) * 0.2,
         "b_out": rng.standard_normal(C) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    windows = rng.standard_normal((B * nW, N, C)).astype(np.float32)
    mask = rng.standard_normal((mask_windows, nh, N, N)).astype(np.float32)
    want = j_fused_window_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(windows), nh,
        jnp.asarray(mask), nW, interpret=True)
    got = wa.fused_window_attention({k: _t(v) for k, v in p.items()},
                                    _t(windows), nh, _t(mask), nW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)


def test_window_attention_core_broadcast_mask_matches_pallas():
    """A (1, nh, N, N) mask, as an unshifted block passes it, gives what the
    TPU kernel gives on the mask repeated over the windows."""
    rng = np.random.default_rng(2)
    B, nW, nh, N, dh = 2, 3, 2, 49, 16
    q, k, v = (rng.standard_normal((B, nW, nh, N, dh)).astype(np.float32)
               for _ in range(3))
    mask = rng.standard_normal((1, nh, N, N)).astype(np.float32)
    want = j_window_attention_core(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v),
                                   jnp.asarray(np.repeat(mask, nW, axis=0)),
                                   nh, interpret=True)
    got = wa.window_attention_core(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype,N,dh,mask_windows,ok", [
    (torch.bfloat16, 49, 32, 3, True),     # Swin-T, shifted
    (torch.bfloat16, 49, 32, 1, True),     # Swin-T, unshifted
    (torch.bfloat16, 64, 128, 3, True),
    (torch.bfloat16, 65, 32, 3, False),    # more than 64 tokens
    (torch.bfloat16, 49, 24, 3, False),    # dh not a multiple of 16
    (torch.bfloat16, 49, 144, 3, False),   # dh above 128
    (torch.float32, 81, 24, 3, True),      # the CUDA-core kernel
    (torch.float32, 49, 32, 2, False),     # mask of 2 windows, not 3 or 1
    (torch.float16, 49, 32, 3, False),
])
def test_window_attention_kernel_shapes(dtype, N, dh, mask_windows, ok):
    """The shapes the kernels refuse raise ValueError before a launch."""
    q = torch.zeros(1, 3, 2, N, dh, dtype=dtype)
    mask = torch.zeros(mask_windows, 2, N, N)
    if ok:
        wa.check_kernel_shape(q, mask)
    else:
        with pytest.raises(ValueError):
            wa.check_kernel_shape(q, mask)


@pytest.mark.parametrize("dtype,Dh,pos,ok", [
    (torch.bfloat16, 32, 149, True),       # the served shape
    (torch.bfloat16, 64, 0, True),
    (torch.float32, 128, 149, True),       # 512-byte rows
    (torch.bfloat16, 4, 0, False),         # 8-byte rows
    (torch.bfloat16, 24, 0, False),        # 48 bytes: 3 vectors
    (torch.float32, 12, 0, False),
    (torch.bfloat16, 256, 0, False),       # head dim above 128
    (torch.bfloat16, 32, 150, False),      # pos outside the cache
    (torch.float16, 32, 0, False),
])
def test_cache_attention_kernel_shapes(dtype, Dh, pos, ok):
    """The shapes the kernel refuses raise ValueError before a launch."""
    q = torch.zeros(2, 8, 1, Dh, dtype=dtype)
    k_cache = torch.zeros(2, 8, 150, Dh, dtype=dtype)
    if ok:
        ca.check_kernel_shape(q, k_cache, pos)
    else:
        with pytest.raises(ValueError):
            ca.check_kernel_shape(q, k_cache, pos)


@pytest.mark.parametrize("B,H,W,C", [(2, 6, 10, 8), (1, 4, 4, 24)])
def test_patch_merging_matches_pallas(B, H, W, C):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    p = {"norm": {"scale": rng.standard_normal(4 * C).astype(np.float32),
                  "bias": rng.standard_normal(4 * C).astype(np.float32)},
         "reduction": {"w": rng.standard_normal(
             (4 * C, 2 * C)).astype(np.float32)}}
    jp = {"norm": {k: jnp.asarray(v) for k, v in p["norm"].items()},
          "reduction": {"w": jnp.asarray(p["reduction"]["w"])}}
    want = j_patch_merging(jp, jnp.asarray(x), interpret=True)
    tp = {"norm": {k: _t(v) for k, v in p["norm"].items()},
          "reduction": {"w": _t(p["reduction"]["w"])}}
    before = pm.fused_patch_merging.launches
    got = pm.fused_patch_merging(tp, _t(x))
    assert pm.fused_patch_merging.launches == before
    assert got.shape == (B, H // 2, W // 2, 2 * C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("B", [1, 16])
def test_patch_merging_tile_plan(B):
    """The bf16 kernel's tiles at Swin-T's three merges on a 132-SM card:
    32 tokens by the widest of 192 and 128 columns whose grid fills 7/8 of
    the SMs, else 64; the shared memory within a block's limit. A C that is
    not a multiple of 16 is refused."""
    want = {16: (192, 192, 64), 1: (64, 64, 64)}[B]
    for (C, H, W), cols in zip(((96, 24, 80), (192, 12, 40), (384, 6, 20)),
                               want):
        M = B * (H // 2) * (W // 2)
        assert pm.tile_plan(M, C, 132) == (
            cols, 2 * (32 * (4 * C + 8) + 3 * 32 * (cols + 8)))
        assert pm.tile_plan(M, C, 132)[1] <= pm.SMEM_LIMIT
    assert pm.tile_plan(15, 48, 132)[0] == 32  # 2C = 96: 64 does not divide
    with pytest.raises(ValueError, match="multiple of 16"):
        pm.tile_plan(15, 12, 132)


def test_patch_merging_rejects_odd_sizes():
    p = {"norm": {"scale": torch.ones(8), "bias": torch.zeros(8)},
         "reduction": {"w": torch.ones(8, 4)}}
    with pytest.raises(ValueError, match="even"):
        pm.fused_patch_merging(p, torch.zeros(1, 3, 4, 2))


@pytest.mark.parametrize("pos", [0, 4, 8])
def test_cache_append_attention_matches_pallas(pos):
    rng = np.random.default_rng(3)
    B, H, T, Dh = 2, 3, 9, 32
    k_cache = rng.standard_normal((B, H, T, Dh)).astype(np.float32)
    v_cache = rng.standard_normal((B, H, T, Dh)).astype(np.float32)
    q, kn, vn = (rng.standard_normal((B, H, 1, Dh)).astype(np.float32)
                 for _ in range(3))
    want, k_want, v_want = j_cache_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.int32(pos),
        interpret=True)
    kc, vc = _t(k_cache.copy()), _t(v_cache.copy())
    before = ca.cache_append_attention.launches
    got = ca.cache_append_attention(_t(q), _t(kn), _t(vn), kc, vc, pos)
    assert ca.cache_append_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    # the port updates the caches in place
    np.testing.assert_array_equal(kc.numpy(), np.asarray(k_want))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(v_want))


@pytest.mark.parametrize("pos", [0, 4, 8])
def test_decode_attention_matches_pallas(pos):
    """The attention without the append: caches read, never written."""
    rng = np.random.default_rng(4)
    B, H, T, Dh = 2, 3, 9, 32
    k_cache, v_cache = (rng.standard_normal((B, H, T, Dh)).astype(np.float32)
                        for _ in range(2))
    q = rng.standard_normal((B, H, 1, Dh)).astype(np.float32)
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(k_cache),
                              jnp.asarray(v_cache), jnp.int32(pos),
                              interpret=True)
    kc, vc = _t(k_cache.copy()), _t(v_cache.copy())
    before = ca.decode_attention.launches
    got = ca.decode_attention(_t(q), kc, vc, pos)
    assert ca.decode_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(kc.numpy(), k_cache)
    np.testing.assert_array_equal(vc.numpy(), v_cache)


def test_kernel_build_and_launch_checks(monkeypatch, tmp_path):
    """Without nvcc the build raises a clear error; a non-zero launch code
    raises; a CPU tensor is refused before its pointer reaches a kernel."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "window_attention_bf16")
    _build.check(0, "window_attention_bf16")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        _build.require(torch.zeros(2), "q")
    assert sorted(_build.SIGNATURES) == sorted(
        [f"{k}_{t}" for k in ("window_attention", "patch_merging",
                              "cache_append_attention", "decode_attention",
                              "fused_decoder_step", "ragged_step",
                              "swin_block", "dequant_matmul",
                              "fused_decoder_step_i8", "ragged_step_i8",
                              "ragged_ring", "ragged_ring_i8",
                              "layers_step_in_place",
                              "whole_step_time_major", "whole_step_rows",
                              "whole_decode", "whole_decode_i8")
         for t in ("bf16", "f32")]
        + ["beam_cache_gather", "cluster_geometry",
           "swin_block_active_clusters", "admission_mailbox_alloc",
           "admission_mailbox_free", "admission_pull"])
