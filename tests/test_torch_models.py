"""The port's layers, Swin encoder, ``encode`` and decoder against the JAX
package, at a small size and in float32.

The JAX side runs its Pallas route (``use_pallas=True``, the kernels in
interpret mode); the port runs the plain versions of its kernels, as it does
for CPU tensors. Both get the same weights: a JAX ``init_model`` tree moved
across with ``convert.to_torch``. Tolerances: 1e-4 relative / 1e-4 absolute
through the encoder, whose 5 blocks, 3 merges and LayerNorms chain float32
sums taken in different orders; 2e-5 absolute for single layers. The JAX
calls are jitted: one compile each is cheaper than op-by-op dispatch of the
interpreted kernels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.models import decoder as jdec
from handwritten_math_ocr_api_tpu.models import layers as jlayers
from handwritten_math_ocr_api_tpu.models import model as jmodel
from handwritten_math_ocr_api_tpu.models import swin as jswin

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.models import decoder as tdec
from handwritten_math_ocr_api_torch.models import layers as tlayers
from handwritten_math_ocr_api_torch.models import model as tmodel
from handwritten_math_ocr_api_torch.models import swin as tswin

# embed 24, depths (1,1,2,1), heads (1,2,2,4); 32x80 images give stage
# maps 8x20, 4x10, 2x5 (odd: padded before the last merge), 1x3 — shifted
# windows in stage 1, the shift clamped along the short side in stage 2
CFG = tcfg.ModelConfig(
    img_h=32, img_w=80, d_model=32, nhead=4, dim_feedforward=64,
    dropout=0.0, num_decoder_layers=2, max_seq_len=12, vocab_size=20,
    swin=tcfg.SwinConfig(embed_dim=24, depths=(1, 1, 2, 1),
                         num_heads=(1, 2, 2, 4), stochastic_depth=0.0),
    dtype="float32", memory_norm=True)


def jax_config(cfg):
    d = dataclasses.asdict(cfg)
    d["swin"] = jcfg.SwinConfig(**d["swin"])
    d["resnet"] = jcfg.ResNetConfig(**d["resnet"])
    return jcfg.ModelConfig(**d)


JCFG = jax_config(CFG)


@pytest.fixture(scope="module")
def weights():
    jparams, _ = jax.jit(lambda k: jmodel.init_model(k, JCFG))(
        jax.random.PRNGKey(0))
    # non-zero biases and LayerNorm affines, so every term is exercised
    rng = np.random.default_rng(7)

    def jitter(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']") or "b_" in name or "bias" in name:
            return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    np_tree = jax.tree_util.tree_map_with_path(jitter, jparams)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    return jparams, convert.to_torch(np_tree, CFG, "cpu")


def _images(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, CFG.img_h, CFG.img_w, 1)).astype(np.float32)


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p_ln = {"scale": rng.standard_normal(16).astype(np.float32),
            "bias": rng.standard_normal(16).astype(np.float32)}
    got = tlayers.layer_norm({k: torch.from_numpy(v) for k, v in p_ln.items()},
                             torch.from_numpy(x))
    want = jlayers.layer_norm({k: jnp.asarray(v) for k, v in p_ln.items()},
                              jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    p_mlp = {"fc1": {"w": rng.standard_normal((16, 32)).astype(np.float32),
                     "b": rng.standard_normal(32).astype(np.float32)},
             "fc2": {"w": rng.standard_normal((32, 16)).astype(np.float32),
                     "b": rng.standard_normal(16).astype(np.float32)}}
    tp = jax.tree_util.tree_map(torch.from_numpy, p_mlp)
    jp = jax.tree_util.tree_map(jnp.asarray, p_mlp)
    for t_act, j_act in ((tlayers.gelu_tanh, jax.nn.gelu),
                         (torch.relu, jax.nn.relu)):
        got = tlayers.mlp(tp, torch.from_numpy(x), activation=t_act)
        want = jlayers.mlp(jp, jnp.asarray(x), activation=j_act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-5)
    q, k, v = (rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.triu(np.full((3, 3), -np.inf, np.float32), 1)
    got = tlayers.attention(*map(torch.from_numpy, (q, k, v, mask)))
    want = jlayers.attention(*map(jnp.asarray, (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_array_equal(
        tlayers.merge_heads(tlayers.split_heads(torch.from_numpy(x), 4)),
        x)


def test_swin_index_and_mask_tables_match_jax():
    np.testing.assert_array_equal(tswin.relative_position_index(7),
                                  jswin.relative_position_index(7))
    for args in ((14, 28, 7, 3, 3), (7, 14, 7, 0, 3), (14, 14, 7, 0, 0)):
        want = jswin.shift_attention_mask(*args)
        got = tswin.shift_attention_mask(*args)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", [0, 3])
def test_window_attention_matches_jax(weights, shift):
    """Padding (8x20 -> 14x21), roll and mask around the kernel."""
    jparams, tparams = weights
    jp = jparams["encoder"]["stages"][0]["blocks"][0]["attn"]
    tp = tparams["encoder"]["stages"][0]["blocks"][0]["attn"]
    x = np.random.default_rng(2).standard_normal((2, 8, 20, 24)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jswin.window_attention(
        p, x, 7, shift, 1, use_pallas=True))(jp, jnp.asarray(x))
    got = tswin.window_attention(tp, torch.from_numpy(x), 7, shift, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-4)


def test_swin_apply_matches_jax(weights):
    jparams, tparams = weights
    x = _images()
    want = jax.jit(lambda p, x: jswin.swin_apply(
        p, x, JCFG.swin, use_pallas=True))(jparams["encoder"], jnp.asarray(x))
    got = tswin.swin_apply(tparams["encoder"], torch.from_numpy(x), CFG.swin)
    assert got.shape == (2, 3, CFG.swin.num_features)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_encode_matches_jax(weights):
    jparams, tparams = weights
    x = _images(3, seed=1)
    want, _ = jax.jit(lambda p, x: jmodel.encode(
        p, {}, JCFG, x, use_pallas=True))(jparams, jnp.asarray(x))
    got = tmodel.encode(tparams, CFG, torch.from_numpy(x))
    assert got.shape == want.shape == (3, 3, CFG.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    # the plain reference path is the same arithmetic on the CPU
    np.testing.assert_array_equal(
        got.numpy(), tmodel.encode(tparams, CFG, torch.from_numpy(x),
                                   kernels=False).numpy())


def test_decoder_step_matches_jax_pallas_route(weights):
    jparams, tparams = weights
    rng = np.random.default_rng(4)
    memory = rng.standard_normal((2, 3, CFG.d_model)).astype(np.float32)
    ids = rng.integers(0, CFG.vocab_size, (2, 6))
    jcache = jdec.init_cache(jparams["decoder"], JCFG, jnp.asarray(memory),
                             max_len=8)
    tcache = tdec.init_cache(tparams["decoder"], CFG,
                             torch.from_numpy(memory), max_len=8)
    step = jax.jit(lambda p, i, t, c: jdec.decoder_step(
        p, JCFG, i, t, c, use_pallas=True))
    for t in range(6):
        want, jcache = step(jparams["decoder"], jnp.asarray(ids[:, t]),
                            jnp.int32(t), jcache)
        got = tdec.decoder_step(tparams["decoder"], CFG,
                                torch.from_numpy(ids[:, t]), t, tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    for name in ("self_k_1", "self_v_1", "cross_k_0"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-4)


def test_decoder_forward_matches_jax(weights):
    jparams, tparams = weights
    rng = np.random.default_rng(5)
    memory = rng.standard_normal((2, 3, CFG.d_model)).astype(np.float32)
    ids = rng.integers(0, CFG.vocab_size, (2, 7))
    want = jdec.decoder_forward(jparams["decoder"], JCFG,
                                jnp.asarray(memory), jnp.asarray(ids))
    got = tdec.decoder_forward(tparams["decoder"], CFG,
                               torch.from_numpy(memory),
                               torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_cached_steps_match_full_prefix(weights):
    """decoder_step at position t == decoder_forward on the prefix [0..t]
    at its last position."""
    _, tparams = weights
    rng = np.random.default_rng(6)
    memory = torch.from_numpy(
        rng.standard_normal((3, 4, CFG.d_model)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, CFG.vocab_size, (3, 9)))
    full = tdec.decoder_forward(tparams["decoder"], CFG, memory, ids)
    cache = tdec.init_cache(tparams["decoder"], CFG, memory)
    for t in range(ids.shape[1]):
        step = tdec.decoder_step(tparams["decoder"], CFG, ids[:, t], t, cache)
        np.testing.assert_allclose(step.numpy(), full[:, t].numpy(),
                                   atol=2e-5, rtol=1e-5)
