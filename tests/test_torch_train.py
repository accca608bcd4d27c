"""The port's training step and its parts against the JAX package's, on the
CPU in float32: the loss and token accuracy, ``init_model``, one train step
(loss, accuracy, gradient norm and every gradient, with and without
``remat``), the optimizer chain against optax fed the same gradients, the
augmentation warp, dropout and stochastic depth, the plateau scheduler,
the eval step on the shipped weights against the JAX fixture, and the
decode kernels' positional clamp.

The model is small (32x80 images, embed 16, two Swin stages, d_model 32,
2 decoder layers); inputs are made with numpy from a seed. Tolerances: the
loss and accuracy 1e-6 relative; a train step's loss, accuracy and
gradient norm 1e-5 relative and every gradient 1e-4 relative / 1e-6
absolute (float32 sums in other orders through 4 Swin blocks and the
decoder); the optimizer's params, moments and EMA 1e-6 relative to the
element or, where steps nearly cancel, to its leaf's largest (the clip's
global norm is a float32 sum in another order, 1e-7 off, which moves every
clipped gradient by that share of its size); the warp exactly.

Why the optimizer is fed its gradients: Adam's first update is lr
sign(g), so a near-zero gradient whose sign differs between the frameworks
would read as a 2 lr gap in the params after a train step.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.data import augment as jaug
from handwritten_math_ocr_api_tpu.decode.beam import beam_decode as j_beam
from handwritten_math_ocr_api_tpu.decode.greedy import (
    greedy_decode as j_greedy,
)
from handwritten_math_ocr_api_tpu.models import decoder as jdec
from handwritten_math_ocr_api_tpu.models import model as jmodel
from handwritten_math_ocr_api_tpu.train import losses as jlosses
from handwritten_math_ocr_api_tpu.train import optim as joptim
from handwritten_math_ocr_api_tpu.train import step as jstep

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer, load_vocab
from handwritten_math_ocr_api_torch.data import augment as taug
from handwritten_math_ocr_api_torch.data.dataset import get_test_loader
from handwritten_math_ocr_api_torch.decode import fused as tfused
from handwritten_math_ocr_api_torch.models import layers as tlayers
from handwritten_math_ocr_api_torch.models import model as tmodel
from handwritten_math_ocr_api_torch.models import swin as tswin
from handwritten_math_ocr_api_torch.ops import fused_step as tstep_ops
from handwritten_math_ocr_api_torch.train import losses as tlosses
from handwritten_math_ocr_api_torch.train import optim as toptim
from handwritten_math_ocr_api_torch.train import step as tstep
from handwritten_math_ocr_api_torch.train.checkpoint import (
    load_params_for_serving,
)
from handwritten_math_ocr_api_torch.utils import tree

import torch_threads  # noqa: F401  (one CPU thread: see the module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "serving_model_r4")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_r4_train.json")

CFG = tcfg.ModelConfig(
    img_h=32, img_w=80, d_model=32, nhead=4, dim_feedforward=64,
    dropout=0.0, num_decoder_layers=2, max_seq_len=12, vocab_size=20,
    swin=tcfg.SwinConfig(embed_dim=16, depths=(2, 2), num_heads=(1, 2),
                         window_size=4, stochastic_depth=0.0),
    dtype="float32", memory_norm=True)


def jax_config(cfg):
    d = dataclasses.asdict(cfg)
    d["swin"] = jcfg.SwinConfig(**d["swin"])
    d["resnet"] = jcfg.ResNetConfig(**d["resnet"])
    return jcfg.ModelConfig(**d)


JCFG = jax_config(CFG)


def jax_train_config(tc):
    return jcfg.TrainConfig(**dataclasses.asdict(tc))


def by_path(jtree):
    """{"a/b/0": numpy leaf} of a JAX tree (whose leaves sort by key)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jtree)}


def batch(b=3, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (b, CFG.img_h, CFG.img_w, 1)).astype(
        np.float32)
    caps = rng.integers(3, CFG.vocab_size, (b, CFG.max_seq_len)).astype(
        np.int32)
    caps[:, 0] = 1
    caps[0, 8:] = 0
    caps[1, 5], caps[1, 6:] = 2, 0
    return images, caps


@pytest.fixture(scope="module")
def jparams():
    """A JAX ``init_model`` tree with nonzero biases and norms (numpy)."""
    params, _ = jax.jit(lambda k: jmodel.init_model(k, JCFG))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if name.endswith("['b']") or "b_" in name or "bias" in name:
            return 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("pads", ["some", "none", "all"])
def test_loss_and_accuracy_match_jax(eps, pads):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 7, 11)).astype(np.float32)
    targets = rng.integers(1, 11, (4, 7)).astype(np.int32)
    if pads == "some":
        targets[0, 5:] = 0
        targets[2, 3:] = 0
    elif pads == "all":
        targets[:] = 0
    want_loss = jlosses.smoothed_cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets), 0, eps)
    want_acc = jlosses.token_accuracy(jnp.asarray(logits),
                                      jnp.asarray(targets), 0)
    got_loss = tlosses.smoothed_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets), 0, eps)
    got_acc = tlosses.token_accuracy(torch.from_numpy(logits),
                                     torch.from_numpy(targets), 0)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(float(got_acc), float(want_acc), rtol=1e-6,
                               atol=0)


# ------------------------------------------------------------ init_model


def spread(std, a):
    """Five standard errors of a sample standard deviation of ``a.size``
    draws of standard deviation ``std``."""
    return 5 * std / np.sqrt(2 * a.size)


def test_init_model_tree_matches_jax():
    """The same paths, shapes and dtypes as JAX's ``init_model``; zero
    biases, unit LayerNorm scales, xavier-uniform matrices within their
    limit with the uniform's spread, N(0, 0.02^2) tables, the patch
    embedding's N(0, 1 / (ps^2 Cin))."""
    cfg = CFG.replace(swin=dataclasses.replace(CFG.swin, embed_dim=32))
    want, _ = jax.eval_shape(lambda k: jmodel.init_model(k, jax_config(cfg)),
                             jax.random.PRNGKey(0))
    got, state = tmodel.init_model(cfg, seed=0, device="cpu")
    assert state == {}
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in
            zip(by_path(jax.tree_util.tree_map(
                lambda s: np.zeros((), np.float32), want)),
                jax.tree_util.tree_leaves(want))}
    got_paths = ["/".join(p) for p in tree.paths(got)]
    assert sorted(got_paths) == sorted(want)
    for p, t in zip(got_paths, tree.leaves(got)):
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
            want[p], p
        a = t.numpy()
        name = p.split("/")[-1]
        if name in ("b", "bias", "b_qkv", "b_out"):
            assert not a.any(), p
        elif name == "scale":
            assert (a == 1).all(), p
        elif name in ("table", "rel_bias_table"):
            assert abs(a.std() - 0.02) < spread(0.02, a), p
        elif p.endswith("patch_embed/conv/w"):
            std = 1 / np.sqrt(a.shape[0] * a.shape[1] * a.shape[2])
            assert abs(a.std() - std) < spread(std, a), p
        else:
            limit = np.sqrt(6.0 / (a.shape[0] + a.shape[-1]))
            assert np.abs(a).max() <= limit, p
            assert abs(a.std() - limit / np.sqrt(3)) < spread(
                limit / np.sqrt(3), a), p


# ------------------------------------------------------------ train step


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax(jparams, remat):
    """One train step on JAX's params (float images, dropout and stochastic
    depth 0): loss, accuracy and gradient norm within 1e-5 relative, every
    gradient within 1e-4 relative / 1e-6 absolute."""
    images, caps = batch()
    tc = tcfg.TrainConfig(remat=remat)
    jtc = jax_train_config(tc)
    jstate, jopt = jstep.create_train_state(jax.random.PRNGKey(0), JCFG, jtc)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          jparams),
                            opt_state=jopt.init(jparams))

    def loss_fn(p):
        logits, _ = jmodel.forward(p, {}, JCFG, jnp.asarray(images),
                                   jnp.asarray(caps), deterministic=False,
                                   rng=jax.random.PRNGKey(5), training=True,
                                   remat=remat)
        return jlosses.smoothed_cross_entropy(
            logits, jnp.asarray(caps)[:, 1:], 0, jtc.label_smoothing)

    want_grads = by_path(jax.jit(jax.grad(loss_fn))(jstate.params))
    _, want = jstep.make_train_step(JCFG, jtc, jopt)(
        jstate, jnp.asarray(images), jnp.asarray(caps),
        jax.random.PRNGKey(1))

    opt = toptim.make_optimizer(tc)
    state = tstep.state_from_params(convert.to_torch(jparams, CFG, "cpu"),
                                    opt, tc)
    leaves = tree.leaves(state.params)
    cap_t = torch.from_numpy(caps).long()
    logits = tmodel.forward(state.params, CFG, torch.from_numpy(images),
                            cap_t, generator=torch.Generator(), remat=remat,
                            kernels=False)
    grads = torch.autograd.grad(tlosses.smoothed_cross_entropy(
        logits, cap_t[:, 1:], 0, tc.label_smoothing), leaves)
    for p, g in zip(tree.paths(state.params), grads):
        np.testing.assert_allclose(g.numpy(), want_grads["/".join(p)],
                                   rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(p))
    _, got = tstep.make_train_step(CFG, tc, opt, device="cpu")(
        state, images, caps, 0)
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=0, err_msg=k)


def test_train_step_augments_uint8_and_repeats_its_draws(jparams):
    """uint8 images are augmented in the step: the loss differs from the
    unaugmented float images', and the same (seed, step) repeats it."""
    images, caps = batch()
    u8 = ((images + 1) * 127.5).round().astype(np.uint8)
    tc = tcfg.TrainConfig()
    cfg = CFG.replace(dropout=0.2, swin=dataclasses.replace(
        CFG.swin, stochastic_depth=0.2))
    losses = []
    for imgs in (u8, u8, u8 / np.float32(127.5) - 1):
        opt = toptim.make_optimizer(tc)
        state = tstep.state_from_params(
            convert.to_torch(jparams, CFG, "cpu"), opt, tc)
        _, m = tstep.make_train_step(cfg, tc, opt, device="cpu")(
            state, imgs, caps, 7)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]


# -------------------------------------------------------------- optimizer


SHAPES = {"encoder": {"a": (3, 4), "b": (5,)}, "projection": {"w": (4, 2)},
          "decoder": {"c": (2, 3), "d": (7,)}}


def _np_tree(rng, scale=1.0):
    return {k: {n: (scale * rng.standard_normal(s)).astype(np.float32)
                for n, s in sub.items()} for k, sub in SHAPES.items()}


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("enc_scale", [1.0, 0.5, 0.0])
def test_optimizer_matches_optax(clip, warmup, enc_scale):
    """Three steps on the same gradients (the second after
    ``set_learning_rate``): params, Adam's moments and the EMA within 1e-6
    relative of optax's chain and the JAX step's update code."""
    rng = np.random.default_rng(4)
    params = _np_tree(rng)
    grads = [_np_tree(rng, 2.0 if clip == "active" else 0.01)
             for _ in range(3)]
    tc = tcfg.TrainConfig(learning_rate=1e-2, warmup_steps=warmup,
                          ema_decay=0.9)
    jopt = joptim.make_optimizer(jax_train_config(tc))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jo = jopt.init(jp)
    je = jax.tree_util.tree_map(jnp.copy, jp)

    opt = toptim.make_optimizer(tc)
    state = tstep.state_from_params(
        tree.map_tree(lambda a: torch.from_numpy(a.copy()), params), opt,
        tc)
    for t, g in enumerate(grads):
        if t == 1:
            jo = joptim.set_learning_rate(jo, 3e-3)
            state = state.replace(opt_state=toptim.set_learning_rate(
                state.opt_state, 3e-3))
            assert toptim.get_learning_rate(state.opt_state) == \
                pytest.approx(joptim.get_learning_rate(jo), rel=1e-7)
        updates, jo = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jo, jp)
        if enc_scale != 1.0:
            updates = dict(updates)
            updates["encoder"] = jax.tree_util.tree_map(
                lambda u: u * enc_scale, updates["encoder"])
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        d = jnp.minimum(tc.ema_decay, (1.0 + t) / (10.0 + t))
        je = jax.tree_util.tree_map(lambda e, p: d * e + (1.0 - d) * p, je,
                                    jp)
        norm = tstep.apply_gradients(
            state, [torch.from_numpy(x.copy()) for x in tree.leaves(g)],
            opt, tc, enc_scale)
        np.testing.assert_allclose(
            float(norm), np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                                     for x in tree.leaves(g))), rtol=1e-6)
        state = state.replace(step=state.step + 1)
    adam = jo[1].inner_state[0]
    paths = ["/".join(p) for p in tree.paths(state.params)]
    for name, got, want in (
            ("params", tree.leaves(state.params), by_path(jp)),
            ("mu", state.opt_state["mu"], by_path(adam.mu)),
            ("nu", state.opt_state["nu"], by_path(adam.nu)),
            ("ema", tree.leaves(state.ema_params), by_path(je))):
        for p, x in zip(paths, got):
            w = want[p]
            np.testing.assert_allclose(x.detach().numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{name} {p}")
    assert int(state.opt_state["count"]) == int(adam.count) == 3


# ----------------------------------------------------------- augmentation


@pytest.mark.parametrize("params", [(0.0, 0.0, 1.0), (-2.0, -2.0, 0.95),
                                    (-2.0, 2.0, 1.05), (2.0, -2.0, 1.05),
                                    (2.0, 2.0, 0.95)],
                         ids=lambda p: f"{p[0]}deg_{p[1]}shear_{p[2]}scale")
def test_warp_equals_jax(params):
    """The explicit-parameter warp equals JAX's ``_warp_one`` exactly."""
    theta, shear, scale = params
    rng = np.random.default_rng(6)
    img = rng.uniform(-1, 1, (96, 320)).astype(np.float32)
    th = np.float32(theta * np.pi / 180)
    sh = np.float32(shear * np.pi / 180)
    want = np.asarray(jax.jit(lambda i, a, b, c: jaug._warp_one(
        i, a, b, c, -1.0))(img, th, sh, np.float32(scale)))
    got = taug.warp(torch.from_numpy(img[None]), torch.tensor([th]),
                    torch.tensor([sh]), torch.tensor([scale]))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_random_affine_draws_in_range_and_fill():
    """Draws from the generator stay within the configured ranges (the
    corners of a warped image of ones show the -1 fill at most within the
    warp's reach) and the same generator seed repeats them."""
    x = torch.ones((8, 96, 320, 1))
    a = taug.random_affine_batch(x, torch.Generator().manual_seed(3))
    b = taug.random_affine_batch(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) <= {-1.0, 1.0}
    # at 2 degrees and scale >= 0.95 the centre stays inside the image
    assert (a[:, 40:56, 140:180] == 1).all()


# ---------------------------------------------- dropout, stochastic depth


def test_dropout_keep_rate_and_scaling():
    x = torch.ones(200_000)
    y = tlayers.dropout(x, 0.2, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert tlayers.dropout(x, 0.2, None) is x
    assert tlayers.dropout(x, 0.0, torch.Generator()) is x


def test_stochastic_depth_rates_and_rows():
    """The rate rises linearly with the block index from 0; each draw
    keeps whole rows with probability 1 - rate; the block scales kept rows
    by 1 / keep and zeroes the others."""
    sc = tcfg.SwinConfig(depths=(2, 2, 6, 2), stochastic_depth=0.2)
    draws = tswin.stochastic_depth_masks(sc, 20_000,
                                         torch.Generator().manual_seed(0),
                                         "cpu")
    assert draws[0] is None and len(draws) == 12
    for i, (keep, m1, m2) in enumerate(draws[1:], start=1):
        assert keep == pytest.approx(1 - 0.2 * i / 11)
        assert m1.shape == (20_000, 1, 1, 1)
        for m in (m1, m2):
            assert abs(m.float().mean().item() - keep) < 0.015
    h = torch.ones(4, 3, 3, 2)
    mask = torch.tensor([True, False, True, False])[:, None, None, None]
    out = tswin._drop_path(h, 0.5, mask)
    assert torch.equal(out[0], torch.full((3, 3, 2), 2.0))
    assert not out[1].any()
    assert tswin.stochastic_depth_masks(sc, 4, None, "cpu") == [None] * 12


# ------------------------------------------------------ plateau scheduler


def test_plateau_matches_jax_scheduler():
    """JAX's test sequence (torch ReduceLROnPlateau semantics)."""
    ours = toptim.PlateauScheduler(factor=0.5, patience=3)
    theirs = joptim.PlateauScheduler(factor=0.5, patience=3)
    lr_o = lr_t = 1.0
    for m in [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.8, 0.9, 0.9, 0.9,
              0.9, 0.9]:
        lr_o, lr_t = ours.step(m, lr_o), theirs.step(m, lr_t)
        assert lr_o == lr_t
    assert ours.state_dict() == theirs.state_dict()
    again = toptim.PlateauScheduler.from_state_dict(ours.state_dict())
    assert again == ours


# ------------------------------------------- shipped weights, the fixture


def test_eval_loss_on_shipped_weights_matches_fixture():
    """The port's float32 eval step on the CPU over the first 4 test
    images equals the JAX package's (``quality_bar.py --train``) within
    1e-4 relative (a float32 Swin-T forward summed in other orders)."""
    with open(FIXTURE) as f:
        fixture = json.load(f)
    params, _, vocab, idx2char, cfg = load_params_for_serving(MODEL_DIR)
    cfg = cfg.replace(dtype="float32", dropout=0.0)
    tc = tcfg.TrainConfig(label_smoothing=fixture["label_smoothing"])
    opt = toptim.make_optimizer(tc)
    state = tstep.state_from_params(convert.to_torch(params, cfg, "cpu"),
                                    opt, tc)
    loader = get_test_loader(Tokenizer(vocab, idx2char), tcfg.DataConfig(
        data_root=os.path.join(REPO, "data_eval_hard"), batch_size=4), cfg)
    loader.dataset.rows = loader.dataset.rows[:4]
    b = next(iter(loader))
    loss, preds = tstep.make_eval_step(cfg, tc, device="cpu")(
        state, b["image"], b["caption"])
    assert preds.shape == (4, cfg.max_seq_len - 1)
    np.testing.assert_allclose(float(loss), fixture["first4_eval_loss"],
                               rtol=1e-4, atol=0)


# ------------------------------------------------- the positional clamp


@pytest.fixture(scope="module")
def short_table():
    """A decoder whose positional table (8 rows) is shorter than the
    decode (12 steps), EOS lowered so that no row ends inside the table."""
    cfg = tcfg.ModelConfig(d_model=32, nhead=4, dim_feedforward=64,
                           dropout=0.0, num_decoder_layers=2, max_seq_len=8,
                           vocab_size=20, dtype="float32")
    jc = jax_config(cfg)
    dec = jdec.init_decoder_params(jax.random.PRNGKey(3), jc)
    dec = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), dec)
    dec["fc_out"]["b"][2] -= 20.0
    memory = np.random.default_rng(5).standard_normal(
        (3, 6, 32)).astype(np.float32)
    return cfg, jc, dec, memory


@pytest.mark.parametrize("variant", ["v3", "v4", "v5"])
def test_fused_greedy_past_the_table_matches_jax(short_table, variant):
    """B10 ("v3", "v4") and B12 ("v5") plain versions over 12 steps with a
    table of 8 rows: JAX's greedy decode (its gather clamps the index)."""
    cfg, jc, dec, memory = short_table
    want = j_greedy(jax.tree_util.tree_map(jnp.asarray, dec), jc,
                    jnp.asarray(memory), max_len=12)
    tdec = convert.to_torch({"decoder": dec}, cfg, "cpu")["decoder"]
    stacked = tstep_ops.build_stacked_full(tdec, cfg)
    got = tfused.greedy_decode_fused(tdec, stacked, cfg,
                                     torch.from_numpy(memory), 12,
                                     variant=variant, kernels=False)
    assert (np.asarray(want.token_count) > 8).all()
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), rtol=1e-4)


def test_fused_beam_past_the_table_matches_jax(short_table):
    """B7's plain version in the fused beam over 12 steps with a table of
    8 rows: JAX's beam decode."""
    cfg, jc, dec, memory = short_table
    want = j_beam(jax.tree_util.tree_map(jnp.asarray, dec), jc,
                  jnp.asarray(memory), 3, 12)
    tdec = convert.to_torch({"decoder": dec}, cfg, "cpu")["decoder"]
    got = tfused.beam_decode_fused(tdec,
                                   tstep_ops.build_stacked_full(tdec, cfg),
                                   cfg, torch.from_numpy(memory), 3, 12,
                                   kernels=False)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
