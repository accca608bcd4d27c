"""The ResNet encoders of the port (``resnet18``, ``res18trans``) against
the JAX package's, on the CPU in float32.

The memory length, the trees of ``init_model``, the trunk
(``resnet_apply``) in eval and training mode at blocks (1, 1, 1, 1) and
(2, 2, 2, 2), the height pool and projection, the transformer encoder,
``encode`` of both encoders, ``forward`` with and without ``remat`` (the
same new BatchNorm statistics), one train step against JAX's, the
encoder's update scale, a bit-equal resume with the model state and its
export, a checkpoint that JAX wrote, and ``--init-from``'s graft. Serving
is ``tests/test_torch_resnet_serve.py``.

The model is small: 32x64 images (2 memory columns), stage channels (8,
16, 32, 64), d_model 32, 4 heads, 2 decoder and 2 encoder layers, FFN 64,
T 12, vocab 20. The weights come from ``convert.random_params`` and the
statistics from ``convert.random_state`` (every bias, norm, mean and
variance away from 0 and 1); inputs are made with numpy from a seed.

Tolerances: features and memory within 1e-4 absolute and 1e-4 relative
(float32 convolutions summed in another order over up to 576 terms a
layer, eight or sixteen layers deep); new statistics within 1e-5
relative to the largest of their leaf (float32 means over N H W in
another order); a train step's loss and gradient norm within 1e-5
relative and its statistics within 1e-5 relative; a resume bit for
bit.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.models import model as jmodel
from handwritten_math_ocr_api_tpu.models import resnet as jres
from handwritten_math_ocr_api_tpu.train import checkpoint as jckpt
from handwritten_math_ocr_api_tpu.train import step as jstep

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.config import EOS_ID
from handwritten_math_ocr_api_torch.models import model as tmodel
from handwritten_math_ocr_api_torch.models import resnet as tres
from handwritten_math_ocr_api_torch.train import checkpoint as tckpt
from handwritten_math_ocr_api_torch.train import optim as toptim
from handwritten_math_ocr_api_torch.train import step as tstep
from handwritten_math_ocr_api_torch.utils import tree

FEAT_TOL = 1e-4
STATS_RTOL = 1e-5
STEP_RTOL = 1e-5
T = 12
VOCAB = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
         **{f"t{i}": i for i in range(4, 20)}}
# added to the end-of-sequence logit's bias, per encoder: the rows of
# _images end after different numbers of steps, some never
EOS_BOOST = {"resnet18": 1.7, "res18trans": 1.0}

CFG = tcfg.ModelConfig(
    img_h=32, img_w=64, d_model=32, nhead=4, dim_feedforward=64,
    dropout=0.0, num_decoder_layers=2, max_seq_len=T, vocab_size=20,
    encoder="resnet18", num_encoder_layers=2,
    resnet=tcfg.ResNetConfig(stage_channels=(8, 16, 32, 64),
                             stage_blocks=(2, 2, 2, 2)),
    dtype="float32")
ENCODERS = ("resnet18", "res18trans")


def jax_config(cfg):
    d = dataclasses.asdict(cfg)
    d["swin"] = jcfg.SwinConfig(**d["swin"])
    d["resnet"] = jcfg.ResNetConfig(**d["resnet"])
    return jcfg.ModelConfig(**d)


def _j(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def by_path(t):
    return {"/".join(p): np.asarray(x.detach() if torch.is_tensor(x) else x)
            for p, x in zip(tree.paths(t), tree.leaves(t))}


def assert_stats(got, want, rtol=STATS_RTOL):
    """Every leaf of two state trees, relative to the leaf's largest."""
    g, w = by_path(got), by_path(_np(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0,
                                   atol=rtol * np.abs(w[k]).max(),
                                   err_msg=k)


def _model(encoder="resnet18", seed=0, boost=False, **kw):
    """(cfg, numpy params, numpy state): seeded, perturbed."""
    cfg = CFG.replace(encoder=encoder, **kw)
    params = convert.random_params(cfg, seed)
    if boost:
        params["decoder"]["fc_out"]["b"][EOS_ID] += EOS_BOOST[encoder]
    return cfg, params, convert.random_state(cfg, seed)


def _images(n, seed, cfg=CFG):
    """Normal noise at a brightness and contrast of its own per image."""
    rng = np.random.default_rng(seed)
    offset = rng.uniform(-1, 1, (n, 1, 1, 1))
    scale = rng.uniform(0.2, 2.0, (n, 1, 1, 1))
    noise = rng.standard_normal((n, cfg.img_h, cfg.img_w, 1))
    return (offset + scale * noise).astype(np.float32)


# -- config, trees ------------------------------------------------------------


@pytest.mark.parametrize("encoder", ["swin_t", *ENCODERS])
@pytest.mark.parametrize("hw", [(96, 320), (32, 64)])
def test_encoder_len_matches_jax(encoder, hw):
    """The memory length of every encoder equals JAX's: 30 for Swin at
    96x320, W / 32 (10) for the ResNet encoders, whose length the port
    had taken from the Swin grid."""
    cfg = tcfg.ModelConfig(img_h=hw[0], img_w=hw[1], encoder=encoder)
    assert cfg.encoder_len == jax_config(cfg).encoder_len
    if hw == (96, 320):
        assert cfg.encoder_len == (30 if encoder == "swin_t" else 10)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_init_model_matches_jax_trees(encoder):
    """``init_model``'s params and state have JAX's paths, shapes and
    float32 dtype; BatchNorm scale 1, bias 0, mean 0, var 1 as JAX's; the
    convolutions Kaiming normal (std sqrt(2 / fan_in) within 10%); the
    random state perturbed away from 0 and 1."""
    cfg = CFG.replace(encoder=encoder)
    params, state = tmodel.init_model(cfg, 0, "cpu")
    jp, js = jax.eval_shape(lambda k: jmodel.init_model(k, jax_config(cfg)),
                            jax.random.PRNGKey(0))
    for got, want in ((params, jp), (state, js)):
        g = by_path(got)
        w = {"/".join(p): x for p, x in zip(tree.paths(want),
                                             tree.leaves(want))}
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == np.float32, k
            assert w[k].dtype == np.float32, k
    for k, v in by_path(state).items():
        assert np.all(v == (0.0 if k.endswith("mean") else 1.0)), k
    enc = by_path(params["encoder"])
    for k, v in enc.items():
        if k.endswith("scale"):
            assert np.all(v == 1.0), k
        elif k.endswith("bias"):
            assert np.all(v == 0.0), k
        elif v.size > 500:
            std = np.sqrt(2.0 / np.prod(v.shape[:3]))
            assert abs(v.std() / std - 1) < 0.1, k
    rs = by_path(convert.random_state(cfg, 3))
    assert all(np.all(v != 0) for k, v in rs.items() if k.endswith("mean"))
    assert all(np.all(v > 1) for k, v in rs.items() if k.endswith("var"))


# -- the trunk and the encoders -------------------------------------------------


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("blocks", [(1, 1, 1, 1), (2, 2, 2, 2)])
def test_resnet_apply_matches_jax(blocks, training):
    """The trunk's features (B, H/32, W/32, 64) within FEAT_TOL, and the
    new statistics within STATS_RTOL (eval mode: the state unchanged)."""
    rc = dataclasses.replace(CFG.resnet, stage_blocks=blocks)
    cfg, params, state = _model(resnet=rc)
    x = _images(3, 1)
    got, gs = tres.resnet_apply(convert.to_torch(params, cfg, "cpu")
                                ["encoder"],
                                convert.state_to_torch(state, "cpu")
                                ["resnet"], torch.from_numpy(x), cfg.resnet,
                                training=training)
    want, ws = jres.resnet_apply(_j(params["encoder"]), _j(state["resnet"]),
                                 jnp.asarray(x), jax_config(cfg).resnet,
                                 training=training)
    assert tuple(got.shape) == (3, 1, 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEAT_TOL,
                               rtol=FEAT_TOL)
    assert_stats(gs, ws)
    if not training:
        assert_stats(gs, state["resnet"], rtol=0)


def test_height_pool_project_and_trans_encoder_match_jax():
    """The height pool and projection of (3, 2, 5, 64) features, and the
    transformer encoder over its output, within FEAT_TOL."""
    cfg, params, _ = _model("res18trans")
    feats = np.random.default_rng(2).standard_normal(
        (3, 2, 5, 64)).astype(np.float32)
    tp = convert.to_torch(params, cfg, "cpu")
    got = tres.height_pool_project(tp["projection"], torch.from_numpy(feats))
    want = jres.height_pool_project(_j(params["projection"]),
                                    jnp.asarray(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEAT_TOL,
                               rtol=FEAT_TOL)
    got = tres.trans_encoder_apply(tp["trans_encoder"], got[:, :2], cfg)
    want = jres.trans_encoder_apply(_j(params["trans_encoder"]),
                                    want[:, :2], jax_config(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEAT_TOL,
                               rtol=FEAT_TOL)


@pytest.mark.parametrize("memory_norm", [False, True])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_encode_matches_jax(encoder, memory_norm):
    """``encode`` (eval) and ``encode_with_state(training=True)``: the
    memory within FEAT_TOL, the new statistics within STATS_RTOL."""
    cfg, params, state = _model(encoder, memory_norm=memory_norm)
    x = _images(2, 3)
    tp = convert.to_torch(params, cfg, "cpu")
    ts = convert.state_to_torch(state, "cpu")
    for training in (False, True):
        got, gs = tmodel.encode_with_state(tp, cfg, torch.from_numpy(x), ts,
                                           training=training)
        want, ws = jmodel.encode(_j(params), _j(state), jax_config(cfg),
                                 jnp.asarray(x), training=training)
        assert tuple(got.shape) == (2, cfg.encoder_len, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FEAT_TOL, rtol=FEAT_TOL)
        assert_stats(gs, ws)
    np.testing.assert_array_equal(
        tmodel.encode(tp, cfg, torch.from_numpy(x), model_state=ts,
                      use_pallas_block=True).numpy(),
        tmodel.encode(tp, cfg, torch.from_numpy(x), model_state=ts).numpy())
    with pytest.raises(ValueError, match="model state"):
        tmodel.encode(tp, cfg, torch.from_numpy(x))


@pytest.mark.parametrize("encoder", ENCODERS)
def test_forward_remat_keeps_the_forward_state(encoder):
    """A training forward with and without ``remat``: the same logits,
    gradients and new statistics, which are JAX's (within STATS_RTOL) and
    carry no gradient; the recompute does not move them again. res18trans
    with dropout 0.2 draws the same masks under both."""
    cfg, params, state = _model(encoder, dropout=0.2)
    x, caps = _images(2, 4), np.random.default_rng(4).integers(
        4, 20, (2, 6))
    out = []
    for remat in (False, True):
        tp = tree.map_tree(lambda a: a.requires_grad_(True),
                           convert.to_torch(params, cfg, "cpu"))
        ts = convert.state_to_torch(state, "cpu")
        logits, ns = tmodel.forward(
            tp, cfg, torch.from_numpy(x), torch.from_numpy(caps),
            generator=torch.Generator().manual_seed(3), remat=remat,
            kernels=False, model_state=ts, return_state=True)
        grads = torch.autograd.grad(logits.square().mean(), tree.leaves(tp))
        assert not any(t.requires_grad for t in tree.leaves(ns))
        assert_stats(ts, state, rtol=0)  # the input state is not updated
        out.append((logits.detach(), grads, ns))
    (l0, g0, s0), (l1, g1, s1) = out
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    assert_stats(s1, _np(s0), rtol=0)
    _, ws = jmodel.forward(_j(params), _j(state), jax_config(cfg),
                           jnp.asarray(x), jnp.asarray(caps),
                           deterministic=True, training=True)
    assert_stats(s0, ws)


# -- training -----------------------------------------------------------------


def _batch(cfg, b=3, seed=0):
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, cfg.vocab_size, (b, 8))
    caps[:, 0] = 1
    caps[0, 5:] = 0  # a padded caption
    return _images(b, seed, cfg), caps


@pytest.mark.parametrize("encoder", ENCODERS)
def test_train_step_matches_jax(encoder):
    """One train step (float images, dropout 0): loss and gradient norm
    within STEP_RTOL of JAX's, and the state's new statistics within
    STATS_RTOL of JAX's; the EMA covers the params only."""
    cfg, params, state = _model(encoder)
    images, caps = _batch(cfg)
    tc = tcfg.TrainConfig(ema_decay=0.9)
    jtc = jcfg.TrainConfig(**dataclasses.asdict(tc))
    jstate, jopt = jstep.create_train_state(jax.random.PRNGKey(0),
                                            jax_config(cfg), jtc)
    jstate = jstate.replace(params=_j(params), model_state=_j(state),
                            opt_state=jopt.init(_j(params)),
                            ema_params=_j(params))
    jnew, want = jstep.make_train_step(jax_config(cfg), jtc, jopt)(
        jstate, jnp.asarray(images), jnp.asarray(caps),
        jax.random.PRNGKey(1))

    opt = toptim.make_optimizer(tc)
    st = tstep.state_from_params(convert.to_torch(params, cfg, "cpu"), opt,
                                 tc, convert.state_to_torch(state, "cpu"))
    new, got = tstep.make_train_step(cfg, tc, opt, device="cpu")(
        st, images, caps, 0)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=STEP_RTOL, atol=0, err_msg=k)
    assert_stats(new.model_state, jnew.model_state)
    assert tree.structure(new.ema_params) == tree.structure(new.params)


def test_encoder_update_scale_acts_on_the_trunk():
    """``encoder_update_scale`` 0 (a frozen encoder, as
    ``freeze_encoder_epochs``) leaves the trunk's weights as they were
    while its statistics move and the projection and the transformer
    encoder train; 0.5 moves the trunk by half of 1.0's first step (Adam's
    first update is lr sign(g))."""
    cfg, params, state = _model("res18trans")
    images, caps = _batch(cfg)
    tc = tcfg.TrainConfig(learning_rate=1e-3)
    moved = {}
    for scale in (0.0, 0.5, 1.0):
        opt = toptim.make_optimizer(tc)
        st = tstep.state_from_params(convert.to_torch(params, cfg, "cpu"),
                                     opt, tc,
                                     convert.state_to_torch(state, "cpu"))
        new, _ = tstep.make_train_step(cfg, tc, opt, device="cpu",
                                       encoder_update_scale=scale)(
            st, images, caps, 0)
        got = by_path(new.params)
        want = by_path(params)
        moved[scale] = {k: np.abs(got[k] - want[k]).max() for k in want}
        assert not np.allclose(by_path(new.model_state)[
            "resnet/bn1/mean"], state["resnet"]["bn1"]["mean"])
    for k, v in moved[0.0].items():
        assert (v == 0.0) == k.startswith("encoder/"), k
    for k in moved[1.0]:
        if k.startswith("encoder/"):
            assert moved[0.5][k] == pytest.approx(moved[1.0][k] / 2,
                                                  rel=1e-3), k


def test_resume_with_model_state_is_bit_equal(tmp_path):
    """res18trans at dropout 0.1 on uint8 images (augmented in the step):
    four steps in one run, and two steps, a checkpoint, a fresh template
    and two more: the same losses, params and statistics bit for bit; the
    export of the checkpoint keeps the statistics."""
    cfg, _, _ = _model("res18trans", dropout=0.1)
    images, caps = _batch(cfg, 4, 9)
    u8 = ((images.clip(-1, 1) + 1) * 127.5).round().astype(np.uint8)
    tc = tcfg.TrainConfig(ema_decay=0.9)

    def fresh():
        state, opt = tstep.create_train_state(cfg, tc, seed=2, device="cpu")
        return state, tstep.make_train_step(cfg, tc, opt, device="cpu")

    state, step = fresh()
    straight = []
    for i in range(4):
        state, m = step(state, u8, caps, 0)
        straight.append(float(m["loss"]))
        if i == 1:
            tckpt.save_checkpoint(str(tmp_path), "ck", state, 1, 0.5)
    state2, step2 = fresh()
    state2, _ = tckpt.load_checkpoint(str(tmp_path), "ck", state2)
    assert state2.step == 2
    resumed = []
    for _ in range(2):
        state2, m = step2(state2, u8, caps, 0)
        resumed.append(float(m["loss"]))
    assert resumed == straight[2:]
    for a, b in ((state.params, state2.params),
                 (state.model_state, state2.model_state),
                 (state.ema_params, state2.ema_params)):
        for x, y in zip(tree.leaves(a), tree.leaves(b)):
            assert torch.equal(x, y)
    from handwritten_math_ocr_api_torch.cli import main
    from handwritten_math_ocr_api_torch.core.tokenizer import save_vocab

    save_vocab(VOCAB, str(tmp_path / "vocab.json"))

    overrides = json.dumps({k: v for k, v in dataclasses.asdict(cfg).items()
                            if k not in ("swin", "encoder", "vocab_size")})
    out = str(tmp_path / "export")
    assert main(["export", out, "--checkpoint-dir", str(tmp_path),
                 "--checkpoint", "ck", "--encoder", "res18trans",
                 "--model-overrides", overrides, "--device", "cpu"]) == 0
    _, ms, _, _, cfg2 = tckpt.load_params_for_serving(out)
    assert cfg2 == cfg
    saved, _ = tckpt.load_checkpoint(str(tmp_path), "ck", fresh()[0])
    for x, y in zip(tree.leaves(saved.model_state), tree.leaves(ms)):
        assert np.array_equal(x.numpy(), np.asarray(y))


def test_jax_checkpoint_model_state_restores(tmp_path):
    """A training checkpoint that JAX wrote (orbax) for resnet18: the
    port's ``load_checkpoint(params_only=True)`` restores its params and
    statistics exactly, as float32 tensors."""
    cfg, params, state = _model("resnet18")
    jtc = jcfg.TrainConfig()
    jstate, _ = jstep.create_train_state(jax.random.PRNGKey(0),
                                         jax_config(cfg), jtc)
    jstate = jstate.replace(params=_j(params), model_state=_j(state))
    jckpt.save_checkpoint(str(tmp_path), "jax", jstate, 1, 0.5)
    template, _ = tstep.create_train_state(cfg, tcfg.TrainConfig(),
                                           device="cpu")
    got, _ = tckpt.load_checkpoint(str(tmp_path), "jax", template,
                                   params_only=True)
    assert_stats(got.model_state, state, rtol=0)
    assert all(t.dtype == torch.float32 for t in tree.leaves(got.model_state))
    for k, v in by_path(got.params).items():
        np.testing.assert_array_equal(v, by_path(params)[k], err_msg=k)


def test_init_from_artifact_takes_its_state(tmp_path):
    """``train --init-from``'s graft takes a ResNet artifact's statistics
    onto the state's device as float32 tensors."""
    from handwritten_math_ocr_api_torch.train.loop import _graft_init

    cfg, params, state = _model("resnet18")
    out = str(tmp_path / "a")
    tckpt.save_params_for_serving(out, params, VOCAB, cfg, model_state=state)
    st, _ = tstep.create_train_state(cfg, tcfg.TrainConfig(), device="cpu")
    st = _graft_init(st, out)
    assert_stats(st.model_state, state, rtol=0)
    assert all(torch.is_tensor(t) and t.dtype == torch.float32
               for t in tree.leaves(st.model_state))


def test_cli_model_overrides_take_a_resnet_dict():
    """``--model-overrides`` with a nested ``"resnet"`` dict builds the
    ``ResNetConfig`` (tuples from JSON lists)."""
    import argparse

    from handwritten_math_ocr_api_torch.cli import _model_config

    args = argparse.Namespace(encoder="resnet18", model_overrides=json.dumps(
        {"d_model": 32, "resnet": {"stage_channels": [8, 16, 32, 64]}}))
    cfg = _model_config(args, 20)
    assert cfg.resnet == tcfg.ResNetConfig(stage_channels=(8, 16, 32, 64))
    assert cfg.d_model == 32 and cfg.vocab_size == 20


def test_checkpoint_refuses_another_state_tree(tmp_path):
    """A checkpoint whose model state does not fit the template (resnet18
    saved, another trunk asked for) raises ValueError."""
    cfg, _, _ = _model("resnet18")
    state, _ = tstep.create_train_state(cfg, tcfg.TrainConfig(), device="cpu")
    tckpt.save_checkpoint(str(tmp_path), "ck", state, 0, 0.0)
    other = cfg.replace(resnet=dataclasses.replace(
        cfg.resnet, stage_blocks=(1, 1, 1, 1)))
    template, _ = tstep.create_train_state(other, tcfg.TrainConfig(),
                                           device="cpu")
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(str(tmp_path), "ck", template,
                              params_only=True)

