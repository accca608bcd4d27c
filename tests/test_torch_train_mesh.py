"""The port's training over ``torch.distributed`` on a ('data', 'tensor')
mesh, against its one-device training.

The counterparts of ``tests/test_train.py``'s mesh cases, spawned as gloo
process groups on the CPU (``tests/torch_dist_worker.py``): one train step
on a 2 x 2 mesh (params by ``TP_RULES``, the batch on 'data') with float
images, with dropout and stochastic depth on, with uint8 images (whose
augmentation draws), and with the EMA, each against the same step on one
device; the placements; ``commit_to_mesh``; ``train_model`` on 2 ranks
(two steps and a val pass), whose checkpoint a one-device run resumes;
and the CLI's ``train`` under ``torchrun`` with 2 gloo ranks.

Tolerances are JAX's test's: the loss within 1e-4, params within atol
5e-5 and rtol 1e-4 (float32 sums reduced over the mesh in other orders).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.parallel import mesh as jmesh
from handwritten_math_ocr_api_tpu.train import step as jstep

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.train import checkpoint as tckpt
from handwritten_math_ocr_api_torch.train import loop as tloop
from handwritten_math_ocr_api_torch.train import step as tstep

import torch_dist_worker as w
import torch_threads  # noqa: F401  (one CPU thread: see the module)

LOSS_TOL = 1e-4
ATOL, RTOL = 5e-5, 1e-4


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return w.spawn("steps", 4, tmp_path_factory.mktemp("steps"))


def _close(got, want, atol=ATOL, rtol=RTOL):
    assert len(got) == len(want)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, torch.as_tensor(x), atol=atol,
                                   rtol=rtol)


def jax_config(cfg):
    d = dataclasses.asdict(cfg)
    d["swin"] = jcfg.SwinConfig(**d["swin"])
    d["resnet"] = jcfg.ResNetConfig(**d["resnet"])
    return jcfg.ModelConfig(**d)


def by_path(jtree):
    """{"a/b/0": numpy leaf} of a JAX tree."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jtree)}


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """One train step from JAX's ``init_model`` params on float images:
    the port's on a 2 x 2 gloo mesh, and JAX's on a 2 x 2 mesh of its
    virtual CPU devices (as ``tests/test_train.py`` shards it)."""
    cfg = w.model_config()
    jc = jax_config(cfg)
    tc = jcfg.TrainConfig(**dataclasses.asdict(
        tcfg.TrainConfig(learning_rate=1e-3)))
    state, opt = jstep.create_train_state(jax.random.PRNGKey(0), jc, tc)
    params = convert.to_torch(jax.tree_util.tree_map(np.asarray,
                                                     state.params),
                              cfg, "cpu")
    path = tmp_path_factory.mktemp("jax")
    torch.save(params, path / "params.pt")
    got = w.spawn("jax", 4, path)

    mesh = jmesh.make_mesh(data=2, tensor=2, devices=jax.devices()[:4])
    state = state.replace(params=jmesh.shard_params(state.params, mesh))
    images, caps = w.batch()
    si, sc = jmesh.shard_batch((jnp.asarray(images), jnp.asarray(caps)),
                               mesh)
    state, m = jstep.make_train_step(jc, tc, opt)(state, si, sc,
                                                  jax.random.PRNGKey(1))
    after = by_path(state.params)
    want = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": [np.array(after["/".join(p)])
                       for p in tloop.tree.paths(params)]}
    return got, want


@pytest.mark.parametrize("case", list(w.STEP_CASES))
def test_sharded_step_matches_one_device(steps, case):
    r = steps[case]
    assert abs(r["loss"][0] - r["loss"][1]) < LOSS_TOL
    assert abs(r["grad_norm"][0] - r["grad_norm"][1]) < LOSS_TOL
    _close(r["params"][1], r["params"][0])
    assert r["all_dtensors"]
    assert r["lr"] == pytest.approx(1e-3)


def test_sharded_step_matches_jax(jax_step):
    """The port's 2 x 2 step against JAX's 2 x 2 step from the same params
    and images: loss and gradient norm within 1e-4, params at JAX's
    tolerances."""
    got, want = jax_step
    assert abs(got["loss"] - want["loss"]) < LOSS_TOL
    assert abs(got["grad_norm"] - want["grad_norm"]) < LOSS_TOL
    _close(got["params"], want["params"])


def test_sharded_gradients_match_one_device(steps):
    """The float case's gradients, before the optimizer: every leaf within
    1e-4 relative / 1e-6 absolute of one device's (the tolerance of the
    port's one-device gradients against JAX's)."""
    one, mesh = steps["grads"]
    _close(mesh, one, atol=1e-6, rtol=1e-4)


def test_ema_on_mesh(steps):
    """The EMA shadow shards like the params, matches one device's, and
    moved away from the iterate."""
    one, mesh = steps["ema"]["ema"]
    _close(mesh, one)
    params = steps["ema"]["params"][1]
    assert max(float((e - p).abs().max()) for e, p in zip(mesh, params)) > 0


def test_tp_rules_placements(steps):
    """Replicated on 'data'; on 'tensor' sharded by ``TP_RULES``."""
    pl = steps["placements"]
    assert pl["decoder/layers/0/self_attn/w_qkv"] == ["R", 1]
    assert pl["decoder/layers/0/self_attn/w_out"] == ["R", 0]
    assert pl["decoder/layers/0/ffn/fc1/w"] == ["R", 1]
    assert pl["decoder/embedding/table"] == ["R", 0]
    assert pl["decoder/fc_out/b"] == ["R", 0]
    assert pl["decoder/layers/0/norm1/scale"] == ["R", "R"]
    # Swin's first stage has 1 head: its qkv (16, 48) shards all the same
    assert pl["encoder/stages/0/blocks/0/attn/w_qkv"] == ["R", 1]


def test_commit_to_mesh(steps):
    c = steps["commit"]
    assert c["kept"] and c["step"] == 3
    assert c["count"] == ["R", "R"]
    assert c["mixed_raises"] and c["committed_adds"] == 1.0


def test_train_model_on_two_ranks_resumes_on_one(tmp_path):
    """Two steps of ``train_model`` on 2 ranks (the loop builds a 2 x 1
    mesh) equal the one-device run; rank 0's checkpoint is one-device
    format: a one-device state loads it as saved, and a one-device run
    resumes from it."""
    got = w.spawn("loop", 2, tmp_path / "mesh")
    cfg, train, val, tok = w.loop_setup(tmp_path / "one")
    want = tloop.train_model(cfg, train, val, tok, device="cpu")
    assert got["step"] == want.step == 2
    _close(got["params"], [p.detach() for p in tloop.tree.leaves(
        want.params)])
    _close(got["ema"], list(tloop.tree.leaves(want.ema_params)))

    ck = str(tmp_path / "mesh" / "ck")
    template, _ = tstep.create_train_state(cfg.model, cfg.train, 5, "cpu")
    state, meta = tckpt.load_checkpoint(ck, "checkpoint_epoch_1", template)
    assert meta["epoch"] == 1 and state.step == 2
    for a, b in zip(tloop.tree.leaves(state.params), got["params"]):
        assert torch.equal(a.detach(), b)
    resumed_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=2, checkpoint_dir=ck))
    resumed = tloop.train_model(resumed_cfg, train, val, tok, device="cpu",
                                resume_from="checkpoint_epoch_1")
    assert resumed.step == 4
    assert all(np.isfinite(p.detach().numpy()).all()
               for p in tloop.tree.leaves(resumed.params))


def test_cli_train_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node=2 -m
    handwritten_math_ocr_api_torch train --device cpu``: a gloo group, the
    loop's 2 x 1 mesh, rank 0 alone logging and writing ``best_model``,
    which the one-device CLI then evaluates."""
    from handwritten_math_ocr_api_torch.data.synthetic import (
        make_learnable_dataset,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    make_learnable_dataset(str(tmp_path / "data"),
                           splits=(("train", 16), ("validate", 8),
                                   ("test", 4)), img_h=32, img_w=96,
                           n_distinct=4)
    over = json.dumps({"img_h": 32, "img_w": 96, "d_model": 32, "nhead": 4,
                       "dim_feedforward": 64, "num_decoder_layers": 2,
                       "max_seq_len": 20, "dtype": "float32",
                       "swin": dict(w.SWIN, depths=[1, 1], num_heads=[2, 2],
                                    stochastic_depth=0.0)})
    common = ["--data-root", "data", "--checkpoint-dir", "ck", "--device",
              "cpu", "--model-overrides", over]
    env = {**os.environ, "PYTHONPATH": repo, "GLOO_SOCKET_IFNAME": "lo",
           "OMP_NUM_THREADS": "1"}

    def run(*args):
        out = subprocess.run([sys.executable, *args], cwd=tmp_path, env=env,
                             capture_output=True, text=True,
                             timeout=w.TIMEOUT_S)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stderr

    mod = ["-m", "handwritten_math_ocr_api_torch"]
    run(*mod, "build-vocab", "--data-root", "data", "--checkpoint-dir",
        "ck")
    log = run("-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node=2", *mod, "train", *common, "--epochs", "1",
              "--batch-size", "8", "--num-workers", "1")
    assert log.count("training on mesh {'data': 2, 'tensor': 1}") == 1
    assert log.count("epoch 1/1") == 1
    assert os.path.exists(tmp_path / "ck" / "best_model" / "state.pt")
    run(*mod, "evaluate", *common, "--batch-size", "4", "--out-dir", "ev")
    assert os.path.exists(tmp_path / "ev" / "summary.txt")
