"""The port's training loop, CLI and checkpoint surgery on the CPU:
``train_model`` over ``make_learnable_dataset`` (checkpoints, ``best_model``,
early stopping, resume and resume across optimizer chains, ``init_from``,
``freeze_encoder_epochs``, a ``mesh`` of one rank), a learnability test (a
tiny model must learn to read its training images), the CLI's
``build-vocab`` -> ``train`` -> ``evaluate`` -> ``predict`` through
``python -m handwritten_math_ocr_api_torch``, and ``extend-vocab`` /
``convert-gqa`` against the JAX package's on the same checkpoint (their
trees exactly equal).
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

from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.train import checkpoint as jckpt
from handwritten_math_ocr_api_tpu.train import gqa_convert as jgqa
from handwritten_math_ocr_api_tpu.train import step as jstep
from handwritten_math_ocr_api_tpu.train import vocab_extend as jvext

from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.tokenizer import (
    Tokenizer,
    create_vocab_from_csvs,
    load_vocab,
    save_vocab,
)
from handwritten_math_ocr_api_torch.data.dataset import (
    DataLoader,
    MathFormulaDataset,
)
from handwritten_math_ocr_api_torch.data.synthetic import (
    ENV_TOKENS,
    make_learnable_dataset,
)
from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
from handwritten_math_ocr_api_torch.train import checkpoint as tckpt
from handwritten_math_ocr_api_torch.train import gqa_convert as tgqa
from handwritten_math_ocr_api_torch.train import loop as tloop
from handwritten_math_ocr_api_torch.train import step as tstep
from handwritten_math_ocr_api_torch.train import vocab_extend as tvext
from handwritten_math_ocr_api_torch.utils import tree

import torch_threads  # noqa: F401  (one CPU thread: see the module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 96
SWIN = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window_size=4,
            stochastic_depth=0.0)


def model_config(vocab_size, **kw):
    return tcfg.ModelConfig(img_h=H, img_w=W, d_model=32, nhead=4,
                            dim_feedforward=64, dropout=0.0,
                            num_decoder_layers=2, max_seq_len=20,
                            vocab_size=vocab_size, dtype="float32",
                            swin=tcfg.SwinConfig(**SWIN), **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("learnable"))
    make_learnable_dataset(root, splits=(("train", 16), ("validate", 8)),
                           img_h=H, img_w=W, n_distinct=4)
    vocab = create_vocab_from_csvs([f"{root}/train_labels.csv"])
    return root, vocab


def loaders(root, tok, cfg):
    def mk(split, shuffle):
        return DataLoader(MathFormulaDataset(
            f"{root}/{split}_formulas", f"{root}/{split}_labels.csv", tok,
            H, W, cfg.max_seq_len), 8, shuffle=shuffle,
            drop_remainder=shuffle)

    return mk("train", True), mk("validate", False)


def run(corpus, ckpt_dir, epochs=2, lr=1e-3, **kw):
    root, vocab = corpus
    tok = Tokenizer(vocab)
    train_kw = {k: kw.pop(k) for k in list(kw)
                if k in ("warmup_steps", "early_stop_patience", "ema_decay",
                         "checkpoint_every")}
    cfg = tcfg.Config(model=model_config(len(vocab)),
                      train=tcfg.TrainConfig(
                          epochs=epochs, learning_rate=lr,
                          checkpoint_dir=str(ckpt_dir),
                          **{"checkpoint_every": 1, **train_kw}))
    train, val = loaders(root, tok, cfg.model)
    return tloop.train_model(cfg, train, val, tok, device="cpu", **kw)


def meta(path):
    with open(os.path.join(path, "train_meta.json")) as f:
        return json.load(f)


def test_train_model_checkpoints_and_resume(corpus, tmp_path):
    """Two epochs write checkpoint_epoch_1/2, best_model and the curves; a
    resume from epoch 2 runs epoch 3 only, with the step count going on."""
    state = run(corpus, tmp_path, epochs=2, ema_decay=0.9)
    assert state.step == 4 and state.ema_params is not None
    names = set(os.listdir(tmp_path))
    assert {"checkpoint_epoch_1", "checkpoint_epoch_2", "best_model",
            "training_curves.png"} <= names
    assert meta(tmp_path / "checkpoint_epoch_2")["epoch"] == 2
    state = run(corpus, tmp_path, epochs=3, ema_decay=0.9,
                resume_from="checkpoint_epoch_2")
    assert state.step == 6
    assert meta(tmp_path / "checkpoint_epoch_3")["epoch"] == 3


def test_train_model_resume_across_optimizer_chains(corpus, tmp_path,
                                                    caplog):
    """A checkpoint of a chain without warmup resumed under warmup: params
    only, a fresh optimizer (logged), the epochs going on."""
    run(corpus, tmp_path, epochs=1)
    saved = tckpt.load_checkpoint(str(tmp_path), "checkpoint_epoch_1",
                                  tstep.create_train_state(
                                      model_config(len(corpus[1])),
                                      tcfg.TrainConfig(), 0, "cpu")[0])[0]
    with caplog.at_level("WARNING"):
        state = run(corpus, tmp_path, epochs=2, lr=0.0, warmup_steps=2,
                    resume_from="checkpoint_epoch_1")
    assert "restoring params only" in caplog.text
    assert int(state.opt_state["warmup_count"]) == 2
    for a, b in zip(tree.leaves(state.params), tree.leaves(saved.params)):
        assert torch.equal(a, b)  # learning rate 0


def test_train_model_early_stop(corpus, tmp_path):
    """At learning rate 0 nothing improves after epoch 1: patience 1 stops
    after epoch 2 of 4."""
    run(corpus, tmp_path, epochs=4, lr=0.0, early_stop_patience=1)
    names = set(os.listdir(tmp_path))
    assert "checkpoint_epoch_2" in names
    assert "checkpoint_epoch_3" not in names
    assert meta(tmp_path / "best_model")["epoch"] == 1


def test_train_model_init_from_and_freeze(corpus, tmp_path):
    """``init_from`` grafts a serving artifact's subtrees (a decoder of
    another vocab is skipped); a frozen encoder stays as grafted while the
    decoder trains."""
    vocab = corpus[1]
    cfg = model_config(len(vocab))
    donor, _ = tstep.create_train_state(cfg, tcfg.TrainConfig(), 7, "cpu")
    other = dict(donor.params)
    other["decoder"] = tstep.create_train_state(
        model_config(len(vocab) + 3), tcfg.TrainConfig(), 8,
        "cpu")[0].params["decoder"]
    art = str(tmp_path / "artifact")
    tckpt.save_params_for_serving(art, other, vocab, cfg)
    state = run(corpus, tmp_path / "ck", epochs=1, init_from=art,
                freeze_encoder_epochs=1)
    for a, b in zip(tree.leaves(state.params["encoder"]),
                    tree.leaves(donor.params["encoder"])):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(
        tree.leaves(state.params["projection"]),
        tree.leaves(donor.params["projection"])))
    fresh, _ = tstep.create_train_state(cfg, tcfg.TrainConfig(), 0, "cpu")
    assert tree.structure(state.params) == tree.structure(fresh.params)


def test_train_model_refuses_a_mesh(corpus, tmp_path, monkeypatch):
    """What is not a ``DeviceMesh`` is refused (TypeError); a 1 x 1
    ``DeviceMesh`` of a one-rank gloo group trains as one device does
    (``tests/test_torch_train_mesh.py`` runs the larger meshes)."""
    import datetime

    import torch.distributed as dist

    from handwritten_math_ocr_api_torch.parallel import mesh as mesh_lib

    with pytest.raises(TypeError, match="DeviceMesh"):
        run(corpus, tmp_path / "refused", epochs=1, mesh=object())
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        got = run(corpus, tmp_path / "mesh", epochs=1,
                  mesh=mesh_lib.make_device_mesh(1, 1))
        assert all(type(p).__name__ == "DTensor"
                   for p in tree.leaves(got.params))
        got = [p.full_tensor().detach() for p in tree.leaves(got.params)]
    finally:
        dist.destroy_process_group()
    want = run(corpus, tmp_path / "one", epochs=1)
    for a, b in zip(got, tree.leaves(want.params)):
        torch.testing.assert_close(a, b.detach(), atol=5e-5, rtol=1e-4)
    assert os.path.exists(tmp_path / "mesh" / "checkpoint_epoch_1")


def test_pipeline_learns_to_read(tmp_path):
    """A tiny model overfits 8 images that depict their labels (no
    augmentation), then greedy decoding reproduces most labels exactly."""
    root = str(tmp_path)
    make_learnable_dataset(root, splits=(("train", 8),), n_distinct=4)
    vocab = create_vocab_from_csvs([f"{root}/train_labels.csv"])
    tok = Tokenizer(vocab)
    cfg = tcfg.ModelConfig(
        d_model=64, nhead=4, dim_feedforward=128, dropout=0.0,
        num_decoder_layers=2, max_seq_len=20, vocab_size=len(vocab),
        dtype="float32",
        swin=tcfg.SwinConfig(embed_dim=16, depths=(1, 1), num_heads=(2, 2),
                             window_size=4, stochastic_depth=0.0))
    tc = tcfg.TrainConfig(learning_rate=2e-3)
    batch = next(iter(DataLoader(MathFormulaDataset(
        f"{root}/train_formulas", f"{root}/train_labels.csv", tok,
        max_seq_len=20), 8)))
    state, opt = tstep.create_train_state(cfg, tc, 0, "cpu")
    step = tstep.make_train_step(
        cfg, tc, opt, tcfg.DataConfig(aug_degrees=0.0, aug_shear=0.0,
                                      aug_scale=(1.0, 1.0)), device="cpu")
    loss = None
    for _ in range(120):
        state, m = step(state, batch["image"], batch["caption"], 1)
        loss = float(m["loss"])
        if loss < 0.8:
            break
    assert loss < 1.5, f"did not overfit: loss={loss}"
    engine = DecodeEngine(tree.map_tree(lambda p: p.detach(), state.params),
                          cfg, tcfg.DecodeConfig(max_seq_len=20,
                                                 batch_buckets=(8,)),
                          tok, device="cpu")
    preds = engine.predict_batch(batch["image"] / np.float32(127.5) - 1)
    targets = tok.decode_batch(batch["caption"])
    exact = sum(p == t for p, t in zip(preds, targets))
    assert exact >= 6, list(zip(preds, targets))


# -------------------------------------------------------------------- CLI


def test_cli_build_vocab_train_evaluate_predict(tmp_path):
    make_learnable_dataset(str(tmp_path / "data"),
                           splits=(("train", 16), ("validate", 8),
                                   ("test", 8)), img_h=H, img_w=W)
    over = json.dumps({"img_h": H, "img_w": W, "d_model": 32, "nhead": 4,
                       "dim_feedforward": 64, "num_decoder_layers": 2,
                       "max_seq_len": 20, "dtype": "float32",
                       "swin": SWIN})
    common = ["--data-root", "data", "--checkpoint-dir", "ck"]
    dev = ["--device", "cpu", "--model-overrides", over]

    def cli(*args):
        out = subprocess.run(
            [sys.executable, "-m", "handwritten_math_ocr_api_torch", *args],
            cwd=tmp_path, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": REPO})
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    assert "tokens ->" in cli("build-vocab", *common)
    cli("train", *common, *dev, "--epochs", "2", "--batch-size", "8",
        "--num-workers", "2", "--warmup-steps", "2")
    assert os.path.isdir(tmp_path / "ck" / "best_model")
    out = cli("evaluate", *common, *dev, "--batch-size", "4", "--out-dir",
              "res")
    assert out.startswith("accuracy=")
    assert os.path.exists(tmp_path / "res" / "test_results.csv")
    png = os.path.join("data", "test_formulas", "test_00000.png")
    assert "Confidence:" in cli("predict", png, *common, *dev)
    assert "Predicted LaTeX:" in cli("predict", png, *common, *dev,
                                     "--beam-size", "3")
    assert "Confidence:" in cli("predict", png, *common, *dev, "--top-k",
                                "1")


def test_cli_refuses_the_stroke_renderer(tmp_path):
    """The stroke renderer's native backend without the stroke renderer is
    refused, as JAX's CLI refuses it."""
    out = subprocess.run(
        [sys.executable, "-m", "handwritten_math_ocr_api_torch", "train",
         "--synthetic-stream", "8", "--stream-native-render",
         "--checkpoint-dir", str(tmp_path)], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert (out.returncode != 0
            and "requires --stream-renderer stroke" in out.stderr)


# ---------------------------------------------- vocab extension, GQA


def jax_config(cfg):
    d = dataclasses.asdict(cfg)
    d["swin"] = jcfg.SwinConfig(**d["swin"])
    d["resnet"] = jcfg.ResNetConfig(**d["resnet"])
    return jcfg.ModelConfig(**d)


@pytest.fixture(scope="module")
def jax_source(tmp_path_factory):
    """A checkpoint that the JAX package saved (without an EMA) beside its
    vocab."""
    d = str(tmp_path_factory.mktemp("src"))
    vocab = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3, "a": 4, "b": 5}
    cfg = model_config(len(vocab))
    state, _ = jstep.create_train_state(jax.random.PRNGKey(0),
                                        jax_config(cfg), jcfg.TrainConfig())
    jckpt.save_checkpoint(d, "best_model", state, 3, 1.0)
    save_vocab(vocab, os.path.join(d, "vocab.json"))
    return d, cfg


def port_read(directory, cfg):
    template, _ = tstep.create_train_state(
        cfg, tcfg.TrainConfig(ema_decay=0.999), 0, "cpu")
    return tckpt.load_checkpoint(directory, "best_model", template,
                                 params_only=True)


def same_states(ours, theirs):
    for a, b in ((ours.params, theirs.params),
                 (ours.ema_params, theirs.ema_params)):
        assert tree.paths(a) == tree.paths(b)
        for x, y in zip(tree.leaves(a), tree.leaves(b)):
            assert torch.equal(x, y)
    assert ours.step == theirs.step


def test_extend_vocab_matches_jax(jax_source, tmp_path):
    src, cfg = jax_source
    ours, added = tvext.extend_checkpoint(src, "best_model",
                                          str(tmp_path / "t"), cfg, seed=4,
                                          device="cpu")
    _, jadded = jvext.extend_checkpoint(src, "best_model",
                                        str(tmp_path / "j"),
                                        jax_config(cfg), seed=4)
    assert added == jadded == sorted(ENV_TOKENS)
    assert load_vocab(str(tmp_path / "t" / "vocab.json")) == load_vocab(
        str(tmp_path / "j" / "vocab.json"))
    new = cfg.replace(vocab_size=6 + len(added))
    got, got_meta = port_read(str(tmp_path / "t"), new)
    want, want_meta = port_read(str(tmp_path / "j"), new)
    same_states(got, want)
    assert got_meta["extra"]["added_tokens"] == added


def test_convert_gqa_matches_jax(jax_source, tmp_path):
    src, cfg = jax_source
    _, cfg_new = tgqa.convert_to_gqa(src, "best_model", str(tmp_path / "t"),
                                     cfg, 2, device="cpu")
    jgqa.convert_to_gqa(src, "best_model", str(tmp_path / "j"),
                        jax_config(cfg), 2)
    assert cfg_new == cfg.replace(nhead_kv=2)
    got, _ = port_read(str(tmp_path / "t"), cfg_new)
    want, _ = port_read(str(tmp_path / "j"), cfg_new)
    same_states(got, want)
    with pytest.raises(ValueError, match="divisible"):
        tgqa.convert_to_gqa(src, "best_model", str(tmp_path / "x"), cfg, 3,
                            device="cpu")
