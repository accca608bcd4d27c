"""The port's training data and checkpoints against the JAX package's: the
training configs, the vocab builders, the batch loader (order, shuffle by
epoch, remainder padding and ``valid``, threads), the synthetic formulas,
stream and corpora (labels and pixels), and training checkpoints (round
trip, params only across optimizer chains, the EMA fallbacks, a checkpoint
the JAX package wrote) and the serving export.

Everything on the CPU at a small size; the synthetic images are compared
bit for bit, the checkpoints' tensors exactly. Where the JAX package
writes PNGs and CSVs with cv2 and pandas, the port with PIL and ``csv``:
the files hold the same pixels and the same text.
"""

import dataclasses
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.core import tokenizer as jtok
from handwritten_math_ocr_api_tpu.data import dataset as jdataset
from handwritten_math_ocr_api_tpu.data import synthetic as jsyn
from handwritten_math_ocr_api_tpu.train import checkpoint as jckpt
from handwritten_math_ocr_api_tpu.train import step as jstep

from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core import tokenizer as ttok
from handwritten_math_ocr_api_torch.data import dataset as tdataset
from handwritten_math_ocr_api_torch.data import synthetic as tsyn
from handwritten_math_ocr_api_torch.train import checkpoint as tckpt
from handwritten_math_ocr_api_torch.train import step as tstep
from handwritten_math_ocr_api_torch.utils import tree

import torch_threads  # noqa: F401  (one CPU thread: see the module)

CFG = tcfg.ModelConfig(
    img_h=32, img_w=64, d_model=32, nhead=4, dim_feedforward=64,
    dropout=0.0, num_decoder_layers=1, max_seq_len=16, vocab_size=20,
    swin=tcfg.SwinConfig(embed_dim=16, depths=(1, 1), num_heads=(1, 2),
                         window_size=4, stochastic_depth=0.0),
    dtype="float32")


def jax_config(cfg):
    d = dataclasses.asdict(cfg)
    d["swin"] = jcfg.SwinConfig(**d["swin"])
    d["resnet"] = jcfg.ResNetConfig(**d["resnet"])
    return jcfg.ModelConfig(**d)


def by_path(jtree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jtree)}


def read_pixels(path):
    return np.asarray(Image.open(path).convert("L"))


def same_split_files(a, b, split, pixels=True):
    """The two roots' labels CSVs hold the same text; their PNGs the same
    pixels (``pixels``)."""
    with open(os.path.join(a, f"{split}_labels.csv")) as f:
        text = f.read()
    with open(os.path.join(b, f"{split}_labels.csv")) as f:
        assert f.read() == text
    if pixels:
        names = sorted(os.listdir(os.path.join(a, f"{split}_formulas")))
        assert names == sorted(os.listdir(os.path.join(b,
                                                       f"{split}_formulas")))
        for n in names:
            np.testing.assert_array_equal(
                read_pixels(os.path.join(a, f"{split}_formulas", n)),
                read_pixels(os.path.join(b, f"{split}_formulas", n)))


# ---------------------------------------------------------------- configs


def test_train_and_data_config_defaults_match_jax():
    for ours, theirs in ((tcfg.TrainConfig(), jcfg.TrainConfig()),
                         (tcfg.DataConfig(), jcfg.DataConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(tcfg.Config)] == [
        f.name for f in dataclasses.fields(jcfg.Config)]


# ------------------------------------------------------------------ vocab


def test_vocab_builders_match_jax(tmp_path):
    rows = [("a.png", r"\frac { a } { b }"), ("b.png", ""),
            ("c.png", r"x ^ { 2 } + \alpha"), ("d.png", "12 , y")]
    csv_path = tmp_path / "train_labels.csv"
    with open(csv_path, "w") as f:
        f.write("image_filename,latex_label\n")
        for name, label in rows:
            f.write(f'{name},"{label}"\n' if "," in label
                    else f"{name},{label}\n")
    assert ttok.create_vocab([r for _, r in rows]) == jtok.create_vocab(
        [r for _, r in rows])
    ours = ttok.create_vocab_from_csvs([str(csv_path)])
    assert ours == jtok.create_vocab_from_csvs([str(csv_path)])
    ttok.save_vocab(ours, str(tmp_path / "ours.json"))
    jtok.save_vocab(ours, str(tmp_path / "jax.json"))
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


# ------------------------------------------------------ synthetic formulas


@pytest.mark.parametrize("kind", ["random", "rich", "structured",
                                  "structured_rich_envs"])
def test_formulas_match_jax(kind):
    def draw(mod, seed):
        rng = random.Random(seed)
        if kind == "random":
            return [mod.random_formula(rng) for _ in range(50)]
        if kind == "rich":
            return [mod.rich_formula(rng) for _ in range(50)]
        if kind == "structured":
            return [mod.structured_formula(rng) for _ in range(50)]
        return [mod.structured_formula(rng, max_terms=8, depth=3, rich=True,
                                       envs=True) for _ in range(50)]

    assert draw(tsyn, 5) == draw(jsyn, 5)


@pytest.mark.parametrize("rich,envs", [(False, False), (True, False),
                                       (True, True)])
def test_grammar_vocab_matches_jax(rich, envs):
    assert tsyn.grammar_vocab(rich, envs) == jsyn.grammar_vocab(rich, envs)


def test_text_and_corpus_renders_match_jax():
    np.testing.assert_array_equal(tsyn.render_text_image("x ^ { 2 }"),
                                  jsyn.render_text_image("x ^ { 2 }"))
    for seed in (0, 1):
        np.testing.assert_array_equal(
            tsyn.render_corpus_image(r"\frac { a } { b }",
                                     np.random.default_rng(seed)),
            jsyn.render_corpus_image(r"\frac { a } { b }",
                                     np.random.default_rng(seed)))


@pytest.mark.parametrize("epoch", [0, 3])
def test_stream_matches_jax(epoch):
    """The same formulas and images for the same seed and epoch; a frozen
    stream keeps its epoch."""
    vocab = tsyn.grammar_vocab()
    ours = tsyn.SyntheticStreamDataset(ttok.Tokenizer(vocab), 4, 32, 96,
                                       40, seed=9)
    theirs = jsyn.SyntheticStreamDataset(jtok.Tokenizer(vocab), 4, 32, 96,
                                         40, seed=9)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    for i in range(4):
        a, b = ours[i], theirs[i]
        assert ours.formula_at(i) == theirs.formula_at(i)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    frozen = tsyn.SyntheticStreamDataset(ttok.Tokenizer(vocab), 4, 32, 96,
                                         40, seed=9, freeze=True)
    frozen.set_epoch(epoch)
    assert frozen._epoch == 0


def test_corpus_and_learnable_datasets_match_jax(tmp_path):
    """Labels and pixels of ``make_corpus``, ``make_learnable_dataset`` and
    ``make_synthetic_dataset`` (cv2's polylines, as JAX's) equal JAX's."""
    for name, kw in (("make_corpus", dict(n_train=6, n_val=3, n_test=3,
                                          img_h=32, img_w=96, seed=2)),
                     ("make_learnable_dataset", dict(img_h=32, img_w=96)),
                     ("make_synthetic_dataset",
                      dict(splits=(("train", 5),), img_h=32, img_w=96))):
        a, b = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
        getattr(tsyn, name)(a, **kw)
        getattr(jsyn, name)(b, **kw)
        splits = ("train",) if name == "make_synthetic_dataset" else (
            "train", "validate", "test")
        for split in splits:
            same_split_files(a, b, split, pixels=True)


# ----------------------------------------------------------------- loader


@pytest.fixture(scope="module")
def learnable(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("learnable"))
    tsyn.make_learnable_dataset(root, splits=(("train", 10),), img_h=32,
                                img_w=96)
    vocab = ttok.create_vocab_from_csvs([f"{root}/train_labels.csv"])
    return root, vocab


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_jax(learnable, drop, workers):
    """Two shuffled epochs of 10 samples in batches of 4: the same images,
    captions, lengths and ``valid`` (the remainder padded by row 0 or
    dropped), batch by batch."""
    root, vocab = learnable
    mk = dict(img_h=32, img_w=96, max_seq_len=16)
    ours = tdataset.DataLoader(tdataset.MathFormulaDataset(
        f"{root}/train_formulas", f"{root}/train_labels.csv",
        ttok.Tokenizer(vocab), **mk), 4, shuffle=True, seed=3,
        num_workers=workers, drop_remainder=drop)
    theirs = jdataset.DataLoader(jdataset.MathFormulaDataset(
        f"{root}/train_formulas", f"{root}/train_labels.csv",
        jtok.Tokenizer(vocab), **mk), 4, shuffle=True, seed=3,
        num_workers=2, drop_remainder=drop)
    assert len(ours) == len(theirs) == (2 if drop else 3)
    epochs = []
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        epochs.append(np.concatenate([g["caption"] for g in got]))
    assert not np.array_equal(epochs[0], epochs[1])
    if not drop:
        assert got[-1]["valid"].tolist() == [True, True, False, False]


def test_loader_set_epoch_and_stream(learnable):
    """A stream's loader tells it the epoch (``set_epoch`` sets the next
    one); JAX's loader over JAX's stream gives the same batches."""
    vocab = tsyn.grammar_vocab()
    ours = tdataset.DataLoader(tsyn.SyntheticStreamDataset(
        ttok.Tokenizer(vocab), 6, 32, 96, 40, seed=1), 3, num_workers=2,
        drop_remainder=True)
    theirs = jdataset.DataLoader(jsyn.SyntheticStreamDataset(
        jtok.Tokenizer(vocab), 6, 32, 96, 40, seed=1), 3, num_workers=2,
        drop_remainder=True)
    list(theirs)
    ours.set_epoch(1)
    for g, w in zip(ours, theirs):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["caption"], w["caption"])


def test_loader_stops_its_threads_when_left(learnable):
    root, vocab = learnable
    loader = tdataset.DataLoader(tdataset.MathFormulaDataset(
        f"{root}/train_formulas", f"{root}/train_labels.csv",
        ttok.Tokenizer(vocab), 32, 96, 16), 1, num_workers=2, prefetch=1)
    import threading

    before = set(threading.enumerate())
    it = iter(loader)
    next(it)
    assert set(threading.enumerate()) - before  # the producer and its pool
    it.close()
    assert not set(threading.enumerate()) - before


def test_get_data_loaders(learnable, tmp_path):
    root, vocab = learnable
    tsyn.make_learnable_dataset(str(tmp_path), splits=(("train", 6),
                                                       ("validate", 3)),
                                img_h=32, img_w=96)
    dc = tcfg.DataConfig(data_root=str(tmp_path), batch_size=4,
                         num_workers=1)
    train, val = tdataset.get_data_loaders(ttok.Tokenizer(vocab), dc,
                                           CFG.replace(img_w=96))
    assert (train.shuffle, train.drop_remainder, len(train)) == (True, True,
                                                                 1)
    assert (val.shuffle, val.drop_remainder, len(val)) == (False, False, 1)


# ------------------------------------------------------------ checkpoints


def _trained_state(tc, seed=0, steps=2):
    state, opt = tstep.create_train_state(CFG, tc, seed, "cpu")
    step = tstep.make_train_step(CFG, tc, opt, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        images = rng.integers(0, 256, (2, 32, 64, 1)).astype(np.uint8)
        caps = rng.integers(3, 20, (2, 16)).astype(np.int32)
        caps[:, 0] = 1
        state, _ = step(state, images, caps, 1)
    return state


def _equal_trees(a, b):
    pa, pb = tree.paths(a), tree.paths(b)
    assert pa == pb
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_checkpoint_round_trip_exact(tmp_path):
    tc = tcfg.TrainConfig(warmup_steps=3, ema_decay=0.9)
    state = _trained_state(tc)
    tckpt.save_checkpoint(str(tmp_path), "c", state, 2, 0.5,
                          {"best": 0.5}, {"note": "x"})
    fresh, _ = tstep.create_train_state(CFG, tc, 1, "cpu")
    got, meta = tckpt.load_checkpoint(str(tmp_path), "c", fresh)
    assert meta == {"epoch": 2, "metric_value": 0.5,
                    "scheduler": {"best": 0.5}, "extra": {"note": "x"}}
    assert got.step == 2
    _equal_trees(got.params, state.params)
    _equal_trees(got.opt_state, state.opt_state)
    _equal_trees(got.ema_params, state.ema_params)
    assert all(p.requires_grad for p in tree.leaves(got.params))


def test_checkpoint_params_only_across_optimizer_chains(tmp_path):
    """A checkpoint of a warmup chain does not restore into a chain
    without warmup (ValueError, as orbax's restore), but its params do."""
    state = _trained_state(tcfg.TrainConfig(warmup_steps=3))
    tckpt.save_checkpoint(str(tmp_path), "c", state, 1, 0.0)
    fresh, _ = tstep.create_train_state(CFG, tcfg.TrainConfig(), 1, "cpu")
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(str(tmp_path), "c", fresh)
    got, _ = tckpt.load_checkpoint(str(tmp_path), "c", fresh,
                                   params_only=True)
    _equal_trees(got.params, state.params)
    assert "warmup_count" not in got.opt_state


def test_checkpoint_ema_fallbacks(tmp_path):
    """Without an EMA in the checkpoint the shadow starts as a copy of the
    params (other tensors); an EMA the template does not track stays
    out."""
    plain = _trained_state(tcfg.TrainConfig())
    tckpt.save_checkpoint(str(tmp_path), "plain", plain, 1, 0.0)
    fresh, _ = tstep.create_train_state(
        CFG, tcfg.TrainConfig(ema_decay=0.9), 1, "cpu")
    got, _ = tckpt.load_checkpoint(str(tmp_path), "plain", fresh,
                                   params_only=True)
    _equal_trees(got.ema_params, got.params)
    for e, p in zip(tree.leaves(got.ema_params), tree.leaves(got.params)):
        assert e.data_ptr() != p.data_ptr()
    ema = _trained_state(tcfg.TrainConfig(ema_decay=0.9))
    tckpt.save_checkpoint(str(tmp_path), "ema", ema, 1, 0.0)
    no_ema, _ = tstep.create_train_state(CFG, tcfg.TrainConfig(), 1, "cpu")
    got, _ = tckpt.load_checkpoint(str(tmp_path), "ema", no_ema)
    assert got.ema_params is None


def test_jax_training_checkpoint_read_params_only(tmp_path):
    """A checkpoint that JAX's ``save_checkpoint`` wrote after one JAX step
    (with an EMA): params, EMA and step bit for bit; its optax optimizer
    state is refused without ``params_only``."""
    jc = jax_config(CFG)
    jtc = jcfg.TrainConfig(ema_decay=0.9)
    jstate, jopt = jstep.create_train_state(jax.random.PRNGKey(0), jc, jtc)
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (2, 32, 64, 1)).astype(np.float32)
    caps = rng.integers(3, 20, (2, 16)).astype(np.int32)
    caps[:, 0] = 1
    jstate, _ = jstep.make_train_step(jc, jtc, jopt)(
        jstate, jnp.asarray(images), jnp.asarray(caps),
        jax.random.PRNGKey(1))
    jckpt.save_checkpoint(str(tmp_path), "jax", jstate, 1, 0.25)
    tc = tcfg.TrainConfig(ema_decay=0.9)
    fresh, _ = tstep.create_train_state(CFG, tc, 0, "cpu")
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(str(tmp_path), "jax", fresh)
    got, meta = tckpt.load_checkpoint(str(tmp_path), "jax", fresh,
                                      params_only=True)
    assert got.step == 1 and meta["metric_value"] == 0.25
    for name, ours, theirs in (("params", got.params, jstate.params),
                               ("ema", got.ema_params, jstate.ema_params)):
        want = by_path(theirs)
        for p, x in zip(tree.paths(ours), tree.leaves(ours)):
            np.testing.assert_array_equal(x.detach().numpy(),
                                          want["/".join(p)],
                                          err_msg=f"{name} {'/'.join(p)}")


def test_serving_export_round_trip(tmp_path):
    """``save_params_for_serving`` -> ``load_params_for_serving``: the same
    tree bit for bit (``tree_digest``), vocab and config."""
    state = _trained_state(tcfg.TrainConfig())
    vocab = tsyn.grammar_vocab()
    tckpt.save_params_for_serving(str(tmp_path), state.params, vocab, CFG)
    params, model_state, got_vocab, idx2char, cfg = \
        tckpt.load_params_for_serving(str(tmp_path))
    assert tckpt.tree_digest(params) == tckpt.tree_digest(state.params)
    assert (model_state, got_vocab, cfg) == ({}, vocab, CFG)
    assert idx2char == {i: t for t, i in vocab.items()}
