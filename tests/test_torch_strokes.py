"""The stroke renderer (``data/strokes.py``) of the port against the JAX
package's.

Every case of JAX's ``tests/test_strokes.py`` on the port, and the port's
output held to JAX's bit for bit for the same seeds: the glyph templates,
``formula_strokes``' points (the grammar, the rich inventory, the 2-D
environments, a denser layout and the native display list),
``render_stroke_image``'s uint8 images (plain and degraded),
``StrokeStreamDataset``'s items and ``make_stroke_corpus``'s files. The
draws come from ``random.Random`` and numpy generators, and both packages
rasterize with the same cv2, so nothing needs a tolerance. The native
renderer's cases are in ``tests/test_torch_native.py``.
"""

import csv
import os
import random

import numpy as np
import pytest

from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.data import strokes as jst
from handwritten_math_ocr_api_tpu.data.synthetic import (
    structured_formula as j_structured_formula,
)

from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.data.strokes import (
    DESCENDERS,
    GLYPHS,
    StrokeStreamDataset,
    _GlyphEntry,
    _WORD_TOKENS,
    _handwrite,
    formula_strokes,
    make_stroke_corpus,
    render_stroke_image,
    stroke_vocab,
)
from handwritten_math_ocr_api_torch.data.synthetic import (
    grammar_vocab,
    structured_formula,
)

import torch_threads  # noqa: F401  (one CPU thread: see the module)


# -- JAX's cases on the port ---------------------------------------------------


def test_every_grammar_token_renderable():
    """Every token the formula grammar can emit has ink: a glyph template,
    a word expansion, or a structural layout role."""
    structural = {"{", "}", "^", "_", r"\frac", r"\sqrt"}
    for tok in grammar_vocab():
        if tok.startswith("<"):
            continue
        assert (tok in GLYPHS or tok in _WORD_TOKENS
                or tok in structural), tok


def test_stroke_vocab_matches_grammar():
    assert stroke_vocab() == grammar_vocab()
    assert stroke_vocab(rich=True, envs=True) == jst.stroke_vocab(
        rich=True, envs=True)


def test_parser_handles_any_grammar_sample():
    """500 random grammar samples lay out without error, each with ink."""
    prng = random.Random(0)
    for i in range(500):
        f = structured_formula(prng)
        strokes = formula_strokes(f, random.Random(i))
        assert strokes, f
        assert sum(len(s) for s in strokes) >= 3, f


def test_render_produces_ink_and_contrast():
    img = render_stroke_image(r"x ^ { 2 } + \frac { a } { b }",
                              np.random.default_rng(0))
    assert img.shape == (96, 320) and img.dtype == np.uint8
    assert 0.002 < float((img < 128).mean()) < 0.5
    assert img.max() > 180  # light paper present


def test_structural_layout_differs_from_literal():
    """'x ^ { 2 }' has no ink for the brace and caret tokens, and its
    superscript sits above the base glyph."""
    prng = random.Random(1)
    sup = formula_strokes("x ^ { 2 }", prng, jitter=0.0)
    lit = formula_strokes("x + a - 2", prng, jitter=0.0)  # 5 glyphs wide

    def width(strokes):
        return (max(p[:, 0].max() for p in strokes)
                - min(p[:, 0].min() for p in strokes))

    assert width(sup) < 0.6 * width(lit)
    x_strokes = formula_strokes("x", prng, jitter=0.0)
    x_top = min(p[:, 1].min() for p in x_strokes)
    assert min(p[:, 1].min() for p in sup) < x_top - 0.2


def test_fraction_stacks_vertically():
    frac = formula_strokes(r"\frac { a } { b }", random.Random(2), jitter=0.0)
    ys = np.concatenate([p[:, 1] for p in frac])
    xs = np.concatenate([p[:, 0] for p in frac])
    assert ys.max() - ys.min() > 1.2
    assert xs.max() - xs.min() < 1.5


def test_stream_dataset_deterministic_and_labelled():
    tok = Tokenizer(grammar_vocab())
    ds = StrokeStreamDataset(tok, samples_per_epoch=8, seed=3)
    img1, ids1, n1 = ds[0]
    img2, ids2, n2 = ds[0]
    np.testing.assert_array_equal(img1, img2)
    np.testing.assert_array_equal(ids1, ids2)
    assert n1 == n2 and n1 >= 3
    assert img1.dtype == np.uint8 and img1.shape == (96, 320)
    assert tok.decode(ids1) == ds.formula_at(0)
    ds.set_epoch(1)
    assert not np.array_equal(img1, ds[0][0])


def test_make_stroke_corpus_contract(tmp_path):
    root = str(tmp_path)
    make_stroke_corpus(root, n_train=4, n_val=2, n_test=2)
    for split, n in (("train", 4), ("validate", 2), ("test", 2)):
        with open(os.path.join(root, f"{split}_labels.csv"),
                  newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["image_filename", "latex_label"]
        assert len(rows) == n + 1
        for name, _ in rows[1:]:
            assert os.path.exists(os.path.join(root, f"{split}_formulas",
                                               name))


@pytest.mark.parametrize("tok", [r"\sum", r"\int", r"\sqrt", "(", ")"])
def test_special_glyphs_have_ink(tok):
    f = {r"\sqrt": r"\sqrt { x }"}.get(tok, tok)
    strokes = formula_strokes(f, random.Random(0), jitter=0.0)
    assert sum(len(s) for s in strokes) >= 4


def test_every_rich_grammar_token_renderable():
    structural = {"{", "}", "^", "_", r"\frac", r"\sqrt", r"\lim"}
    for tok in grammar_vocab(rich=True):
        if tok.startswith("<"):
            continue
        assert (tok in GLYPHS or tok in _WORD_TOKENS
                or tok in structural), tok


def test_rich_vocab_strictly_larger():
    base, rich = grammar_vocab(), grammar_vocab(rich=True)
    assert set(base) <= set(rich)
    assert len(rich) >= len(base) + 60


def test_rich_parser_handles_any_sample_and_renders_ink():
    rng = random.Random(3)
    nrng = np.random.default_rng(3)
    for _ in range(200):
        f = structured_formula(rng, max_terms=8, depth=3, rich=True)
        assert formula_strokes(f, rng), f
        img = render_stroke_image(f, nrng, degrade=0.6)
        assert img.shape == (96, 320)
        assert int(img.min()) < int(img.max()) - 60, f


def test_rich_formulas_are_longer_and_use_extended_tokens():
    rng = random.Random(11)
    base_v = set(grammar_vocab())
    toks = []
    for _ in range(300):
        toks += structured_formula(rng, max_terms=8, depth=3,
                                   rich=True).split()
    assert len({t for t in toks if t not in base_v}) >= 25
    rng2 = random.Random(12)
    lens = [len(structured_formula(rng2, max_terms=8, depth=3,
                                   rich=True).split()) for _ in range(300)]
    assert max(lens) > 60
    assert np.mean(lens) > 18


def test_degrade_increases_difficulty_signals():
    f = r"\frac { a } { b } + \sqrt { x ^ { 2 } } = \Delta"
    img_a = render_stroke_image(f, np.random.default_rng(5), degrade=0.0)
    img_b = render_stroke_image(f, np.random.default_rng(5), degrade=1.0)
    assert img_a.shape == img_b.shape
    assert not np.array_equal(img_a, img_b)
    np.testing.assert_array_equal(
        img_b, render_stroke_image(f, np.random.default_rng(5), degrade=1.0))


def test_rich_stream_dataset_roundtrip():
    tok = Tokenizer(stroke_vocab(rich=True))
    ds = StrokeStreamDataset(tok, 8, max_tokens=60, rich=True, max_terms=8,
                             depth=3, degrade=0.5)
    img, ids, length = ds[0]
    assert img.shape == (96, 320) and ids.dtype == np.int32
    assert 3 not in ids[:length + 1]  # no <unk>


# -- bit for bit against JAX ---------------------------------------------------


def test_glyphs_equal_jax():
    assert sorted(GLYPHS) == sorted(jst.GLYPHS)
    for tok, (w, strokes) in GLYPHS.items():
        jw, jstrokes = jst.GLYPHS[tok]
        assert w == jw and len(strokes) == len(jstrokes), tok
        for a, b in zip(strokes, jstrokes):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=tok)
    assert _WORD_TOKENS == jst._WORD_TOKENS
    assert DESCENDERS == jst.DESCENDERS


# (grammar options, formula_strokes options): the base grammar, the rich
# inventory, the 2-D environments, a denser layout
KINDS = {
    "grammar": ({}, {}),
    "rich": ({"max_terms": 8, "depth": 3, "rich": True}, {}),
    "envs": ({"max_terms": 8, "depth": 3, "rich": True, "envs": True}, {}),
    "dense": ({"rich": True}, {"gap_scale": 0.45, "jitter": 0.6}),
}


def _formulas(kind, n, seed):
    grammar, _ = KINDS[kind]
    prng = random.Random(seed)
    out = [structured_formula(prng, **grammar) for _ in range(n)]
    jprng = random.Random(seed)
    assert out == [j_structured_formula(jprng, **grammar) for _ in range(n)]
    return out


def _same_entries(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, jst._GlyphEntry):
            assert isinstance(g, _GlyphEntry)
            assert ([getattr(g, k) for k in g.__slots__]
                    == [getattr(w, k) for k in w.__slots__])
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_formula_strokes_match_jax(kind, native):
    """The points (float32 polylines), or with ``native`` the display list
    (glyph placements with their seeds, and inline polylines), of 40
    seeded formulas equal JAX's."""
    opts = KINDS[kind][1]
    for i, f in enumerate(_formulas(kind, 40, 100 + len(kind))):
        got = formula_strokes(f, random.Random(i), native=native, **opts)
        want = jst.formula_strokes(f, random.Random(i), native=native,
                                   **opts)
        _same_entries(got, want)
        if not native:  # and the global handwriting distortions
            _same_entries(_handwrite(got, random.Random(i)),
                          jst._handwrite(want, random.Random(i)))


@pytest.mark.parametrize("degrade", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("kind", ["grammar", "rich", "envs"])
def test_render_stroke_image_matches_jax(kind, degrade):
    """uint8 images of 12 seeded formulas, plain and degraded (dropped
    strokes, blur, contrast collapse, noise), at the model's size and a
    smaller canvas, equal JAX's."""
    for i, f in enumerate(_formulas(kind, 12, 7)):
        hw = (96, 320) if i % 3 else (32, 96)
        got = render_stroke_image(f, np.random.default_rng(i), *hw,
                                  jitter=0.5 + 0.1 * (i % 6),
                                  degrade=degrade)
        want = jst.render_stroke_image(f, np.random.default_rng(i), *hw,
                                       jitter=0.5 + 0.1 * (i % 6),
                                       degrade=degrade)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hard", [False, True])
def test_stroke_stream_matches_jax(hard):
    """The stream's images, ids and lengths equal JAX's for the same seed,
    at epochs 0 and 2 (the hard regime: rich, environments, degraded)."""
    vocab = grammar_vocab(rich=hard, envs=hard)
    kw = (dict(rich=True, envs=True, max_terms=8, depth=3, max_tokens=60,
               degrade=0.6) if hard else {})
    ours = StrokeStreamDataset(Tokenizer(vocab), 4, 32, 128, 40, seed=5,
                               **kw)
    theirs = jst.StrokeStreamDataset(JTokenizer(vocab), 4, 32, 128, 40,
                                     seed=5, **kw)
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert ours.formula_at(i) == theirs.formula_at(i)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]


def test_make_stroke_corpus_matches_jax(tmp_path):
    """The hard corpus's CSV rows and PNG pixels equal JAX's (which writes
    them with cv2 and pandas)."""
    import cv2

    kw = dict(n_train=3, n_val=2, n_test=2, img_h=32, img_w=96, seed=4,
              rich=True, max_tokens=60, max_terms=8, depth=3, degrade=0.6,
              envs=True)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    make_stroke_corpus(a, **kw)
    jst.make_stroke_corpus(b, **kw)
    for split in ("train", "validate", "test"):
        rows = []
        for root in (a, b):
            with open(os.path.join(root, f"{split}_labels.csv"),
                      newline="") as f:
                rows.append(list(csv.reader(f)))
        assert rows[0] == rows[1]
        for name, _ in rows[0][1:]:
            imgs = [cv2.imread(os.path.join(root, f"{split}_formulas", name),
                               cv2.IMREAD_UNCHANGED) for root in (a, b)]
            np.testing.assert_array_equal(*imgs)


# -- the CLI -------------------------------------------------------------------

HARD_STREAM = ["--synthetic-stream", "8", "--batch-size", "4", "--epochs",
               "1", "--stream-renderer", "stroke", "--stream-hard",
               "--stream-native-render"]


def test_cli_builds_the_hard_native_stream_as_jax(tmp_path, monkeypatch):
    """``train --stream-renderer stroke --stream-hard
    --stream-native-render``: the port's CLI and JAX's hand ``train_model``
    the same streams (the stroke dataset with the hard regime's options and
    the native renderer); their first items are equal."""
    from handwritten_math_ocr_api_torch.cli import main
    from handwritten_math_ocr_api_torch.train import loop as tloop
    from handwritten_math_ocr_api_tpu.cli import main as jmain
    from handwritten_math_ocr_api_tpu.train import loop as jloop

    seen = {}

    def capture(tag):
        def train_model(cfg, train_loader, val_loader, tok, **kw):
            seen[tag] = (train_loader, val_loader)
        return train_model

    monkeypatch.setattr(tloop, "train_model", capture("port"))
    monkeypatch.setattr(jloop, "train_model", capture("jax"))
    assert main(["train", "--checkpoint-dir", str(tmp_path / "p"),
                 *HARD_STREAM]) == 0
    assert jmain(["train", "--checkpoint-dir", str(tmp_path / "j"),
                  *HARD_STREAM]) == 0
    for (ours, theirs) in zip(seen["port"], seen["jax"]):
        a, b = ours.dataset, theirs.dataset
        assert isinstance(a, StrokeStreamDataset) and a.native
        assert (a.degrade, a.native, len(a)) == (b.degrade, b.native, len(b))
        for i in range(2):
            x, y = a[i], b[i]
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
            assert x[2] == y[2]


def test_cli_trains_on_the_hard_native_stream(tmp_path):
    """One epoch of a small model through the port's CLI on that stream, on
    the host: exit 0, the rich grammar's vocab and a best model saved."""
    import json

    from handwritten_math_ocr_api_torch.cli import main
    from handwritten_math_ocr_api_torch.core.tokenizer import load_vocab

    over = json.dumps({"img_h": 32, "img_w": 96, "d_model": 32, "nhead": 4,
                       "dim_feedforward": 64, "num_decoder_layers": 2,
                       "max_seq_len": 64, "dtype": "float32",
                       "swin": {"embed_dim": 8, "depths": [1, 1],
                                "num_heads": [2, 2], "window_size": 4,
                                "stochastic_depth": 0.0}})
    ck = tmp_path / "ck"
    assert main(["train", "--device", "cpu", "--model-overrides", over,
                 "--checkpoint-dir", str(ck), "--num-workers", "1",
                 *HARD_STREAM]) == 0
    assert load_vocab(str(ck / "vocab.json"))[0] == grammar_vocab(rich=True)
    assert (ck / "best_model").is_dir()


def test_make_corpus_cli_stroke_hard_matches_jax(tmp_path):
    """``make-corpus --renderer stroke --hard --envs`` through both CLIs:
    exit 0, the same CSV rows and PNG pixels."""
    import cv2

    from handwritten_math_ocr_api_torch.cli import main
    from handwritten_math_ocr_api_tpu.cli import main as jmain

    args = ["--renderer", "stroke", "--hard", "--envs", "--train", "2",
            "--val", "1", "--test", "1", "--seed", "3"]
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert main(["make-corpus", "--data-root", a, *args]) == 0
    assert jmain(["make-corpus", "--data-root", b, *args]) == 0
    for split in ("train", "validate", "test"):
        rows = []
        for root in (a, b):
            with open(os.path.join(root, f"{split}_labels.csv"),
                      newline="") as f:
                rows.append(list(csv.reader(f)))
        assert rows[0] == rows[1] and len(rows[0]) > 1
        for name, _ in rows[0][1:]:
            np.testing.assert_array_equal(*(
                cv2.imread(os.path.join(root, f"{split}_formulas", name),
                           cv2.IMREAD_UNCHANGED) for root in (a, b)))
