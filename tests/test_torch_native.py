"""The port's host C++ library (``native/``) against its Python versions and
the JAX package's native library.

The library builds from the port's own sources into the package's
``.kernel_build/``; every entry (version, edit distance single and
batched, the token scanner, batch assembly, the glyph registry and the
formula render) equals its Python version where the port has one and the
JAX package's library always; the native stroke render
(``render_stroke_image_native``) is bit-equal to JAX's for the same seeds,
and JAX's ``tests/test_native_render.py`` cases hold on the port; the
metrics' hooks give the same results with and without the library; and
``native=True`` raises where the library cannot be built (JAX falls back
to Python there).
"""

import random

import numpy as np
import pytest

from handwritten_math_ocr_api_tpu import native as jnative
from handwritten_math_ocr_api_tpu.data import strokes as jst

from handwritten_math_ocr_api_torch import native
from handwritten_math_ocr_api_torch.core import tokenizer as ttok
from handwritten_math_ocr_api_torch.data import strokes as tst
from handwritten_math_ocr_api_torch.data.synthetic import structured_formula
from handwritten_math_ocr_api_torch.eval import metrics as tmetrics

import torch_threads  # noqa: F401  (one CPU thread: see the module)

FORMULAS = [
    r"x ^ { 2 } + \frac { a } { b }",
    r"\sum _ { i = 1 } ^ { n } \sqrt { x _ { i } }",
    r"\lim _ { x \to \infty } \sin ( y ) - \alpha",
    r"\begin { pmatrix } a & b \ \ c & d \end { pmatrix }",
]


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.available():
        from handwritten_math_ocr_api_tpu.native.build import build

        build(quiet=True)
    assert jnative.available()
    return jnative


@pytest.fixture
def without_library(monkeypatch):
    """The port as on a host where the library cannot be built."""
    def fail():
        raise RuntimeError("g++ not found: the native library cannot build")

    monkeypatch.setattr(native, "library", fail)
    monkeypatch.setattr(native, "available", lambda: False)


def test_library_builds_from_the_port_sources():
    import os

    assert native.available()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.sep + "handwritten_math_ocr_api_torch" + os.sep in path
    assert ".kernel_build" in path and native.build() == path


def test_version(jax_native):
    assert native.version() == jax_native.version()
    assert "mathocr-native" in native.version()


def test_edit_distance_parity(jax_native):
    cases = [("", ""), ("a", ""), ("kitten", "sitting"),
             ("\\frac{x}{2}", "\\frac{y}{2}"), ("αβγ", "αγ")]
    for a, b in cases:
        want = tmetrics._levenshtein_py(a, b)
        assert native.edit_distance(a, b) == want == jax_native.edit_distance(
            a, b)


def test_edit_distance_batch_parity(jax_native):
    rng = random.Random(0)
    alphabet = "ab\\{}^_0123456789 αβ"
    preds = ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
             for _ in range(50)]
    tgts = ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
            for _ in range(50)]
    got = native.edit_distance_batch(preds, tgts)
    want = [tmetrics._levenshtein_py(a, b) for a, b in zip(preds, tgts)]
    assert list(got) == want
    assert list(jax_native.edit_distance_batch(preds, tgts)) == want
    assert list(native.edit_distance_batch([], [])) == []


def test_tokenize_parity(jax_native):
    cases = [r"\frac{x^2}{2}", "123 + abc", r"\alpha_1^{23}",
             r"a \% b & c # d $ e", r"\begin{matrix} x \\ y \end{matrix}",
             "x±y × ∫ f", "", "   ", r"\\"]
    rng = random.Random(1)
    alphabet = r"ab9\frac{}^_ $%&#+-=×α "
    cases += ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 60)))
              for _ in range(200)]
    for s in cases:
        want = ttok.tokenize_latex(s)
        assert native.tokenize(s) == want == jax_native.tokenize(s), repr(s)


def test_assemble_batch(jax_native):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (96, 320), np.uint8) for _ in range(7)]
    out = native.assemble_batch(imgs)
    assert out.shape == (7, 96, 320, 1) and out.dtype == np.uint8
    np.testing.assert_array_equal(out[..., 0], np.stack(imgs))
    np.testing.assert_array_equal(out, jax_native.assemble_batch(imgs))
    with pytest.raises(ValueError, match="shape"):
        native.assemble_batch([imgs[0], imgs[1][:, :10]])


def test_register_glyphs_matches_jax(jax_native):
    """The port's registry of the templates (flattened as JAX flattens
    them) holds every glyph, as JAX's does."""
    ids = tst._ensure_native_glyphs()
    jst._ensure_native_glyphs()
    assert ids == jst._NATIVE_GLYPH_IDS
    assert native.library().mathocr_num_glyphs() == len(tst.GLYPHS) == \
        jax_native._load().mathocr_num_glyphs()


@pytest.mark.parametrize("degrade", [0.0, 0.6])
@pytest.mark.parametrize("f", FORMULAS)
def test_native_render_matches_jax_native(f, degrade, jax_native):
    """The port's native render equals JAX's native render bit for bit,
    for the same seeds, at two canvases."""
    for seed, hw in ((3, (96, 320)), (8, (32, 96))):
        got = tst.render_stroke_image_native(
            f, np.random.default_rng(seed), *hw, degrade=degrade)
        want = jst.render_stroke_image_native(
            f, np.random.default_rng(seed), *hw, degrade=degrade)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_native_render_rich_samples_match_jax():
    rng = random.Random(0)
    fs = [structured_formula(rng, 8, 3, rich=True, envs=True)
          for _ in range(16)]
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for f in fs:
        np.testing.assert_array_equal(
            tst.render_stroke_image_native(f, a, 96, 320, degrade=0.6),
            jst.render_stroke_image_native(f, b, 96, 320, degrade=0.6))


# -- JAX's tests/test_native_render.py cases on the port ------------------------


def _ink_stats(img):
    ink = img < 100
    ys, xs = np.where(ink)
    if len(ys) == 0:
        return 0.0, (0, 0)
    return float(ink.mean()), (int(ys.max() - ys.min()),
                               int(xs.max() - xs.min()))


@pytest.mark.parametrize("f", FORMULAS)
def test_native_matches_python_geometry(f):
    a = tst.render_stroke_image(f, np.random.default_rng(3), 96, 320)
    b = tst.render_stroke_image_native(f, np.random.default_rng(3), 96, 320)
    fa, (ha, wa) = _ink_stats(a)
    fb, (hb, wb) = _ink_stats(b)
    assert fa > 0 and fb > 0
    assert 0.5 < fa / fb < 2.0, (fa, fb)
    assert abs(ha - hb) <= 12 and abs(wa - wb) <= 20, ((ha, wa), (hb, wb))


def test_native_overlap_same_seed():
    f = FORMULAS[0]
    a = tst.render_stroke_image(f, np.random.default_rng(11), 96, 320,
                                jitter=0.4)
    b = tst.render_stroke_image_native(f, np.random.default_rng(11), 96, 320,
                                       jitter=0.4)

    def dilate(m, r=2):
        out = m.copy()
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                out |= np.roll(np.roll(m, dy, 0), dx, 1)
        return out

    ia, ib = a < 100, b < 100
    assert (ia & dilate(ib)).sum() / max(ia.sum(), 1) > 0.7
    assert (ib & dilate(ia)).sum() / max(ib.sum(), 1) > 0.7


def test_native_deterministic():
    f = FORMULAS[1]
    np.testing.assert_array_equal(
        tst.render_stroke_image_native(f, np.random.default_rng(5),
                                       degrade=0.6),
        tst.render_stroke_image_native(f, np.random.default_rng(5),
                                       degrade=0.6))


def test_native_degrade_distribution():
    rng = random.Random(0)
    fs = [structured_formula(rng, 8, 3, rich=True, envs=True)
          for _ in range(40)]
    fs = [f for f in fs if len(f.split()) <= 60][:25]
    nrng = np.random.default_rng(9)
    fracs = []
    for f in fs:
        img = tst.render_stroke_image_native(f, nrng, 96, 320, degrade=0.6)
        assert img.shape == (96, 320) and img.dtype == np.uint8
        fracs.append((img < 128).mean())
    assert 0.005 < np.mean(fracs) < 0.5


def test_native_empty_formula_blank():
    img = tst.render_stroke_image_native("", np.random.default_rng(1))
    assert img.shape == (96, 320)
    assert (img > 150).mean() > 0.9


def test_stream_dataset_native_flag():
    """The native stream's items equal JAX's native stream's."""
    vocab = tst.stroke_vocab(rich=True)
    kw = dict(seed=3, rich=True, max_terms=8, depth=3, max_tokens=60,
              degrade=0.6, native=True)
    ours = tst.StrokeStreamDataset(ttok.Tokenizer(vocab), 8, 96, 320, 64,
                                   **kw)
    from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer

    theirs = jst.StrokeStreamDataset(Tokenizer(vocab), 8, 96, 320, 64, **kw)
    for i in range(3):
        img, ids, length = ours[i]
        assert img.shape == (96, 320) and img.dtype == np.uint8
        assert (img < 128).any()
        want = theirs[i]
        np.testing.assert_array_equal(img, want[0])
        np.testing.assert_array_equal(ids, want[1])
        assert length == want[2]


def test_native_faster_than_python():
    """The point of the backend, with JAX's generous 2x bound."""
    import time

    rng = random.Random(2)
    fs = [structured_formula(rng, 8, 3, rich=True) for _ in range(60)]
    fs = [f for f in fs if len(f.split()) <= 60][:30]
    nrng = np.random.default_rng(1)
    tst.render_stroke_image_native(fs[0], nrng)
    t0 = time.perf_counter()
    for f in fs:
        tst.render_stroke_image(f, nrng, 96, 320, degrade=0.6)
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    for f in fs:
        tst.render_stroke_image_native(f, nrng, 96, 320, degrade=0.6)
    assert time.perf_counter() - t0 < t_py / 2.0


# -- the hooks, and the refusal --------------------------------------------------


def _corpus(n, seed):
    rng = random.Random(seed)
    return [structured_formula(rng, 8, 3, rich=True, envs=True) + " ±∫"
            for _ in range(n)]


def test_hooks_equal_with_and_without_library(monkeypatch):
    """The metrics give the same results on the library and on their
    Python versions."""
    formulas = _corpus(60, 4)
    preds = [f[::-1] if i % 3 else f for i, f in enumerate(formulas)]

    def run():
        return (tmetrics.batch_edit_distance(preds, formulas),
                tmetrics.corpus_cer(preds, formulas),
                tmetrics.edit_distance(preds[1], formulas[1]))

    with_lib = run()
    assert native.available()
    monkeypatch.setattr(native, "available", lambda: False)
    assert run() == with_lib


def test_native_render_raises_without_the_library(without_library):
    """A deliberate difference: JAX renders with Python where its library
    is missing; the port's ``render_stroke_image_native`` and a native
    stream raise."""
    with pytest.raises(RuntimeError, match="cannot build"):
        tst.render_stroke_image_native(FORMULAS[0], np.random.default_rng(0))
    ds = tst.StrokeStreamDataset(ttok.Tokenizer(tst.stroke_vocab()), 2,
                                 native=True)
    with pytest.raises(RuntimeError, match="cannot build"):
        ds[0]
