"""InkML parsing and rasterization (``data/inkml.py``), the CLI's
``render-inkml``, and the cv2 drawing and resizing of the port's data path,
against the JAX package.

``parse_inkml``'s strokes and labels, ``rasterize``'s uint8 images
(anti-aliased polylines, a one-point stroke drawn as a circle, margins and
thicknesses), ``render_inkml_dir``'s PNGs and CSV and the CLI's output
equal JAX's, as does ``random_ink_image``'s cv2 polylines. Both packages
draw with the same cv2, so the images are held bit for bit.
"""

import csv
import os

import numpy as np
import pytest

from handwritten_math_ocr_api_tpu.data import inkml as jinkml
from handwritten_math_ocr_api_tpu.data import synthetic as jsyn

from handwritten_math_ocr_api_torch.data import inkml, synthetic

import torch_threads  # noqa: F401  (one CPU thread: see the module)

# a trace with timestamps, one with a single point, a label and a
# normalized label
TIMED_INKML = """<ink xmlns="http://www.w3.org/2003/InkML">
  <annotation type="label">\\frac{a}{b}</annotation>
  <annotation type="normalizedLabel">\\frac { a } { b }</annotation>
  <trace>10 10 0.0, 14 12 0.1, 20 18 0.2, 31 19 0.3</trace>
  <trace>12 40 0.5</trace>
  <trace>5 30, 60 30.5, </trace>
  <trace>18 50 1.0, 22 62 1.1, 28 70 1.2</trace>
</ink>"""

INKS = {"sample": synthetic.SAMPLE_INKML, "timed": TIMED_INKML}


def _rows(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.reader(f))


def test_inkml_parse_and_rasterize():
    """JAX's case on the port: labels, strokes, ink inside white margins."""
    ink = inkml.parse_inkml(synthetic.SAMPLE_INKML)
    assert ink.best_label == "x ^ { 2 }"
    assert len(ink.strokes) == 2
    assert ink.strokes[0].shape == (4, 2)
    img = inkml.rasterize(ink, 96, 320)
    assert img.shape == (96, 320) and img.dtype == np.uint8
    assert (img < 250).any()
    assert img[0, 0] == 255


def test_inkml_empty_renders_blank():
    assert (inkml.rasterize(inkml.Ink(strokes=[]), 96, 320) == 255).all()


@pytest.mark.parametrize("name", list(INKS))
def test_parse_inkml_matches_jax(name, tmp_path):
    """From a string and from a file: the same labels and float32 strokes."""
    path = tmp_path / f"{name}.inkml"
    path.write_text(INKS[name])
    for src in (INKS[name], str(path)):
        got, want = inkml.parse_inkml(src), jinkml.parse_inkml(src)
        assert (got.label, got.normalized_label, got.best_label) == (
            want.label, want.normalized_label, want.best_label)
        assert len(got.strokes) == len(want.strokes)
        for a, b in zip(got.strokes, want.strokes):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(INKS))
@pytest.mark.parametrize("hw,margin,thickness", [
    ((96, 320), 4, 2), ((32, 96), 2, 1), ((64, 64), 9, 3)])
def test_rasterize_matches_jax(name, hw, margin, thickness):
    ink = inkml.parse_inkml(INKS[name])
    got = inkml.rasterize(ink, *hw, margin=margin, thickness=thickness)
    want = jinkml.rasterize(jinkml.parse_inkml(INKS[name]), *hw,
                            margin=margin, thickness=thickness)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _ink_dir(tmp_path):
    d = tmp_path / "ink"
    d.mkdir()
    for i, text in enumerate([synthetic.SAMPLE_INKML, TIMED_INKML] * 2):
        (d / f"s{i}.inkml").write_text(text)
    (d / "notes.txt").write_text("not an inkml file")
    return d


def _same_render(a_imgs, a_csv, b_imgs, b_csv):
    import cv2

    rows = _rows(a_csv)
    assert rows == _rows(b_csv)
    for name, _ in rows[1:]:
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(a_imgs, name), cv2.IMREAD_UNCHANGED),
            cv2.imread(os.path.join(b_imgs, name), cv2.IMREAD_UNCHANGED))
    return rows


@pytest.mark.parametrize("limit", [None, 3])
def test_render_inkml_dir_matches_jax(tmp_path, limit):
    """The PNGs and the CSV rows (which JAX writes with pandas) equal
    JAX's, in file order, ``limit`` included."""
    d = _ink_dir(tmp_path)
    a, b = tmp_path / "port", tmp_path / "jax"
    n = inkml.render_inkml_dir(str(d), str(a / "imgs"), str(a / "l.csv"),
                               limit=limit)
    assert n == jinkml.render_inkml_dir(str(d), str(b / "imgs"),
                                        str(b / "l.csv"), limit=limit)
    rows = _same_render(str(a / "imgs"), str(a / "l.csv"), str(b / "imgs"),
                        str(b / "l.csv"))
    assert rows[0] == ["image_filename", "latex_label"]
    assert len(rows) == n + 1 == (limit or 4) + 1


def test_render_inkml_cli_matches_jax(tmp_path):
    """``render-inkml`` through both CLIs: exit 0, the same files."""
    from handwritten_math_ocr_api_torch.cli import main
    from handwritten_math_ocr_api_tpu.cli import main as jmain

    d = _ink_dir(tmp_path)
    for tag, fn in (("port", main), ("jax", jmain)):
        assert fn(["render-inkml", str(d), str(tmp_path / tag / "imgs"),
                   str(tmp_path / tag / "labels.csv")]) == 0
    rows = _same_render(str(tmp_path / "port" / "imgs"),
                        str(tmp_path / "port" / "labels.csv"),
                        str(tmp_path / "jax" / "imgs"),
                        str(tmp_path / "jax" / "labels.csv"))
    assert len(rows) == 5


@pytest.mark.parametrize("hw", [(96, 320), (32, 96)])
def test_random_ink_image_matches_jax(hw):
    """cv2's anti-aliased polylines from the same draws: JAX's pixels."""
    for seed in range(4):
        np.testing.assert_array_equal(
            synthetic.random_ink_image(np.random.default_rng(seed), *hw),
            jsyn.random_ink_image(np.random.default_rng(seed), *hw))
