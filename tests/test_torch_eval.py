"""The port's test-split evaluation against the JAX package's.

``data/png.py`` and ``data/preprocess.py::load_image_png`` (the PNG reader
against PIL and cv2 on the 2,000 ``data_eval_hard`` test images and on
synthesized PNGs of every filter type; the refusals), ``data/dataset.py``
(the CSV rows against pandas', the batches against JAX's
``get_test_loader``), ``eval/metrics.py``, ``eval/latex_check.py`` and
``eval/calibration.py`` against JAX's on the labels and on perturbed
predictions, and ``eval/harness.py`` (``evaluate_model``, ``save_results``)
against JAX's on a small random-weight model that the JAX package saves and
the port's reader reads back; ``slow``: the shipped weights.
"""

import dataclasses
import hashlib
import json
import os
import struct
import zlib

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import jax

from handwritten_math_ocr_api_tpu.core import config as jconfig
from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.data import dataset as jdataset
from handwritten_math_ocr_api_tpu.data import preprocess as jpre
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.eval import calibration as jcal
from handwritten_math_ocr_api_tpu.eval import harness as jharness
from handwritten_math_ocr_api_tpu.eval import latex_check as jlatex
from handwritten_math_ocr_api_tpu.eval import metrics as jmetrics
from handwritten_math_ocr_api_tpu.models.model import init_model
from handwritten_math_ocr_api_tpu.train import checkpoint as jckpt

from handwritten_math_ocr_api_torch.core import config as tconfig
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer, load_vocab
from handwritten_math_ocr_api_torch.data import dataset as tdataset
from handwritten_math_ocr_api_torch.data import png
from handwritten_math_ocr_api_torch.data import preprocess as tpre
from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
from handwritten_math_ocr_api_torch.eval import calibration as tcal
from handwritten_math_ocr_api_torch.eval import harness as tharness
from handwritten_math_ocr_api_torch.eval import latex_check as tlatex
from handwritten_math_ocr_api_torch.eval import metrics as tmetrics
from handwritten_math_ocr_api_torch.train import checkpoint as tckpt

from test_torch_fused import _j, jitter
import torch_threads  # noqa: F401  (one CPU thread: see the module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "serving_model_r4")
EVAL = os.path.join(REPO, "data_eval_hard")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_r4_quality.json")
CORPORA = [os.path.join(REPO, d, f"{s}_labels.csv")
           for d in ("data_eval_hard", "data_calib_hard")
           for s in ("train", "validate", "test")]
# float32 confidences, port against JAX: exp of a mean of up to 20
# log-probs whose sums differ in summation order only
CONF_TOL = 1e-5


def _test_paths():
    rows = tdataset.read_labels(os.path.join(EVAL, "test_labels.csv"))
    return [os.path.join(EVAL, "test_formulas", name) for name, _ in rows]


def _labels():
    return [label for _, label in
            tdataset.read_labels(os.path.join(EVAL, "test_labels.csv"))]


# -- PNG -----------------------------------------------------------------------

def test_png_reader_matches_pil_and_cv2_on_the_test_split():
    paths = _test_paths()
    assert len(paths) == 2000
    got = png.read_png_batch(paths)
    pil = np.stack([np.asarray(Image.open(p).convert("L")) for p in paths])
    np.testing.assert_array_equal(got, pil)
    for i in range(0, 2000, 97):
        np.testing.assert_array_equal(tpre.load_image_png(paths[i]),
                                      jpre.load_image_cv2(paths[i]))
        np.testing.assert_array_equal(png.read_png(paths[i]), got[i])
    with open(FIXTURE) as f:
        fixture = json.load(f)
    assert fixture["images_shape"] == list(got.shape)
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        fixture["images_sha256"]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _filtered(img: np.ndarray, kinds) -> bytes:
    """Rows of an 8-bit grayscale image, each filtered by its type."""
    out, prev = [], np.zeros(img.shape[1], np.int16)
    for r, row in enumerate(img.astype(np.int16)):
        kind = kinds[r % len(kinds)]
        a = np.concatenate([[0], row[:-1]])
        c = np.concatenate([[0], prev[:-1]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png(img, kinds=(1,), idat_parts=3, depth=8, colour=0, interlace=0,
         extra=b""):
    h, w = img.shape
    data = zlib.compress(_filtered(img, kinds))
    cuts = np.linspace(0, len(data), idat_parts + 1).astype(int)
    idat = b"".join(_chunk(b"IDAT", data[a:b])
                    for a, b in zip(cuts[:-1], cuts[1:]))
    head = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", head) + extra
            + _chunk(b"tEXt", b"Comment\0synthesized") + idat
            + _chunk(b"IEND", b""))


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(-9, 10, (h, w)), axis=1) + 128
    return np.clip(smooth, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("shape", [(7, 13), (96, 320)])
def test_synthesized_png_matches_pil(kinds, shape):
    """Each filter type (and all five row by row), IDAT split in three,
    equal to PIL."""
    import io

    img = _image(*shape, seed=sum(kinds) + shape[0])
    data = _png(img, kinds)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_png_batch_with_a_filter_per_image():
    """decode_png_batch unfilters one row of all images at once, grouped
    by filter type."""
    imgs = [_image(9, 17, seed=s) for s in range(10)]
    blobs = [_png(img, (s % 5, (s + 2) % 5), idat_parts=1 + s % 3)
             for s, img in enumerate(imgs)]
    np.testing.assert_array_equal(png.decode_png_batch(blobs),
                                  np.stack(imgs))


@pytest.mark.parametrize("kw, cause", [
    ({"depth": 16}, "bit depth 16"),
    ({"colour": 2}, "colour type 2"),
    ({"colour": 4}, "colour type 4"),
    ({"interlace": 1}, "interlace method 1"),
    ({"extra": _chunk(b"PLTE", bytes(range(6)))}, "palette"),
    ({"extra": _chunk(b"ABCD", b"")}, "critical chunk"),
])
def test_png_refusals(kw, cause):
    with pytest.raises(ValueError, match=cause):
        png.decode_png(_png(_image(4, 6, 0), **kw))


def test_png_corruption_refused():
    data = bytearray(_png(_image(4, 6, 0)))
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + bytes(data[6:]))
    data[40] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(bytes(_png(_image(4, 6, 0))[:-20]))
    bad = _filtered(_image(2, 3, 0), (1,))
    bad = bytes([7]) + bad[1:]
    blob = (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 3, 2, 8,
                                                         0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bad)) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter type 7"):
        png.decode_png(blob)
    with pytest.raises(ValueError, match="different sizes"):
        png.decode_png_batch([_png(_image(4, 6, 0)), _png(_image(5, 6, 0))])


def test_load_image_png_and_preprocess_file(tmp_path):
    path = _test_paths()[3]
    cfg = tconfig.ModelConfig()
    np.testing.assert_array_equal(
        tpre.preprocess_file(path, cfg),
        jpre.preprocess_file(path, jconfig.ModelConfig()))
    # an image not at the model's size: cv2's stretch resize, as JAX's
    # loader resizes it
    other = str(tmp_path / "small.png")
    with open(other, "wb") as f:
        f.write(_png(_image(48, 160, 1)))
    np.testing.assert_array_equal(tpre.load_image_png(other),
                                  jpre.load_image_cv2(other))
    np.testing.assert_array_equal(
        tpre.preprocess_file(other, cfg),
        jpre.preprocess_file(other, jconfig.ModelConfig()))


# -- metrics, LaTeX checks, calibration ---------------------------------------

def _perturbed(labels, seed):
    """Predictions a decoder might emit: labels with a token dropped,
    doubled, swapped or a brace flipped, or unchanged."""
    rng = np.random.default_rng(seed)
    out = []
    for label in labels:
        toks = label.split()
        k = int(rng.integers(0, 6))
        i = int(rng.integers(0, max(len(toks), 1)))
        if toks and k == 1:
            del toks[i]
        elif toks and k == 2:
            toks.insert(i, toks[i])
        elif len(toks) > 1 and k == 3:
            j = int(rng.integers(0, len(toks)))
            toks[i], toks[j] = toks[j], toks[i]
        elif k == 4:
            toks = [{"{": "}", "}": "{"}.get(t, t) if n == i else t
                    for n, t in enumerate(toks)]
        elif k == 5:
            toks = toks[:i]
        out.append(" ".join(toks))
    return out


def test_metrics_match_jax_on_the_labels():
    labels = _labels()
    preds = _perturbed(labels, 0)
    got = tmetrics.compute_metrics(preds, labels)
    want = jmetrics.compute_metrics(preds, labels)
    assert got == want
    assert tmetrics.compute_metrics(labels, labels) == \
        jmetrics.compute_metrics(labels, labels)
    assert tmetrics.compute_metrics([], []) == jmetrics.compute_metrics([],
                                                                        [])
    assert tmetrics.corpus_cer(preds, labels) == \
        jmetrics.corpus_cer(preds, labels)
    assert got["bleu"] > 0.5  # nltk imports here


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet="ab{}\\ _^x", max_size=24),
       st.text(alphabet="ab{}\\ _^x", max_size=24))
def test_edit_distance_and_cer_match_jax(a, b):
    assert tmetrics.edit_distance(a, b) == jmetrics.edit_distance(a, b)
    assert tmetrics.cer(a, b) == jmetrics.cer(a, b)
    assert tmetrics.exact_match(a, b) == jmetrics.exact_match(a, b)
    assert tmetrics.batch_edit_distance([a, b], [b, a]) == \
        jmetrics.batch_edit_distance([a, b], [b, a])


def test_latex_check_matches_jax_on_the_labels():
    labels = _labels()
    for formulas in (labels, _perturbed(labels, 1), _perturbed(labels, 2)):
        for f in formulas:
            assert tlatex.check_latex(f) == jlatex.check_latex(f), f
        assert tlatex.validity_fraction(formulas) == \
            jlatex.validity_fraction(formulas)
        assert tlatex.summarize_errors(formulas) == \
            jlatex.summarize_errors(formulas)
    assert tlatex._ARG_COMMANDS == jlatex._ARG_COMMANDS


_LATEX_TOKENS = ["{", "}", "^", "_", "x", "2", "\\frac", "\\sqrt",
                 "\\left", "\\right", "(", ")", "\\begin", "\\end",
                 "matrix", "\\binom"]


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(_LATEX_TOKENS), max_size=16))
def test_latex_check_matches_jax_on_token_strings(toks):
    f = " ".join(toks)
    assert tlatex.check_latex(f) == jlatex.check_latex(f)


@pytest.mark.parametrize("n, seed", [(1, 0), (40, 1), (2000, 2)])
def test_calibration_matches_jax(n, seed):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0, 1, n)
    conf[: n // 10] = np.round(conf[: n // 10], 1)  # ties and bin edges
    correct = rng.uniform(0, 1, n) < conf
    assert tcal.reliability_table(conf, correct) == \
        jcal.reliability_table(conf, correct)
    assert tcal.expected_calibration_error(conf, correct, 7) == \
        jcal.expected_calibration_error(conf, correct, 7)
    for method in ("platt", "isotonic"):
        got = tcal.fit(conf, correct, method)
        assert got == jcal.fit(conf, correct, method)
        probe = np.linspace(0, 1, 23)
        np.testing.assert_array_equal(tcal.apply(got, probe),
                                      jcal.apply(got, probe))
        assert tcal.apply(got, 0.3) == jcal.apply(got, 0.3)
    with pytest.raises(ValueError):
        tcal.fit(conf, correct, "beta")


def test_calibration_artifact_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    conf = rng.uniform(0, 1, 50)
    art = tcal.fit(conf, conf > 0.5, "isotonic")
    path = str(tmp_path / "calibration.json")
    tcal.save(art, path)
    assert tcal.load(path) == jcal.load(path) == json.loads(json.dumps(art))
    assert tcal.load(str(tmp_path / "missing.json")) is None


# -- dataset and loader ---------------------------------------------------------

@pytest.mark.parametrize("path", CORPORA, ids=lambda p: os.path.relpath(p,
                                                                        REPO))
def test_csv_rows_match_pandas(path):
    df = pd.read_csv(path)
    want = [(str(df.iloc[i, 0]), str(df.iloc[i, 1])) for i in range(len(df))]
    assert tdataset.read_labels(path) == want


def test_data_config_matches_jax():
    got = dataclasses.asdict(tconfig.DataConfig())
    want = dataclasses.asdict(jconfig.DataConfig())
    assert got == want
    cfg = tconfig.DataConfig(data_root="root")
    assert cfg.img_dir("test") == jconfig.DataConfig(
        data_root="root").img_dir("test")
    assert cfg.label_path("test") == os.path.join("root", "test_labels.csv")


def _tokenizers():
    vocab, idx2char = load_vocab(os.path.join(MODEL_DIR, "vocab.json"))
    return Tokenizer(vocab, idx2char), JTokenizer(vocab, idx2char)


def _same_batches(got, want):
    """Both loaders' batches equal; returns the port's."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    return got


def test_test_loader_batches_match_jax():
    """All 32 batches of the test split at 64 (the last one 16 images,
    padded by row 0, ``valid`` false there)."""
    tok, jtok = _tokenizers()
    got = tdataset.get_test_loader(
        tok, tconfig.DataConfig(data_root=EVAL, batch_size=64),
        tconfig.ModelConfig())
    want = jdataset.get_test_loader(
        jtok, jconfig.DataConfig(data_root=EVAL, batch_size=64),
        jconfig.ModelConfig())
    assert len(got) == len(want) == 32
    batches = _same_batches(got, want)
    assert len(batches) == 32
    last = batches[-1]
    assert last["valid"].sum() == 16 and last["length"][16:].sum() == 0
    np.testing.assert_array_equal(last["image"][16:], np.broadcast_to(
        last["image"][:1], (48, 96, 320, 1)))


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_small_split_batches_match_jax(batch):
    tok, jtok = _tokenizers()
    root = os.path.join(REPO, "data_calib_hard")
    got = tdataset.DataLoader(tdataset.MathFormulaDataset(
        os.path.join(root, "train_formulas"),
        os.path.join(root, "train_labels.csv"), tok, max_seq_len=40), batch)
    want = jdataset.DataLoader(jdataset.MathFormulaDataset(
        os.path.join(root, "train_formulas"),
        os.path.join(root, "train_labels.csv"), jtok, max_seq_len=40), batch,
        num_workers=2)
    assert len(_same_batches(got, want)) == -(-4 // batch)


def test_loader_raises_a_decode_error(tmp_path):
    """A broken image stops the iteration with the reader's error; images
    of other sizes are stretch-resized, as JAX's loader does, alone or
    beside one at the model's size (the batch read falls back to one
    image at a time); a CSV without the header is refused."""
    (tmp_path / "test_formulas").mkdir()
    (tmp_path / "test_formulas" / "a.png").write_bytes(b"not a png")
    (tmp_path / "test_labels.csv").write_text(
        "image_filename,latex_label\na.png,x\n")
    tok, _ = _tokenizers()
    loader = tdataset.get_test_loader(
        tok, tconfig.DataConfig(data_root=str(tmp_path)),
        tconfig.ModelConfig())
    with pytest.raises(ValueError, match="signature"):
        list(loader)
    (tmp_path / "test_formulas" / "a.png").write_bytes(_png(_image(48, 160,
                                                                   2)))
    jtok = _tokenizers()[1]

    def loaders():
        return (tdataset.get_test_loader(
                    tok, tconfig.DataConfig(data_root=str(tmp_path)),
                    tconfig.ModelConfig()),
                jdataset.get_test_loader(
                    jtok, jconfig.DataConfig(data_root=str(tmp_path)),
                    jconfig.ModelConfig()))

    _same_batches(*loaders())
    (tmp_path / "test_formulas" / "b.png").write_bytes(_png(_image(96, 320,
                                                                   3)))
    (tmp_path / "test_formulas" / "c.png").write_bytes(_png(_image(130, 400,
                                                                   4)))
    (tmp_path / "test_labels.csv").write_text(
        "image_filename,latex_label\na.png,x\nb.png,y\nc.png,z\n")
    assert len(_same_batches(*loaders())) == 1
    (tmp_path / "test_labels.csv").write_text("name,label\na.png,x\n")
    with pytest.raises(ValueError, match="header"):
        tdataset.read_labels(str(tmp_path / "test_labels.csv"))


# -- the harness ----------------------------------------------------------------

SMALL = tconfig.ModelConfig(
    d_model=32, nhead=4, dim_feedforward=64, dropout=0.0,
    num_decoder_layers=2, vocab_size=138, dtype="float32",
    swin=tconfig.SwinConfig(embed_dim=8, depths=(1, 1), num_heads=(2, 2),
                            window_size=4, stochastic_depth=0.0))
N_EVAL = 24
EVAL_BATCH = 16
DECODE_LEN = 20
# the end-of-sequence logit's bias raised so that rows end at different
# steps within DECODE_LEN (after 5 to 20 steps, greedy and beam 3)
EOS_BOOST = 0.8


@pytest.fixture(scope="module")
def small_artifact(tmp_path_factory):
    """A random-weight 96x320 two-stage Swin model saved by the JAX
    package with the shipped vocabulary."""
    from test_torch_models import jax_config

    jcfg = jax_config(SMALL)
    params, _ = init_model(jax.random.PRNGKey(5), jcfg)
    tree = jitter(params, seed=6)
    tree["decoder"]["fc_out"]["b"][tconfig.EOS_ID] += EOS_BOOST
    vocab, _ = load_vocab(os.path.join(MODEL_DIR, "vocab.json"))
    path = str(tmp_path_factory.mktemp("small") / "artifact")
    jckpt.save_params_for_serving(path, _j(tree), vocab, jcfg)
    return path


def _both_results(artifact, n, batch, beam_size=None, decode_len=None):
    """(port, JAX) evaluate_model results on the first ``n`` test images:
    the port on the CPU with the weights its reader reads, JAX with its
    loader's."""
    params, _, vocab, idx2char, cfg = tckpt.load_params_for_serving(artifact)
    jparams, jstate, _, _, jcfg = jckpt.load_params_for_serving(artifact)
    cfg, jcfg = cfg.replace(dtype="float32"), jcfg.replace(dtype="float32")
    tok, jtok = Tokenizer(vocab, idx2char), JTokenizer(vocab, idx2char)
    dcfg = (tconfig.DecodeConfig(max_seq_len=decode_len) if decode_len
            else None)
    jdcfg = (jconfig.DecodeConfig(max_seq_len=decode_len) if decode_len
             else None)
    engine = DecodeEngine(params, cfg, dcfg, tok, device="cpu")
    jengine = JEngine(jparams, jstate, jcfg, jdcfg, jtok)
    loader = tdataset.get_test_loader(
        tok, tconfig.DataConfig(data_root=EVAL, batch_size=batch), cfg)
    loader.dataset.rows = loader.dataset.rows[:n]
    jloader = jdataset.get_test_loader(
        jtok, jconfig.DataConfig(data_root=EVAL, batch_size=batch), jcfg)
    jloader.dataset.df = jloader.dataset.df.iloc[:n]
    return (tharness.evaluate_model(engine, loader, tok, beam_size),
            jharness.evaluate_model(jengine, jloader, jtok, beam_size))


def _same_results(got, want, n):
    assert len(got["records"]) == len(want["records"]) == n
    for g, w in zip(got["records"], want["records"]):
        assert g.keys() == w.keys()
        for k in w:
            if k == "confidence" and w[k] is not None:
                assert abs(g[k] - w[k]) <= CONF_TOL, (g, w)
            else:
                assert g[k] == w[k], (k, g, w)
    gs, ws = got["summary"], want["summary"]
    assert gs.keys() == ws.keys()
    for k in ws:
        if k in ("elapsed_sec", "images_per_sec"):
            continue
        if k in ("mean_confidence", "ece"):
            assert abs(gs[k] - ws[k]) <= CONF_TOL, k
        else:
            assert gs[k] == ws[k], k


@pytest.mark.parametrize("beam_size", [None, 3])
def test_evaluate_model_matches_jax(small_artifact, beam_size):
    """24 images at batch 16 (the second batch half padding), greedy and
    beam 3, float32: equal records and summary, confidences within
    CONF_TOL."""
    got, want = _both_results(small_artifact, N_EVAL, EVAL_BATCH, beam_size,
                              DECODE_LEN)
    _same_results(got, want, N_EVAL)
    lengths = {len(r["prediction"].split()) for r in got["records"]}
    assert len(lengths) >= 3  # rows end at different steps
    assert got["summary"]["decode"] == ("greedy" if beam_size is None
                                        else "beam-3")


def test_save_results_matches_jax(small_artifact, tmp_path):
    got, want = _both_results(small_artifact, 8, 8)
    tharness.save_results(got, str(tmp_path / "port"))
    jharness.save_results(got, str(tmp_path / "jax"))
    pd.testing.assert_frame_equal(
        pd.read_csv(tmp_path / "port" / "test_results.csv"),
        pd.read_csv(tmp_path / "jax" / "test_results.csv"))
    ours = (tmp_path / "port" / "summary.txt").read_text()
    theirs = (tmp_path / "jax" / "summary.txt").read_text()
    assert ours == theirs and "ECE (10 bins)" in ours


@pytest.mark.slow
def test_shipped_weights_harness_matches_jax():
    """serving_model_r4 on the first 32 test images, float32, both
    harnesses: identical records (confidences within CONF_TOL)."""
    got, want = _both_results(MODEL_DIR, 32, 16)
    _same_results(got, want, 32)
