"""Synthetic datasets for tests, training and CI.

The port of ``handwritten_math_ocr_api_tpu/data/synthetic.py``: the same
formula grammars and seeds, so the labels, the formula streams and the
text renders equal the JAX package's; the PNGs are written with PIL and the
CSVs with the ``csv`` module (the JAX module writes them with other
libraries; the files hold the same pixels and rows). ``random_ink_image``
draws cv2's anti-aliased polylines, as JAX's does, so its pixels equal the
JAX function's.

The real MathWriting corpus is not shipped; these fabricate datasets in
its contract (``{split}_formulas/*.png`` + ``{split}_labels.csv``), and
``SyntheticStreamDataset`` an endless stream of fresh formulas that the
training loader draws from.
"""

from __future__ import annotations

import csv
import logging
import os
import random
import threading
from typing import List

import numpy as np

log = logging.getLogger(__name__)

_ATOMS = list("abcxyz01259+-=") + [
    r"\frac", r"\sqrt", r"\alpha", r"\beta", r"\sum", r"\int", r"\pi",
    r"\cdot", r"\infty",
]


def random_formula(rng: random.Random, max_tokens: int = 12) -> str:
    n = rng.randint(1, max_tokens)
    parts: List[str] = []
    for _ in range(n):
        choice = rng.random()
        atom = rng.choice(_ATOMS)
        if choice < 0.15:
            parts.append(f"{atom} ^ {{ {rng.randint(0, 9)} }}")
        elif choice < 0.3:
            parts.append(f"{atom} _ {{ {rng.choice('abcxyz')} }}")
        elif choice < 0.4 and atom == r"\frac":
            parts.append(
                f"\\frac {{ {rng.choice('abc')} }} {{ {rng.randint(1, 9)} }}")
        else:
            parts.append(atom)
    return " ".join(parts)


def random_ink_image(rng: np.random.Generator, img_h: int,
                     img_w: int) -> np.ndarray:
    """Plausible-looking handwriting-ish strokes on white: each stroke a
    2-pixel anti-aliased cv2 polyline, as in JAX."""
    import cv2

    img = np.full((img_h, img_w), 255, np.uint8)
    n_strokes = int(rng.integers(3, 10))
    for _ in range(n_strokes):
        n_pts = int(rng.integers(3, 8))
        xs = rng.integers(4, img_w - 4, n_pts)
        ys = rng.integers(4, img_h - 4, n_pts)
        pts = np.stack([xs, ys], axis=1).astype(np.int32)
        cv2.polylines(img, [pts.reshape(-1, 1, 2)], False, 0, 2,
                      lineType=cv2.LINE_AA)
    return img


def _write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def _write_labels(path: str, rows) -> None:
    """The labels CSV, as a data frame's ``to_csv(index=False)`` writes
    it."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["image_filename", "latex_label"])
        w.writerows(rows)


def render_text_image(text: str, img_h: int = 96, img_w: int = 320
                      ) -> np.ndarray:
    """Render ``text`` with PIL's built-in bitmap font: black on white
    uint8 (H, W). Unlike ``random_ink_image`` the pixels *depict* the
    label, so models can genuinely learn image->text on synthetic data
    (used by the learnability test)."""
    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("L", (img_w, img_h), 255)
    draw = ImageDraw.Draw(img)
    font = ImageFont.load_default()
    draw.text((4, img_h // 2 - 5), text, fill=0, font=font)
    return np.asarray(img, np.uint8)


def make_learnable_dataset(root: str, splits=(("train", 16), ("validate", 8),
                                              ("test", 8)),
                           img_h: int = 96, img_w: int = 320,
                           seed: int = 0, n_distinct: int = 8) -> str:
    """Dataset whose images depict their labels (rendered text), drawn from
    ``n_distinct`` formulas — learnable by a tiny model in a few epochs."""
    prng = random.Random(seed)
    formulas = [random_formula(prng, max_tokens=4) for _ in range(n_distinct)]
    for split, count in splits:
        img_dir = os.path.join(root, f"{split}_formulas")
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i in range(count):
            formula = formulas[i % n_distinct]
            name = f"{split}_{i:05d}.png"
            _write_png(os.path.join(img_dir, name),
                       render_text_image(formula, img_h, img_w))
            rows.append((name, formula))
        _write_labels(os.path.join(root, f"{split}_labels.csv"), rows)
    return root


def make_synthetic_dataset(root: str, splits=(("train", 32), ("validate", 8),
                                              ("test", 8)),
                           img_h: int = 96, img_w: int = 320,
                           seed: int = 0) -> str:
    """Write {split}_formulas/*.png + {split}_labels.csv under ``root``."""
    prng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    for split, count in splits:
        img_dir = os.path.join(root, f"{split}_formulas")
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i in range(count):
            name = f"{split}_{i:05d}.png"
            _write_png(os.path.join(img_dir, name),
                       random_ink_image(nrng, img_h, img_w))
            rows.append((name, random_formula(prng)))
        _write_labels(os.path.join(root, f"{split}_labels.csv"), rows)
    return root


_RICH_ATOMS = (
    list("abcdefghknpqrstuvwxyz0123456789") +
    ["+", "-", "=", "(", ")", ",", "!", "|"] + [
        r"\alpha", r"\beta", r"\gamma", r"\theta", r"\lambda", r"\mu",
        r"\pi", r"\sigma", r"\phi", r"\omega", r"\sum", r"\int", r"\prod",
        r"\sin", r"\cos", r"\tan", r"\log", r"\cdot", r"\times", r"\pm",
        r"\leq", r"\geq", r"\neq", r"\to", r"\infty", r"\partial",
    ]
)


def rich_formula(rng: random.Random, max_len: int = 18,
                 depth: int = 2) -> str:
    """Structured random LaTeX with bounded nesting (frac/sqrt/sup/sub).

    Unlike :func:`random_formula` (flat, 24-symbol alphabet) this covers a
    realistic token inventory and nested groups, approximating MathWriting
    label statistics for production-scale training runs."""

    def expr(budget: int, d: int) -> List[str]:
        out: List[str] = []
        while budget > 0:
            r = rng.random()
            atom = rng.choice(_RICH_ATOMS)
            if r < 0.12 and d > 0 and budget >= 7:
                a = expr(rng.randint(1, 2), d - 1)
                b = expr(rng.randint(1, 2), d - 1)
                out += [r"\frac", "{", *a, "}", "{", *b, "}"]
                budget -= 5 + len(a) + len(b)
            elif r < 0.2 and d > 0 and budget >= 4:
                a = expr(rng.randint(1, 2), d - 1)
                out += [r"\sqrt", "{", *a, "}"]
                budget -= 3 + len(a)
            elif r < 0.32 and budget >= 4:
                op = "^" if r < 0.26 else "_"
                a = expr(1, 0)
                out += [atom, op, "{", *a, "}"]
                budget -= 4 + len(a)
            else:
                out.append(atom)
                budget -= 1
        return out

    return " ".join(expr(rng.randint(3, max_len), depth))


_VARS = list("abcdefghknpqrstuvwxyz") + [
    r"\alpha", r"\beta", r"\gamma", r"\theta", r"\lambda", r"\mu",
    r"\pi", r"\sigma", r"\phi", r"\omega",
]
_FUNCS = [r"\sin", r"\cos", r"\tan", r"\log"]
_BINOPS = ["+", "+", "+", "-", "-", "=", r"\cdot", r"\times", r"\pm",
           r"\leq", r"\geq", r"\neq", r"\to"]

# Extended ("rich") pools: calibrate the stand-in corpus toward
# MathWriting's symbol breadth (hundreds of glyphs across many writers)
# — uppercase latin, the rest of the
# lowercase greek alphabet plus capitals, set/relation operators, and
# structural forms (\prod, \lim, |...|, [...], primes) that the base
# grammar lacks. Used when ``structured_formula(..., rich=True)``.
_VARS_RICH = _VARS + list("ABCDEFGHJKLMNPQRSTUVWXYZ") + [
    r"\delta", r"\epsilon", r"\eta", r"\kappa", r"\nu", r"\rho",
    r"\tau", r"\chi", r"\psi", r"\xi", r"\zeta",
    r"\Delta", r"\Gamma", r"\Omega", r"\Phi", r"\Psi", r"\Theta",
    r"\Lambda", r"\Sigma", r"\Pi",
    r"\infty", r"\partial", r"\ell",
]
_FUNCS_RICH = _FUNCS + [r"\ln", r"\exp", r"\max", r"\min"]
_BINOPS_RICH = _BINOPS + [
    r"\div", r"\approx", r"\sim", r"\propto", r"\in", r"\subset",
    r"\cup", r"\cap", "<", ">", r"\equiv", r"\circ",
]


def structured_formula(rng: random.Random, max_terms: int = 5,
                       depth: int = 2, rich: bool = False,
                       envs: bool = False) -> str:
    """Sample from a small weighted grammar of realistic math expressions
    (polynomial terms, fractions, roots, trig, sums/integrals). Unlike
    :func:`rich_formula` (i.i.d. random tokens), productions share global
    statistics across samples, so a seq2seq model's language-model component
    *generalizes* between splits — mirroring real MathWriting label
    structure — and validation loss tracks train loss.

    ``rich``: the MathWriting-difficulty regime —
    extended symbol pools (uppercase latin, full greek, set/relation
    operators) and extra structural productions (\\prod, \\lim with a
    limit subscript, absolute-value bars, bracket groups, primes).
    Combine with larger ``max_terms``/``depth`` for longer formulas.

    ``envs``: additionally produce 2-D LaTeX environments
    (``\\begin{matrix|pmatrix|bmatrix|vmatrix|cases} … \\end{…}`` with
    ``&`` column and ``\\\\`` row separators) — the construct real
    MathWriting contains and the reference tokenizer explicitly handles
    (reference: src/utils.py:96-99, app/src/utils.py:22-27). Row breaks
    are emitted as two ``\\`` tokens, exactly what the reference token
    regex produces for a ``\\\\`` source, so label strings round-trip
    the tokenizer verbatim."""
    vars_, funcs, binops = ((_VARS_RICH, _FUNCS_RICH, _BINOPS_RICH)
                           if rich else (_VARS, _FUNCS, _BINOPS))

    def number() -> List[str]:
        return [str(rng.randint(0, 9)) for _ in range(
            1 if rng.random() < 0.8 else 2)]

    def var() -> List[str]:
        return [rng.choice(vars_)]

    def cell() -> List[str]:
        # tiny env-cell expressions: 1-4 tokens so a 2-D block stays
        # within the stream length cap
        r = rng.random()
        if r < 0.35:
            return var()
        if r < 0.55:
            return number()
        if r < 0.70:
            return [*var(), rng.choice(binops), *var()]
        if r < 0.85:
            return [*var(), "^", "{", str(rng.choice([2, 2, 3])), "}"]
        return ["-", *var()]

    def env_atom() -> List[str]:
        name = rng.choice(["matrix", "pmatrix", "bmatrix", "vmatrix",
                           "cases"])
        n_rows = rng.randint(2, 3)
        n_cols = 2 if name == "cases" else rng.randint(1, 3)
        out = [r"\begin", "{", name, "}"]
        for r_i in range(n_rows):
            if r_i:
                out += ["\\", "\\"]  # the token pair '\\' tokenizes to
            for c_i in range(n_cols):
                if c_i:
                    out.append("&")
                out += cell()
        out += [r"\end", "{", name, "}"]
        return out

    def atom(d: int) -> List[str]:
        r = rng.random()
        if envs and r >= 0.955 and d > 0:
            return env_atom()
        if r < 0.40:
            return var()
        if r < 0.55:
            return number()
        if r < 0.63 and d > 0:
            return [r"\frac", "{", *expr(1, d - 1), "}",
                    "{", *expr(1, d - 1), "}"]
        if r < 0.70 and d > 0:
            return [r"\sqrt", "{", *expr(1, d - 1), "}"]
        if r < 0.78:
            return [rng.choice(funcs), "(", *var(), ")"]
        if r < 0.84 and d > 0:
            op = r"\prod" if rich and rng.random() < 0.3 else r"\sum"
            return [op, "_", "{", *var(), "=", *number(), "}",
                    "^", "{", *number(), "}", *term(d - 1)]
        if r < 0.88 and d > 0:
            return [r"\int", *term(d - 1), *var()]
        if rich and r < 0.91 and d > 0:
            lim_to = [r"\infty"] if rng.random() < 0.5 else number()
            return [r"\lim", "_", "{", *var(), r"\to", *lim_to, "}",
                    *term(d - 1)]
        if rich and r < 0.94 and d > 0:
            return ["|", *expr(1, d - 1), "|"]
        if rich and r < 0.97 and d > 0:
            return ["[", *expr(2, d - 1), "]"]
        return var()

    def term(d: int) -> List[str]:
        base = atom(d)
        r = rng.random()
        if r < 0.25:  # power, mostly squares/cubes
            exp = str(rng.choice([2, 2, 2, 3, 3, rng.randint(4, 9)]))
            return [*base, "^", "{", exp, "}"]
        if r < 0.38:  # subscript index
            return [*base, "_", "{", *(var() if rng.random() < 0.6
                                       else number()), "}"]
        if r < 0.46:  # coefficient
            return [*number(), *base]
        if rich and r < 0.51:  # prime mark
            return [*base, "'"]
        return base

    def expr(n_terms: int, d: int) -> List[str]:
        out = term(d)
        for _ in range(n_terms - 1):
            out += [rng.choice(binops)] + term(d)
        return out

    return " ".join(expr(rng.randint(1, max_terms), depth))


_FONT_PATH: List = []
_FONT_LOCK = threading.Lock()


def _corpus_font(size: int):
    """The corpus font at ``size``: matplotlib's DejaVuSans when matplotlib
    imports, else PIL's default font (the choice logged once), as the JAX
    function looks it up."""
    from PIL import ImageFont

    with _FONT_LOCK:
        if not _FONT_PATH:
            try:
                import matplotlib
                path = os.path.join(os.path.dirname(matplotlib.__file__),
                                    "mpl-data", "fonts", "ttf",
                                    "DejaVuSans.ttf")
                ImageFont.truetype(path, size)
                log.info("corpus font: %s", path)
            except Exception:
                path = None
                log.warning("corpus font: matplotlib's DejaVuSans not "
                            "found; PIL's default font")
            _FONT_PATH.append(path)
    if _FONT_PATH[0] is None:
        return ImageFont.load_default()
    return ImageFont.truetype(_FONT_PATH[0], size)


def render_corpus_image(text: str, rng: np.random.Generator,
                        img_h: int = 96, img_w: int = 320) -> np.ndarray:
    """Render LaTeX source as jittered, noisy text: black-ish ink on
    white-ish paper, font size fitted to width. The pixels depict the label
    (real OCR task) while size/position/contrast/noise vary per sample, so
    a model must generalize over appearance, not memorize pixels."""
    from PIL import Image, ImageDraw

    size = int(rng.integers(18, 29))
    font = _corpus_font(size)
    probe = ImageDraw.Draw(Image.new("L", (8, 8)))
    while size > 9 and probe.textlength(text, font=font) > img_w - 10:
        size -= 2
        font = _corpus_font(size)

    bg = int(rng.integers(232, 256))
    ink = int(rng.integers(0, 45))
    img = Image.new("L", (img_w, img_h), bg)
    draw = ImageDraw.Draw(img)
    tw = draw.textlength(text, font=font)
    x = int(rng.integers(2, max(3, int(img_w - tw - 4))))
    y = int(img_h // 2 - size * 0.75 + rng.integers(-10, 11))
    y = max(2, min(img_h - size - 4, y))
    draw.text((x, y), text, fill=ink, font=font)

    arr = np.asarray(img, np.float32)
    arr += rng.normal(0.0, float(rng.uniform(1.0, 6.0)), arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8)


def make_corpus(root: str, n_train: int = 20000, n_val: int = 1000,
                n_test: int = 1000, img_h: int = 96, img_w: int = 320,
                seed: int = 0) -> str:
    """Production-scale learnable corpus: distinct formulas per split
    (test formulas unseen in training), written in the reference data
    contract ({split}_formulas/*.png + {split}_labels.csv)."""
    prng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    seen = set()

    def fresh_formula() -> str:
        while True:
            f = structured_formula(prng)
            # keep renders legible: very long sources would be shrunk below
            # glyph-recognizable size in the fixed-width image
            if len(f.split()) > 28 or f in seen:
                continue
            seen.add(f)
            return f

    for split, count in (("train", n_train), ("validate", n_val),
                         ("test", n_test)):
        img_dir = os.path.join(root, f"{split}_formulas")
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i in range(count):
            formula = fresh_formula()
            name = f"{split}_{i:06d}.png"
            _write_png(os.path.join(img_dir, name),
                       render_corpus_image(formula, nrng, img_h, img_w))
            rows.append((name, formula))
        _write_labels(os.path.join(root, f"{split}_labels.csv"), rows)
    return root


ENV_TOKENS = (r"\begin", r"\end", "&", "\\", "matrix", "pmatrix",
              "bmatrix", "vmatrix", "cases")


def grammar_vocab(rich: bool = False, envs: bool = False) -> dict:
    """Full token inventory of :func:`structured_formula`, in the
    tokenizer's vocab convention (specials first, then sorted tokens) —
    lets streaming training fix the vocab without a materialized corpus.
    ``rich``: the extended MathWriting-difficulty inventory. ``envs``:
    include the 2-D environment tokens (ENV_TOKENS)."""
    if rich:
        tokens = set(_VARS_RICH) | set(_FUNCS_RICH) | set(_BINOPS_RICH)
        tokens |= {r"\prod", r"\lim", "|", "[", "]", "'"}
    else:
        tokens = set(_VARS) | set(_FUNCS) | set(_BINOPS)
    if envs:
        tokens |= set(ENV_TOKENS)
    tokens |= {str(d) for d in range(10)}
    tokens |= {"{", "}", "^", "_", "(", ")", r"\frac", r"\sqrt", r"\sum",
               r"\int"}
    vocab = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3}
    for t in sorted(tokens):
        vocab[t] = len(vocab)
    return vocab


class SyntheticStreamDataset:
    """Infinite-variety synthetic dataset: ``(epoch, idx)`` deterministically
    seeds a freshly synthesized (image, caption) pair, so every epoch sees
    formulas never seen before — label memorization is impossible and the
    image is the only generalizable signal (the regime the reference got
    for free from 220k real MathWriting samples).

    Same interface as ``dataset.MathFormulaDataset`` (len/getitem +
    img_h/img_w/max_seq_len attrs); ``DataLoader`` advances the stream via
    ``set_epoch``. A val/test stream pins ``epoch`` (``freeze=True``) so
    its samples are identical across evaluations.
    """

    def __init__(self, tokenizer, samples_per_epoch: int, img_h: int = 96,
                 img_w: int = 320, max_seq_len: int = 150, seed: int = 0,
                 max_tokens: int = 28, freeze: bool = False,
                 rich: bool = False, max_terms: int = 5, depth: int = 2,
                 envs: bool = False):
        self.tokenizer = tokenizer
        self.n = samples_per_epoch
        self.img_h, self.img_w = img_h, img_w
        self.max_seq_len = max_seq_len
        self.seed = seed
        self.max_tokens = max_tokens
        self.freeze = freeze
        self.rich = rich
        self.max_terms = max_terms
        self.depth = depth
        self.envs = envs
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        if not self.freeze:
            self._epoch = int(epoch)

    def __len__(self) -> int:
        return self.n

    def _sample_key(self, idx: int) -> int:
        # SplitMix-style mix of (seed, epoch, idx) into one 63-bit key;
        # stable across processes (unlike hash(), which is salted)
        idx = int(idx)  # numpy ints overflow C-long multiplication
        z = (int(self.seed) * 0x9E3779B97F4A7C15
             + int(self._epoch) * 0xBF58476D1CE4E5B9
             + idx * 0x94D049BB133111EB) & (2 ** 64 - 1)
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
        return (z ^ (z >> 31)) & (2 ** 63 - 1)

    def formula_at(self, idx: int) -> str:
        prng = random.Random(self._sample_key(idx))
        while True:
            f = structured_formula(prng, max_terms=self.max_terms,
                                   depth=self.depth, rich=self.rich,
                                   envs=self.envs)
            if len(f.split()) <= self.max_tokens:
                return f

    def __getitem__(self, idx: int):
        formula = self.formula_at(idx)
        nrng = np.random.default_rng(self._sample_key(idx) ^ 0x5555AAAA)
        img = render_corpus_image(formula, nrng, self.img_h, self.img_w)
        ids = self.tokenizer.encode(formula, max_len=self.max_seq_len)
        length = min(len(self.tokenizer.encode(formula)), self.max_seq_len)
        return img, np.asarray(ids, np.int32), length


SAMPLE_INKML = """<ink xmlns="http://www.w3.org/2003/InkML">
  <annotation type="label">x ^ { 2 }</annotation>
  <annotation type="normalizedLabel">x ^ { 2 }</annotation>
  <trace>10 20, 15 25, 20 30, 30 45</trace>
  <trace>40 10 0.1, 45 15 0.2, 50 12 0.3</trace>
</ink>"""
