"""Confidence calibration: reliability, ECE, Platt scaling, isotonic (PAV)
(the port of ``handwritten_math_ocr_api_tpu/eval/calibration.py``).

Beyond the reference: it serves ``confidence = exp(mean token log-prob)``
(app/src/im2latex.py:50,55) and documents it as "confidence in [0,1]"
(app/src/models.py:10-16) without ever validating it against outcome
probabilities — a threshold like "route to human review below 0.8" is
meaningless on an uncalibrated score. This module measures calibration
(reliability table + expected calibration error against per-sample exact
match) and fits two standard post-hoc calibrators on held-out eval data:

- **Platt scaling** — 2-parameter logistic ``p = sigmoid(a*log(conf)+b)``
  fit by Newton-Raphson on the binary NLL (Platt 1999). log-confidence is
  the natural feature here: the raw score is exp(mean log-prob), so its
  log restores the additive scale the model actually works in.
- **Isotonic regression** — nonparametric monotone fit via
  pool-adjacent-violators (Zadrozny & Elkan 2002); better with plenty of
  samples, can overfit small sets.

The fitted mapping is a small JSON artifact (``calibration.json``) that the
JAX package's app applies to every reported confidence when present in the
model dir; artifacts are interchangeable between the packages. Fit on
GREEDY decode outcomes; beam reports no confidence (``eval/harness.py``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_EPS = 1e-12


# -- measurement -------------------------------------------------------------

def reliability_table(conf: Sequence[float], correct: Sequence[bool],
                      n_bins: int = 10) -> List[Dict]:
    """Equal-width bins over [0, 1]: per-bin count, mean confidence, and
    empirical accuracy. Empty bins are skipped."""
    conf = np.asarray(conf, np.float64)
    correct = np.asarray(correct, np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    # right-inclusive last bin so conf=1.0 lands in bin n-1
    idx = np.clip(np.digitize(conf, edges[1:-1]), 0, n_bins - 1)
    out: List[Dict] = []
    for b in range(n_bins):
        m = idx == b
        if not m.any():
            continue
        out.append({
            "bin_lo": float(edges[b]),
            "bin_hi": float(edges[b + 1]),
            "count": int(m.sum()),
            "mean_confidence": float(conf[m].mean()),
            "accuracy": float(correct[m].mean()),
        })
    return out


def expected_calibration_error(conf: Sequence[float],
                               correct: Sequence[bool],
                               n_bins: int = 10) -> float:
    """ECE: count-weighted mean |accuracy - mean confidence| over bins
    (Naeini et al. 2015) — 0 means perfectly calibrated."""
    rows = reliability_table(conf, correct, n_bins)
    n = sum(r["count"] for r in rows)
    if n == 0:
        return 0.0
    return float(sum(
        r["count"] * abs(r["accuracy"] - r["mean_confidence"])
        for r in rows) / n)


# -- calibrators -------------------------------------------------------------

def fit_platt(conf: Sequence[float], correct: Sequence[bool],
              max_iter: int = 50) -> Tuple[float, float]:
    """Logistic fit p = sigmoid(a*log(conf) + b) by Newton-Raphson on the
    binary NLL. Uses Platt's label smoothing (targets (N+ + 1)/(N+ + 2),
    1/(N- + 2)) so perfectly separable data doesn't push |a| to inf."""
    x = np.log(np.clip(np.asarray(conf, np.float64), _EPS, 1.0))
    y = np.asarray(correct, np.float64)
    n_pos, n_neg = float(y.sum()), float((1 - y).sum())
    t = np.where(y > 0.5, (n_pos + 1.0) / (n_pos + 2.0),
                 1.0 / (n_neg + 2.0))
    a, b = 1.0, 0.0
    for _ in range(max_iter):
        z = np.clip(a * x + b, -35.0, 35.0)
        p = 1.0 / (1.0 + np.exp(-z))
        g = p - t                       # dNLL/dz
        w = np.maximum(p * (1.0 - p), 1e-10)
        # gradient and Hessian in (a, b)
        ga, gb = float((g * x).sum()), float(g.sum())
        haa, hab = float((w * x * x).sum()), float((w * x).sum())
        hbb = float(w.sum())
        det = haa * hbb - hab * hab
        if abs(det) < 1e-12:
            break
        da = (gb * hab - ga * hbb) / det
        db = (ga * hab - gb * haa) / det
        a, b = a + da, b + db
        if abs(da) + abs(db) < 1e-10:
            break
    return float(a), float(b)


def fit_isotonic(conf: Sequence[float], correct: Sequence[bool]
                 ) -> Tuple[List[float], List[float]]:
    """Pool-adjacent-violators: returns (x, y) of the right-continuous
    step function mapping confidence -> calibrated probability."""
    order = np.argsort(np.asarray(conf, np.float64), kind="stable")
    x = np.asarray(conf, np.float64)[order]
    y = np.asarray(correct, np.float64)[order]
    # blocks: (sum, count, x_hi)
    sums: List[float] = []
    counts: List[float] = []
    xhis: List[float] = []
    for xi, yi in zip(x, y):
        sums.append(float(yi))
        counts.append(1.0)
        xhis.append(float(xi))
        # merge while the mean sequence is decreasing
        while len(sums) > 1 and (sums[-2] / counts[-2]
                                 >= sums[-1] / counts[-1]):
            s, c, h = sums.pop(), counts.pop(), xhis.pop()
            sums[-1] += s
            counts[-1] += c
            xhis[-1] = h
        # tie on x must share one block (keep the function single-valued)
        while len(xhis) > 1 and xhis[-2] == xhis[-1]:
            s, c, h = sums.pop(), counts.pop(), xhis.pop()
            sums[-1] += s
            counts[-1] += c
            xhis[-1] = h
    vals = [s / c for s, c in zip(sums, counts)]
    return xhis, vals


# -- artifact ----------------------------------------------------------------

def fit(conf: Sequence[float], correct: Sequence[bool],
        method: str = "platt", n_bins: int = 10) -> Dict:
    """Fit a calibrator and return a JSON-serializable artifact including
    the before/after ECE on the fitting data."""
    conf = np.asarray(conf, np.float64)
    correct = np.asarray(correct, bool)
    if method == "platt":
        a, b = fit_platt(conf, correct)
        art: Dict = {"method": "platt", "a": a, "b": b}
    elif method == "isotonic":
        xs, ys = fit_isotonic(conf, correct)
        art = {"method": "isotonic", "x": xs, "y": ys}
    else:
        raise ValueError(f"unknown calibration method: {method!r}")
    art["n_samples"] = int(conf.size)
    art["n_bins"] = int(n_bins)
    art["ece_raw"] = expected_calibration_error(conf, correct, n_bins)
    art["ece_calibrated"] = expected_calibration_error(
        apply(art, conf), correct, n_bins)
    art["reliability_raw"] = reliability_table(conf, correct, n_bins)
    art["reliability_calibrated"] = reliability_table(
        apply(art, conf), correct, n_bins)
    return art


def apply(art: Dict, conf) -> np.ndarray:
    """Map raw confidence(s) through a fitted artifact. Scalar in, scalar
    out; array in, array out. Output clipped to [0, 1]."""
    scalar = np.isscalar(conf)
    c = np.asarray(conf, np.float64)
    if art["method"] == "platt":
        z = np.clip(art["a"] * np.log(np.clip(c, _EPS, 1.0)) + art["b"],
                    -35.0, 35.0)
        out = 1.0 / (1.0 + np.exp(-z))
    elif art["method"] == "isotonic":
        xs = np.asarray(art["x"], np.float64)
        ys = np.asarray(art["y"], np.float64)
        # right-continuous step: value of the first block whose x_hi >= c;
        # above the last block, keep its value
        idx = np.clip(np.searchsorted(xs, c, side="left"), 0, len(ys) - 1)
        out = ys[idx]
    else:  # pragma: no cover - validated at fit time
        raise ValueError(f"unknown calibration method: {art['method']!r}")
    out = np.clip(out, 0.0, 1.0)
    return float(out) if scalar else out


def save(art: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(art, f, indent=1)


def load(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            art = json.load(f)
    except (OSError, ValueError):
        return None
    if art.get("method") not in ("platt", "isotonic"):
        return None
    return art
