"""Test-split evaluation harness: CER / exact match / BLEU over batched
decode, with CSV and summary outputs.

The port of ``handwritten_math_ocr_api_tpu/eval/harness.py`` over the port's
``DecodeEngine``: the same records (prediction, ground truth decoded from
the caption's token ids, exact match, CER, edit distance, confidence, valid
LaTeX), the same summary keys, the greedy confidence ``exp(logprob_sum /
token_count)`` (0 where nothing was emitted), no confidence under beam
search, and one batch of pipelining: a batch's host metrics are computed
after the next batch's decode was started. The summary's edit distances
are the records' (JAX computes them twice). ``save_results`` writes
``test_results.csv`` with the ``csv`` module and ``summary.txt``.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..core.tokenizer import Tokenizer
from . import calibration as calib
from . import latex_check
from . import metrics as metrics_lib

log = logging.getLogger(__name__)


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def evaluate_model(engine, loader: Iterable, tokenizer: Tokenizer,
                   beam_size: Optional[int] = None) -> Dict:
    """Run decode over a loader; returns {records, summary}. ``engine`` is
    a ``decode/api.py::DecodeEngine``."""
    records: List[Dict] = []
    t0 = time.time()
    n_images = 0
    beam = bool(beam_size and beam_size > 1)

    def integrate(res, batch) -> None:
        nonlocal n_images
        valid = batch.get("valid", np.ones(len(batch["image"]), bool))
        preds = tokenizer.decode_batch(_numpy(res.tokens))
        targets = tokenizer.decode_batch(batch["caption"])
        if beam:
            confs = [None] * len(preds)
        else:
            lp = _numpy(res.logprob_sum).astype(np.float64)
            counts = _numpy(res.token_count).astype(np.float64)
            confs = np.where(counts > 0,
                             np.exp(lp / np.maximum(counts, 1.0)), 0.0)
        for i, (p, t) in enumerate(zip(preds, targets)):
            if not valid[i]:
                continue
            dist = metrics_lib.edit_distance(p, t)
            records.append({
                "index": n_images,
                "prediction": p,
                "ground_truth": t,
                "exact_match": p.strip() == t.strip(),
                "cer": dist / len(t) if t else (0.0 if not p else 1.0),
                "edit_distance": dist,
                "confidence": (None if confs[i] is None
                               else float(confs[i])),
                "valid_latex": latex_check.check_latex(p)[0],
            })
            n_images += 1

    pending = None  # one batch of pipelining: decode ahead of the metrics
    for batch in loader:
        res = engine.decode_tokens(batch["image"], beam_size)
        if pending is not None:
            integrate(*pending)
        pending = (res, batch)
    if pending is not None:
        integrate(*pending)
    elapsed = time.time() - t0

    preds = [r["prediction"] for r in records]
    tgts = [r["ground_truth"] for r in records]
    agg = metrics_lib.metrics_from_distances(
        preds, tgts, [r["edit_distance"] for r in records])
    summary = {
        "num_samples": n_images,
        "accuracy": agg["exact_match"],
        "avg_cer": (float(np.mean([r["cer"] for r in records]))
                    if records else 0.0),
        "corpus_cer": agg["cer"],
        "edit_distance": agg["edit_distance"],
        "bleu": agg["bleu"],
        "elapsed_sec": elapsed,
        "images_per_sec": n_images / elapsed if elapsed > 0 else 0.0,
        "decode": f"beam-{beam_size}" if beam else "greedy",
    }
    if records:
        summary["valid_latex"] = float(
            np.mean([r["valid_latex"] for r in records]))
        summary["valid_latex_gt"] = latex_check.validity_fraction(tgts)
    confs = [r["confidence"] for r in records
             if r.get("confidence") is not None]
    if confs and len(confs) == len(records):
        summary["mean_confidence"] = float(np.mean(confs))
        summary["ece"] = calib.expected_calibration_error(
            confs, [r["exact_match"] for r in records])
    return {"records": records, "summary": summary}


def save_results(results: Dict, out_dir: str = "results") -> None:
    """Write test_results.csv + summary.txt."""
    os.makedirs(out_dir, exist_ok=True)
    records = results["records"]
    with open(os.path.join(out_dir, "test_results.csv"), "w", newline="",
              encoding="utf-8") as f:
        if records:
            writer = csv.DictWriter(f, fieldnames=list(records[0]))
            writer.writeheader()
            writer.writerows(records)
    s = results["summary"]
    with open(os.path.join(out_dir, "summary.txt"), "w") as f:
        f.write("Evaluation summary\n")
        f.write("==================\n")
        f.write(f"Samples:            {s['num_samples']}\n")
        f.write(f"Decode:             {s['decode']}\n")
        f.write(f"Exact-match acc:    {s['accuracy']:.4f}\n")
        f.write(f"Avg CER:            {s['avg_cer']:.4f}\n")
        f.write(f"Corpus CER:         {s['corpus_cer']:.4f}\n")
        f.write(f"Avg edit distance:  {s['edit_distance']:.2f}\n")
        f.write(f"BLEU-4:             {s['bleu']:.4f}\n")
        f.write(f"Throughput:         {s['images_per_sec']:.2f} img/s\n")
        if "valid_latex" in s:
            f.write(f"Valid LaTeX:        {s['valid_latex']:.4f} "
                    f"(ground truth {s['valid_latex_gt']:.4f})\n")
        if "ece" in s:
            f.write(f"Mean confidence:    {s['mean_confidence']:.4f}\n")
            f.write(f"ECE (10 bins):      {s['ece']:.4f}\n")
    log.info("wrote %s/{test_results.csv,summary.txt}", out_dir)
