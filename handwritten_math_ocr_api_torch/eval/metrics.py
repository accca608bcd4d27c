"""Evaluation metrics: edit distance, CER, BLEU, exact match.

The port of ``handwritten_math_ocr_api_tpu/eval/metrics.py``: edit distance
is character-level Levenshtein between the decoded strings, CER is
corpus-level (total char errors / total target chars), BLEU-4 is corpus
BLEU with method-4 smoothing over whitespace-split tokens. Edit distance is
the pure-Python two-row DP (the JAX package's last fallback; the port binds
neither ``Levenshtein`` nor the JAX package's native library), run on what
lies between the pair's common prefix and suffix. BLEU-4 keeps
the JAX rule: nltk's ``corpus_bleu`` where nltk imports, else 0.0.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def _levenshtein_py(a: str, b: str) -> int:
    """Pure-Python Levenshtein distance (two-row DP over what lies between
    the common prefix and suffix, which add nothing to the distance)."""
    if a == b:
        return 0
    start, n = 0, min(len(a), len(b))
    while start < n and a[start] == b[start]:
        start += 1
    end = 0
    while end < n - start and a[-1 - end] == b[-1 - end]:
        end += 1
    a, b = a[start:len(a) - end], b[start:len(b) - end]
    if not a:
        return len(b)
    if not b:
        return len(a)
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


levenshtein = _levenshtein_py


def edit_distance(pred: str, target: str) -> int:
    """Character-level Levenshtein distance (reference: src/utils.py:16-20)."""
    return int(levenshtein(pred, target))


def exact_match(pred: str, target: str) -> bool:
    return pred.strip() == target.strip()


def cer(pred: str, target: str) -> float:
    """Per-sample character error rate."""
    if not target:
        return 0.0 if not pred else 1.0
    return edit_distance(pred, target) / len(target)


def batch_edit_distance(preds: Sequence[str],
                        targets: Sequence[str]) -> List[int]:
    """Pairwise distances."""
    return [edit_distance(p, t) for p, t in zip(preds, targets)]


def corpus_cer(preds: Sequence[str], targets: Sequence[str]) -> float:
    """Corpus CER: sum(errors)/sum(target chars) (reference: src/utils.py:23-25)."""
    total_chars = sum(len(t) for t in targets)
    if total_chars == 0:
        return 0.0
    total_errors = sum(edit_distance(p, t) for p, t in zip(preds, targets))
    return total_errors / total_chars


def corpus_bleu4(preds: Sequence[str], targets: Sequence[str]) -> float:
    """Corpus BLEU-4 with method-4 smoothing over whitespace tokens
    (reference: src/utils.py:36-59). Falls back to 0.0 without nltk."""
    try:
        from nltk.translate.bleu_score import SmoothingFunction, corpus_bleu
    except ImportError:
        return 0.0
    references = [[t.split()] for t in targets]
    hypotheses = [p.split() for p in preds]
    smoothie = SmoothingFunction().method4
    return float(
        corpus_bleu(
            references,
            hypotheses,
            smoothing_function=smoothie,
            weights=(0.25, 0.25, 0.25, 0.25),
        )
    )


def compute_metrics(
    pred_strs: Sequence[str],
    tgt_strs: Sequence[str],
    with_bleu: bool = True,
) -> Dict[str, float]:
    """Aggregate metrics over decoded strings (reference: src/utils.py:10-34).

    Unlike the reference (which took id lists + a tokenizer), this accepts
    decoded strings so the same function serves train-val, eval harness and
    serving-side regression tests.
    """
    assert len(pred_strs) == len(tgt_strs)
    return metrics_from_distances(
        pred_strs, tgt_strs, batch_edit_distance(pred_strs, tgt_strs),
        with_bleu)


def metrics_from_distances(pred_strs: Sequence[str],
                           tgt_strs: Sequence[str], dists: Sequence[int],
                           with_bleu: bool = True) -> Dict[str, float]:
    """``compute_metrics`` given each pair's edit distance (the harness has
    them from its records)."""
    if not pred_strs:
        return {"edit_distance": 0.0, "cer": 0.0, "bleu": 0.0, "exact_match": 0.0}
    total_chars = sum(len(t) for t in tgt_strs)
    out = {
        "edit_distance": sum(dists) / len(dists),
        "cer": (sum(dists) / total_chars) if total_chars else 0.0,
        "exact_match": sum(
            exact_match(p, t) for p, t in zip(pred_strs, tgt_strs)
        ) / len(pred_strs),
    }
    out["bleu"] = corpus_bleu4(pred_strs, tgt_strs) if with_bleu else 0.0
    return out
