"""Whether what the timed path served is correct.

After the window has closed and the program's state is freed, every answer
served in the window is read back into token ids
(``reference.Vocab.ids_of``: an answer that is not the clean-up of any
token sequence cannot be judged and counts as unparsed). The reference
runs once over each image with its served tokens, teacher-forced in
float32, and each served token's gap below the reference's best logit at
its position is read; the EOS that ended an answer shorter than the
longest output is a served token too. Compared, each against its limit
from ``limits/<cell>.json``:

- ``mean_gap``: the mean gap over every served token;
- ``mean_conf_err``: the mean over the answers of the error of a served
  confidence (exp of the mean log-probability of the answer's tokens)
  against the reference's, in log units;
- ``unparsed``: answers that are no token sequence;
- ``failed``: requests due in the window that failed or never came.

The widest gap and the widest confidence error are printed beside them:
on the shipped weights they do not separate the program from its control
(a wrong token with a near tie reads as small as a rounding flip), while
the means, over some tens of thousands of tokens, do.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import reference
from .run_state import Run

BLOCK = 64   # reference rows at a time
NUMBERS = ("mean_gap", "mean_conf_err", "unparsed", "failed")


def window_answers(run: Run, vocab: reference.Vocab
                   ) -> Tuple[List[Tuple[int, List[int], float]], int]:
    """([(image index, served ids, served confidence)] of every answer
    served in the window, unparsed count)."""
    out, unparsed = [], 0
    for r in run.done_in_window():
        for img, text, conf in zip(r.images, r.texts, r.confs):
            ids = vocab.ids_of(text)
            if ids is None:
                unparsed += 1
            else:
                out.append((img, ids, conf))
    return out, unparsed


def fp8_tree(tree):
    """The control's weights: every matrix, convolution and embedding
    table rounded to float8 e4m3 with a scale a tensor (its largest
    magnitude onto e4m3's 448), the relative-position bias tables, biases
    and norms kept; the reference then runs as before."""
    if isinstance(tree, dict):
        return {k: (v if k == "rel_bias_table" else fp8_tree(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp8_tree(v) for v in tree]
    if tree.dim() < 2:
        return tree
    scale = tree.abs().max().clamp(min=1e-30) / 448.0
    return (tree / scale).to(torch.float8_e4m3fn).float() * scale


def _numbers(logits, tgt, block, ref=None) -> Dict[str, float]:
    """One block's sums and maxima: each served token's gap in the
    reference's logits (or with ``ref``, the gap in ``ref`` of the token
    that ``logits`` puts first), and each answer's confidence error: the
    mean log-probability of its served tokens under ``logits`` against
    the served confidence (or with ``ref``, against ``ref``'s)."""
    ref = logits if ref is None else ref
    valid = tgt >= 0
    idx = tgt.clamp(min=0)[..., None]
    pick = (idx if ref is logits
            else logits.argmax(dim=-1, keepdim=True))
    gap = (ref.max(dim=-1).values - ref.gather(-1, pick)[..., 0])[valid]
    lp = torch.log_softmax(logits, dim=-1).gather(-1, idx)[..., 0]
    lp_sum = torch.where(valid, lp, torch.zeros_like(lp)).sum(dim=1)
    if ref is not logits:
        rlp = torch.log_softmax(ref, dim=-1).gather(-1, idx)[..., 0]
        rsum = torch.where(valid, rlp, torch.zeros_like(rlp)).sum(dim=1)
    errs = []
    for r, (_, ids, served) in enumerate(block):
        if not ids or served <= 0:
            continue
        want = (math.log(served) if ref is logits
                else float(rsum[r]) / len(ids))
        errs.append(abs(want - float(lp_sum[r]) / len(ids)))
    return {"gap_sum": float(gap.sum()), "tokens": int(valid.sum()),
            "max_gap": float(gap.max()), "conf_sum": sum(errs),
            "answers": len(errs), "max_conf_err": max(errs, default=0.0)}


def _merge(acc: Dict[str, float], part: Dict[str, float]) -> None:
    for k, v in part.items():
        acc[k] = max(acc.get(k, 0.0), v) if k.startswith("max_") \
            else acc.get(k, 0) + v


def _finish(acc: Dict[str, float]) -> Dict[str, float]:
    return {"mean_gap": acc["gap_sum"] / max(acc["tokens"], 1),
            "mean_conf_err": acc["conf_sum"] / max(acc["answers"], 1),
            "max_gap": acc["max_gap"], "max_conf_err": acc["max_conf_err"],
            "tokens": acc["tokens"], "answers": acc["answers"]}


@torch.no_grad()
def gaps(params, state, model: dict, vocab: reference.Vocab,
         images_u8: np.ndarray, answers, device, control: bool = False
         ) -> Dict[str, Dict[str, float]]:
    """The program's numbers over ``answers`` (``_finish``): ``mean_gap``,
    the mean over every served token of the gap by which its reference
    logit lies below the reference's best at its position (the EOS that
    ended an answer included); ``mean_conf_err``, the mean over the answers
    of the error of a served confidence's log against the reference's mean
    log-probability of the same tokens (the EOS in the sum but not in the
    count, as the engines compute it); and the widest of each. With
    ``control``, ``"control"`` holds the same numbers of the control
    (``fp8_tree``'s reference put in the program's place): the gap of the
    token it puts first at each position, and its mean log-probability of
    the served tokens."""
    reference.no_tf32()
    T = model["max_seq_len"]
    prog: Dict[str, float] = {}
    ctl: Dict[str, float] = {}
    low = fp8_tree(params) if control else None
    for lo in range(0, len(answers), BLOCK):
        block = answers[lo:lo + BLOCK]
        targets = [(ids + [vocab.eos])[:T] for _, ids, _ in block]
        L = max(len(t) for t in targets)
        inp = torch.full((len(block), L), vocab.pad, dtype=torch.long)
        tgt = torch.full((len(block), L), -1, dtype=torch.long)
        for r, t in enumerate(targets):
            inp[r, 0] = vocab.sos
            inp[r, 1:len(t)] = torch.tensor(t[:-1], dtype=torch.long)
            tgt[r, :len(t)] = torch.tensor(t, dtype=torch.long)
        imgs = torch.from_numpy(np.stack([images_u8[i] for i, _, _ in block]))
        imgs, inp, tgt = imgs.to(device), inp.to(device), tgt.to(device)

        def logits_of(p):
            memory = reference.encode(p, state, model, imgs)
            return reference.decoder_logits(p["decoder"], model, memory,
                                            inp).double()

        ref = logits_of(params)
        _merge(prog, _numbers(ref, tgt, block))
        if control:
            _merge(ctl, _numbers(logits_of(low), tgt, block, ref))
        del ref
    out = {"program": _finish(prog)}
    if control:
        out["control"] = _finish(ctl)
    return out


def failed(run: Run) -> int:
    return sum(1 for r in run.due_in_window() if not r.ok)


def checks(run: Run, ref_params, ref_state, vocab, images_u8, device,
           limits: Dict[str, float], control: bool = False
           ) -> Dict[str, dict]:
    """Each compared number of the program beside its limit. With
    ``control``, ``run.notes["control_checks"]`` holds the control's
    numbers (``gaps``) beside the same limits: its verdict, which has to
    come out not correct."""
    answers, unparsed = window_answers(run, vocab)
    run.notes["distinct_answers"] = len({tuple(ids) for _, ids, _ in answers})
    if answers:
        got = gaps(ref_params, ref_state, run.model, vocab, images_u8,
                   answers, device, control)
    else:
        got = {"program": {"mean_gap": math.inf, "mean_conf_err": math.inf}}
    run.notes["judged"] = got
    out = _compared(dict(got["program"], unparsed=unparsed,
                         failed=failed(run)), limits)
    if control:
        run.notes["control_checks"] = _compared(
            dict(got.get("control", {}), unparsed=unparsed,
                 failed=failed(run)), limits)
    return out


def _compared(values: Dict[str, float], limits: Dict[str, float]
              ) -> Dict[str, dict]:
    # nothing to judge (no answer in the window) reads as no number
    values = {k: (v if v is not None and math.isfinite(v) else None)
              for k, v in values.items()}
    # a number whose limit is null is not compared (the limits file says
    # why)
    return {name: {"value": values.get(name), "limit": limits[name]}
            for name in NUMBERS if limits.get(name) is not None}


def passed(c: Dict[str, dict]) -> bool:
    return all(v["value"] is not None and v["value"] <= v["limit"]
               for v in c.values())
