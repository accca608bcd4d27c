"""The quality bar of the shipped weights, computed by the JAX package on the
CPU, which the PyTorch port is held to.

Runs the JAX engine (``load_params_for_serving`` + ``DecodeEngine``, its
default route) and the JAX harness (``evaluate_model``) on the
``data_eval_hard`` test split at batch 64, in CSV order, and writes
``tests/fixtures/torch_r4_quality.json``:

- (a) bf16 greedy: exact match, corpus CER, average CER, valid LaTeX, mean
  confidence and ECE on all 2,000 images and on the first 512;
- (b) the same with ``quantize=True`` (int8 decoder weights);
- (c) bf16 beam 5 on the first 512 (no confidence, as the harness gives
  none under beam search);
- (c') bf16 greedy with ``constrained=True`` (pushdown-constrained
  decoding) on the first 512;
- (d) float32 greedy predictions, strings and token ids, of the first 64;
- (e) float32 greedy on the first 512: JAX's score, the port's score on the
  CPU (``DecodeEngine(device="cpu")``, weights read by the port's own
  reader) and the share of images on which the two predictions are equal;
- the ``tree_digest`` of the JAX loader's tree and the sha256 of the 2,000
  test images decoded by PIL and stacked as uint8.

Needs JAX, PIL and pandas; the card's machine runs none of it. Rerun it only
when the checkpoint or the corpus changes:

    JAX_PLATFORMS=cpu python quality_bar.py

``--only NAME`` computes one bar of (a)-(c') alone and writes it into the
existing fixture, leaving the rest of the file as it is.

``--train`` writes the training fixture instead,
``tests/fixtures/torch_r4_train.json``: the JAX package's train and eval
steps (``train/step.py``, XLA route) on the CPU in float32, dropout and
stochastic depth at 0, label smoothing 0.1, on the first 256 test images
in batches of 64 (no augmentation): the mean of the batches' eval losses
and the token accuracy over the 256; on the first batch the gradients'
global norm of one train step (Adam at lr 3e-4, clip 1.0, no warmup) and
the batch's eval loss after that step; and the eval loss of the first 4
images as one batch (the tier-1 test's check on the CPU):

    JAX_PLATFORMS=cpu python quality_bar.py --train
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(REPO, "serving_model_r4")
DATA_ROOT = os.path.join(REPO, "data_eval_hard")
OUT = os.path.join(REPO, "tests", "fixtures", "torch_r4_quality.json")
TRAIN_OUT = os.path.join(REPO, "tests", "fixtures", "torch_r4_train.json")
TRAIN_IMAGES = 256
TRAIN_FIRST = 4
LEARNING_RATE = 3e-4
BATCH = 64
SUBSET = 512
FIRST = 64
# the bars (a)-(c'): engine keyword arguments, images (None: all 2,000,
# scored on all and on the first 512) and beam width
CELLS = {
    "bf16_greedy": ({}, None, None),
    "bf16_greedy_int8": ({"quantize": True}, None, None),
    "bf16_beam5": ({}, SUBSET, 5),
    "bf16_greedy_constrained": ({"constrained": True}, SUBSET, None),
}


def score(records) -> dict:
    """The harness's summary metrics over ``records`` (any subset)."""
    from handwritten_math_ocr_api_tpu.eval.calibration import (
        expected_calibration_error,
    )

    n = len(records)
    chars = sum(len(r["ground_truth"]) for r in records)
    out = {
        "num_samples": n,
        "exact_match": sum(r["exact_match"] for r in records) / n,
        "corpus_cer": sum(r["edit_distance"] for r in records) / chars,
        "avg_cer": float(np.mean([r["cer"] for r in records])),
        "valid_latex": float(np.mean([r["valid_latex"] for r in records])),
        "mean_confidence": None,
        "ece": None,
    }
    confs = [r["confidence"] for r in records]
    if all(c is not None for c in confs):
        out["mean_confidence"] = float(np.mean(confs))
        out["ece"] = expected_calibration_error(
            confs, [r["exact_match"] for r in records])
    return out


def check_summary(bar: dict, summary: dict) -> None:
    """``score`` of a whole run must be the harness's own summary."""
    for ours, theirs in (("exact_match", "accuracy"),
                         ("corpus_cer", "corpus_cer"), ("avg_cer", "avg_cer"),
                         ("valid_latex", "valid_latex"),
                         ("mean_confidence", "mean_confidence"),
                         ("ece", "ece")):
        want = summary.get(theirs)
        if want is not None and abs(bar[ours] - want) > 1e-12:
            raise AssertionError(f"{ours}: {bar[ours]} != {want}")


def train_fixture(out_path: str) -> None:
    """The ``--train`` fixture (module docstring)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from handwritten_math_ocr_api_tpu.core.config import (
        DataConfig,
        TrainConfig,
    )
    from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer
    from handwritten_math_ocr_api_tpu.data.dataset import get_test_loader
    from handwritten_math_ocr_api_tpu.train.checkpoint import (
        load_params_for_serving,
    )
    from handwritten_math_ocr_api_tpu.train.optim import make_optimizer
    from handwritten_math_ocr_api_tpu.train.step import (
        TrainState,
        make_eval_step,
        make_train_step,
    )

    params, state, vocab, idx2char, cfg = load_params_for_serving(MODEL_DIR)
    tok = Tokenizer(vocab, idx2char)
    cfg = cfg.replace(dtype="float32", dropout=0.0,
                      swin=dataclasses.replace(cfg.swin,
                                               stochastic_depth=0.0))
    tc = TrainConfig(learning_rate=LEARNING_RATE)
    opt = make_optimizer(tc)

    def fresh():
        p = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                   params)
        return TrainState(params=p, opt_state=opt.init(p), model_state=state,
                          step=jnp.zeros((), jnp.int32))

    eval_step = make_eval_step(cfg, tc)
    train_step = make_train_step(cfg, tc, opt)
    test = get_test_loader(tok, DataConfig(data_root=DATA_ROOT,
                                           batch_size=BATCH), cfg)
    test.dataset.df = test.dataset.df.iloc[:TRAIN_IMAGES]
    batches = list(test)
    t = time.time()
    st = fresh()
    losses, correct, count = [], 0, 0
    for b in batches:
        loss, preds = eval_step(st, b["image"], b["caption"])
        losses.append(float(loss))
        tgt = b["caption"][:, 1:]
        mask = tgt != 0
        correct += int(((np.asarray(preds) == tgt) & mask).sum())
        count += int(mask.sum())
    first = batches[0]
    images = first["image"].astype(np.float32) / 255.0 * 2.0 - 1.0
    st2, metrics = train_step(fresh(), jnp.asarray(images),
                              jnp.asarray(first["caption"]),
                              jax.random.PRNGKey(0))
    after, _ = eval_step(st2, first["image"], first["caption"])
    few, _ = eval_step(fresh(), first["image"][:TRAIN_FIRST],
                       first["caption"][:TRAIN_FIRST])
    out = {
        "source": "quality_bar.py --train (JAX package on the CPU, "
                  "float32, XLA route)",
        "model": "serving_model_r4",
        "split": "data_eval_hard/test_labels.csv",
        "images": TRAIN_IMAGES,
        "batch_size": BATCH,
        "label_smoothing": tc.label_smoothing,
        "learning_rate": LEARNING_RATE,
        "grad_clip_norm": tc.grad_clip_norm,
        "eval_loss": float(np.mean(losses)),
        "eval_batch_losses": losses,
        "token_accuracy": correct / count,
        "first_batch": {
            "loss": float(metrics["loss"]),
            "accuracy": float(metrics["accuracy"]),
            "grad_norm": float(metrics["grad_norm"]),
            "loss_after_step": float(after),
        },
        "first4_eval_loss": float(few),
        "host_seconds": time.time() - t,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {out_path}: {out}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help=f"default {OUT} (--train: {TRAIN_OUT})")
    ap.add_argument("--only", choices=sorted(CELLS),
                    help="compute this bar alone and merge it into --out")
    ap.add_argument("--train", action="store_true",
                    help="write the training fixture (module docstring)")
    args = ap.parse_args()
    if args.train:
        train_fixture(args.out or TRAIN_OUT)
        return
    args.out = args.out or OUT

    import jax

    jax.config.update("jax_platforms", "cpu")
    from PIL import Image

    from handwritten_math_ocr_api_tpu.core.config import DataConfig
    from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer
    from handwritten_math_ocr_api_tpu.data.dataset import get_test_loader
    from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine
    from handwritten_math_ocr_api_tpu.eval.harness import evaluate_model
    from handwritten_math_ocr_api_tpu.train.checkpoint import (
        load_params_for_serving,
    )

    from handwritten_math_ocr_api_torch.train.checkpoint import tree_digest

    params, state, vocab, idx2char, cfg = load_params_for_serving(MODEL_DIR)
    tok = Tokenizer(vocab, idx2char)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    leaves = jax.tree_util.tree_leaves(np_params)
    data_cfg = DataConfig(data_root=DATA_ROOT, batch_size=BATCH)

    def loader(n=None):
        test = get_test_loader(tok, data_cfg, cfg)
        if n is not None:
            test.dataset.df = test.dataset.df.iloc[:n]
        return test

    def run(tag, engine, n=None, beam_size=None):
        t = time.time()
        res = evaluate_model(engine, loader(n), tok, beam_size)
        print(f"{tag}: {res['summary']} ({time.time() - t:.1f} s)",
              flush=True)
        check_summary(score(res["records"]), res["summary"])
        return res["records"], time.time() - t

    def bar(name):
        kw, n, beam = CELLS[name]
        records, secs = run(name, DecodeEngine(params, state, cfg,
                                               tokenizer=tok, **kw),
                            n, beam_size=beam)
        scores = {"2000": score(records)} if n is None else {}
        scores[str(SUBSET)] = score(records[:SUBSET])
        return scores, secs

    if args.only:
        with open(args.out) as f:
            out = json.load(f)
        out["bars"][args.only], out["host_seconds"][args.only] = bar(
            args.only)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(f"wrote {args.only} into {args.out}", flush=True)
        return

    labels = loader().dataset.df
    stack = np.stack([
        np.asarray(Image.open(os.path.join(DATA_ROOT, "test_formulas",
                                           name)).convert("L"))
        for name in labels.iloc[:, 0]])
    out = {
        "source": "quality_bar.py (JAX package on the CPU)",
        "model": "serving_model_r4",
        "split": "data_eval_hard/test_labels.csv",
        "batch_size": BATCH,
        "tree_digest": tree_digest(np_params),
        "n_leaves": len(leaves),
        "n_params": int(sum(x.size for x in leaves)),
        "images_sha256": hashlib.sha256(stack.tobytes()).hexdigest(),
        "images_shape": list(stack.shape),
        "route": "JAX DecodeEngine default route (use_pallas=False)",
        "bars": {},
        "host_seconds": {},
    }
    for name in CELLS:
        out["bars"][name], out["host_seconds"][name] = bar(name)

    f32 = cfg.replace(dtype="float32")
    jax_f32 = DecodeEngine(params, state, f32, tokenizer=tok)
    first = next(iter(loader(FIRST)))
    res = jax_f32.decode_tokens(first["image"])
    tokens = np.asarray(res.tokens)
    out["float32_first64"] = {
        "predictions": tok.decode_batch(tokens),
        "tokens": [[int(t) for t in row[:int(n)]]
                   for row, n in zip(tokens, np.asarray(res.lengths))],
    }
    jax_records, secs = run("float32_greedy_jax", jax_f32, SUBSET)
    out["host_seconds"]["float32_greedy_jax"] = secs

    from handwritten_math_ocr_api_torch.core.config import (
        DataConfig as PDataConfig,
    )
    from handwritten_math_ocr_api_torch.core.tokenizer import (
        Tokenizer as PTokenizer,
    )
    from handwritten_math_ocr_api_torch.data.dataset import (
        get_test_loader as p_loader,
    )
    from handwritten_math_ocr_api_torch.decode.api import (
        DecodeEngine as PEngine,
    )
    from handwritten_math_ocr_api_torch.eval.harness import (
        evaluate_model as p_evaluate,
    )
    from handwritten_math_ocr_api_torch.train.checkpoint import (
        load_params_for_serving as p_load,
    )

    p_params, _, p_vocab, p_idx2char, p_cfg = p_load(MODEL_DIR)
    p_tok = PTokenizer(p_vocab, p_idx2char)
    p_engine = PEngine(p_params, p_cfg.replace(dtype="float32"),
                       tokenizer=p_tok, device="cpu")
    p_test = p_loader(p_tok, PDataConfig(data_root=DATA_ROOT,
                                         batch_size=BATCH), p_cfg)
    p_test.dataset.rows = p_test.dataset.rows[:SUBSET]
    t = time.time()
    port = p_evaluate(p_engine, p_test, p_tok)
    out["host_seconds"]["float32_greedy_port_cpu"] = time.time() - t
    print(f"float32_greedy_port_cpu: {port['summary']}", flush=True)
    agree = float(np.mean([a["prediction"] == b["prediction"] for a, b in
                           zip(jax_records, port["records"])]))
    out["float32_512"] = {"jax": score(jax_records),
                          "port_cpu": score(port["records"]),
                          "agreement": agree}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}; float32 agreement {agree}", flush=True)


if __name__ == "__main__":
    main()
