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
- (d) float32 greedy predictions, strings and token ids, of the first 64;
- (e) float32 greedy on the first 512: JAX's score, the port's score on the
  CPU (``DecodeEngine(device="cpu")``, weights read by the port's own
  reader) and the share of images on which the two predictions are equal;
- the ``tree_digest`` of the JAX loader's tree and the sha256 of the 2,000
  test images decoded by PIL and stacked as uint8.

Needs JAX, PIL and pandas; the card's machine runs none of it. Rerun it only
when the checkpoint or the corpus changes:

    JAX_PLATFORMS=cpu python quality_bar.py
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
BATCH = 64
SUBSET = 512
FIRST = 64


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

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

    for name, kw in (("bf16_greedy", {}),
                     ("bf16_greedy_int8", {"quantize": True})):
        records, secs = run(name, DecodeEngine(params, state, cfg,
                                               tokenizer=tok, **kw))
        out["bars"][name] = {"2000": score(records),
                             str(SUBSET): score(records[:SUBSET])}
        out["host_seconds"][name] = secs
    records, secs = run("bf16_beam5", DecodeEngine(params, state, cfg,
                                                   tokenizer=tok),
                        SUBSET, beam_size=5)
    out["bars"]["bf16_beam5"] = {str(SUBSET): score(records)}
    out["host_seconds"]["bf16_beam5"] = secs

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
