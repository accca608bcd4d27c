"""Command-line interface of the port.

The port of the ``serve`` and ``calibrate`` subcommands of
``handwritten_math_ocr_api_tpu/cli.py``, with the same flags:

    python -m handwritten_math_ocr_api_torch serve --model-dir DIR \
        [--host H] [--port P]
    python -m handwritten_math_ocr_api_torch calibrate --results CSV \
        [--out calibration.json] [--method platt|isotonic] [--bins N]

``serve`` runs the HTTP app on the card (``serve/app.py``); its settings
come from the environment as the JAX package's do (``ServeConfig.from_env``).
``predict`` and ``evaluate`` read training checkpoints, which the port
does not read yet; the JAX package's other subcommands build data or train.
"""

from __future__ import annotations

import argparse
import logging
import sys


def cmd_calibrate(args) -> int:
    """Fit a confidence calibrator from an eval CSV (eval/calibration.py).

    Input: the test_results.csv of a greedy evaluation, which carries each
    sample's confidence and exact_match. Output: calibration.json, which
    the serving app applies from the model dir."""
    import csv as _csv

    from .eval import calibration as calib

    conf, correct = [], []
    with open(args.results) as f:
        for row in _csv.DictReader(f):
            c = row.get("confidence", "")
            if c in ("", "None", None):
                continue
            conf.append(float(c))
            correct.append(row["exact_match"].strip().lower() == "true")
    if len(conf) < 10:
        print(f"need >=10 samples with confidence, got {len(conf)} "
              f"(run `evaluate` greedy — beam rows carry no confidence)")
        return 1
    art = calib.fit(conf, correct, method=args.method, n_bins=args.bins)
    calib.save(art, args.out)
    print(f"fit {args.method} on {art['n_samples']} samples: "
          f"ECE {art['ece_raw']:.4f} -> {art['ece_calibrated']:.4f} "
          f"({args.bins} bins) -> {args.out}")
    for r in art["reliability_calibrated"]:
        print(f"  [{r['bin_lo']:.1f},{r['bin_hi']:.1f}) n={r['count']:<5d} "
              f"conf={r['mean_confidence']:.3f} acc={r['accuracy']:.3f}")
    return 0


def cmd_serve(args) -> int:
    from .serve.app import run_server

    run_server(model_dir=args.model_dir, host=args.host, port=args.port)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="handwritten_math_ocr_api_torch",
        description="PyTorch/CUDA handwritten math OCR framework")
    sub = p.add_subparsers(dest="command", required=True)

    ca = sub.add_parser("calibrate",
                        help="fit a confidence calibrator from eval CSV")
    ca.add_argument("--results", required=True,
                    help="test_results.csv from `evaluate` (greedy)")
    ca.add_argument("--out", default="calibration.json")
    ca.add_argument("--method", default="platt",
                    choices=["platt", "isotonic"])
    ca.add_argument("--bins", type=int, default=10)
    ca.set_defaults(fn=cmd_calibrate)

    sv = sub.add_parser("serve", help="run the serving API")
    sv.add_argument("--model-dir", default="trained-model")
    sv.add_argument("--host", default="0.0.0.0")
    sv.add_argument("--port", type=int, default=8080)
    sv.set_defaults(fn=cmd_serve)

    return p


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
