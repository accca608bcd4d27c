"""Readings that set the limits of ``correct``, and the verdicts that show
them working: the program's numbers on many seeds, the control's, and the
planted faults', in one process.

    python3 port_bench/control.py --workload <cell> --seeds 101 102 ... \
        --seconds 4 --variants program fp8ref token half

Each run is judged against the committed ``limits/<cell>.json``.
``program`` runs the cell as ``run.py`` does. ``fp8ref`` also reads, on
the same answers, the control: the reference with its weights in float8
e4m3 (``judge.fp8_tree``) put in the program's place; its verdict
(``control_correct``) has to come out false. ``token`` and ``half`` plant
a fault of ``harness/faults.py`` in the timed path (a token altered where
it is produced; half of each batch answered with the other half's rows);
their ``correct`` has to come out false. Each run prints one JSON line."""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

import run as R  # noqa: E402
from harness import faults  # noqa: E402

VARIANTS = ("program", "fp8ref") + tuple(faults.FAULTS)


def main(argv=None) -> int:
    R.steady_host()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--variants", nargs="+", choices=VARIANTS,
                    default=["program"])
    args = ap.parse_args(argv)
    for variant in args.variants:
        for seed in args.seeds:
            res = R.execute(args.workload, seed, args.seconds, False,
                            fault=faults.FAULTS.get(variant),
                            control=variant == "fp8ref", detail=True)
            line = {"variant": variant, "seed": seed,
                    "attempted": res["attempted"],
                    "correct": res["correct"],
                    "distinct_answers": res["distinct_answers"],
                    "judged": res["judged"],
                    **{k: v["value"] for k, v in res["checks"].items()},
                    "metrics": {k: v["value"] for k, v in
                                res["metrics"].items()}}
            if "control_correct" in res:
                line["control_correct"] = res["control_correct"]
                line["control_checks"] = res["control_checks"]
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
