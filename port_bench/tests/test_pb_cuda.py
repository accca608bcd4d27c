"""The benchmark on the card: one short run of each cell prints a correct
result line with the cell's metrics, and at the cell's own size and
committed limits the control and the planted faults come out not correct.
Run on the H100 machine with ``python -m pytest port_bench/tests -m cuda``."""

import json
import os
import subprocess
import sys

import pb_tiny
import pytest

from harness import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


def _on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark runs on the card only)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace):
    _on_the_card()
    out = subprocess.run(
        [sys.executable, os.path.join(pb_tiny.BENCH_DIR, "run.py"),
         "--workload", cell, "--seed", str(2 ** 31 + 17), "--seconds", "3",
         "--trace", str(trace)], capture_output=True, text=True,
        timeout=900, cwd=pb_tiny.REPO_ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    c = manifest.find_cell(cell)
    want = c.per_layer if trace else c.end_to_end
    assert set(res["metrics"]) <= {m["name"] for m in want}
    assert list(res)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_faults_fail_the_committed_limits(cell):
    """``control.py`` at the cell's size: the program correct, the float8
    reference's verdict false, and each planted fault not correct."""
    _on_the_card()
    out = subprocess.run(
        [sys.executable, os.path.join(pb_tiny.BENCH_DIR, "control.py"),
         "--workload", cell, "--seeds", str(2 ** 31 + 23), "--seconds",
         "3", "--variants", "fp8ref", "token", "half"],
        capture_output=True, text=True, timeout=900, cwd=pb_tiny.REPO_ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = {d["variant"]: d for d in
             map(json.loads, out.stdout.strip().splitlines())}
    assert lines["fp8ref"]["correct"], lines["fp8ref"]
    assert lines["fp8ref"]["control_correct"] is False, lines["fp8ref"]
    assert not lines["token"]["correct"], lines["token"]
    assert not lines["half"]["correct"], lines["half"]
