"""The harness finds cells, mixes, configurations and metrics by name, so
that a later change adds them as new files and entries only."""

import json
import os
import shutil

import pb_tiny
import pytest

from harness import manifest
from harness.run_state import Run


def _copy_bench(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "port_bench"
    shutil.copytree(pb_tiny.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(pb_tiny.REPO_ROOT, "BENCHMARK.json"), root)
    return root, bench


def test_every_cell_of_the_manifest_resolves():
    man = manifest.load_manifest()
    for w in man["workloads"]:
        cell = manifest.find_cell(w["name"])
        assert cell.traffic["entry"] and cell.traffic["generator"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for kind, name in (("entries", cell.traffic["entry"]),
                           ("generators", cell.traffic["generator"])):
            manifest.load_module(kind, name)
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(manifest.load_module("metrics", m["name"]),
                           "read")
        limits = os.path.join(pb_tiny.BENCH_DIR, "limits",
                              f"{w['name']}.json")
        assert set(json.load(open(limits))["limits"]) == {
            "mean_gap", "mean_conf_err", "unparsed", "failed"}


def test_per_layer_metrics_report_only_where_their_metric_is():
    man = manifest.load_manifest()
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]] & cells


def test_a_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    root, bench = _copy_bench(tmp_path)
    (bench / "traffic" / "bulk_small.json").write_text(json.dumps(
        {"entry": "batching", "generator": "closed", "clients": 2,
         "images_per_request": 1}))
    (bench / "metrics" / "answers.bulk_small.py").write_text(
        "def read(run):\n    return len(run.done_in_window()) or None\n")
    cfg = json.load(open(bench / "configs" / "swin_t_r4.json"))
    cfg["model"]["dim_feedforward"] = 1024
    (bench / "configs" / "swin_wide.json").write_text(json.dumps(cfg))
    man = json.load(open(root / "BENCHMARK.json"))
    man["configs"].append({"name": "swin_wide", "source": "x",
                           "file": "port_bench/configs/swin_wide.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "swin_wide.bulk_small",
                             "config": "swin_wide", "traffic": "bulk_small",
                             "chips": 1, "why": "x"})
    man["end_to_end"][0]["workloads"].append("swin_wide.bulk_small")
    man["per_layer"].append({"name": "answers.bulk_small", "unit": "n",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "images_per_s",
                             "workloads": ["swin_wide.bulk_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.find_cell("swin_wide.bulk_small", root=str(root))
    assert cell.config["model"]["dim_feedforward"] == 1024
    assert cell.traffic["clients"] == 2
    assert [m["name"] for m in cell.per_layer] == ["answers.bulk_small"]
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s",
                                                    "setup_s"}
    run = Run(cell.name, cell.config, cell.traffic, 1, 1.0, True)
    assert manifest.read_metrics(cell.per_layer, run, str(bench)) == {}
    with pytest.raises(KeyError):
        manifest.find_cell("no.such_cell", root=str(root))
