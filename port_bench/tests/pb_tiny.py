"""A small configuration of each encoder and a cell over it, for the CPU
tests: the real image size and vocab, narrow widths, 20 output tokens."""

from __future__ import annotations

import copy
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, REPO_ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest  # noqa: E402

TINY = {"d_model": 32, "nhead": 2, "dim_feedforward": 64,
        "num_decoder_layers": 2}
TINY_SWIN = {"embed_dim": 8, "depths": [2, 2, 2, 2],
             "num_heads": [1, 1, 2, 2]}
TINY_RESNET = {"stage_channels": [8, 8, 16, 16], "stage_blocks": [1, 1, 1, 1]}


def tiny_config(encoder: str = "swin_t", dtype: str = "float32") -> dict:
    with open(os.path.join(BENCH_DIR, "configs", "swin_t_r4.json")) as f:
        config = json.load(f)
    model = config["model"]
    model.update(TINY, encoder=encoder, dtype=dtype)
    model["swin"].update(TINY_SWIN)
    model["resnet"].update(TINY_RESNET)
    config["weights"] = {"kind": "seeded",
                         "head_bias": {"<pad>": -1e4, "<sos>": -1e4}}
    return config


def tiny_cell(traffic: str = "bulk_closed", encoder: str = "swin_t",
              dtype: str = "float32", eos_bias: float = 0.0,
              **traffic_kw) -> manifest.Cell:
    with open(os.path.join(BENCH_DIR, "traffic", f"{traffic}.json")) as f:
        t = json.load(f)
    t.update(traffic_kw)
    man = manifest.load_manifest()
    name = f"tiny.{traffic}"
    config = tiny_config(encoder, dtype)
    if eos_bias:
        config["weights"]["head_bias"]["<eos>"] = eos_bias
    return manifest.Cell(name, "tiny", traffic, 1, config, t,
                         copy.deepcopy(man["end_to_end"]),
                         copy.deepcopy(man["per_layer"]))
