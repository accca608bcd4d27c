"""The serving artifact's orbax checkpoint as a tree of numpy arrays.

A frozen copy of ``restore_tree`` and ``_containers`` of
``handwritten_math_ocr_api_torch/train/checkpoint.py`` at commit
e13765f3a37352e31b622845f2ae26a6960b06e8, over the frozen OCDBT and zstd
readers beside it. bfloat16 leaves are widened to float32 numpy arrays
(exactly), so that the program and the reference get one tree."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from .frozen_ocdbt import OcdbtStore, read_array

_DICT_KEY, _LIST_INDEX = 2, 1
_EMPTY = {"Dict": dict, "List": list, "None": lambda: None}
_ARRAYS = ("jax.Array", "np.ndarray", "scalar")


def _numpy(leaf):
    if isinstance(leaf, np.ndarray):
        return leaf
    return leaf.float().numpy()  # a bfloat16 tensor


def restore_tree(ckpt_dir: str):
    with open(os.path.join(ckpt_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{ckpt_dir}: only OCDBT with zarr v2 is read")
    store = OcdbtStore(ckpt_dir)
    root: Dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if value.get("skip_deserialize"):
            if kind not in _EMPTY:
                raise ValueError(f"{ckpt_dir}: value type {kind!r}")
            leaf = _EMPTY[kind]()
        elif kind in _ARRAYS:
            leaf = _numpy(read_array(store, ".".join(k["key"]
                                                      for k in keys)))
        else:
            raise ValueError(f"{ckpt_dir}: value type {kind!r}")
        node = root
        for k in keys[:-1]:
            node = node.setdefault((k["key_type"], k["key"]), {})
        node[(keys[-1]["key_type"], keys[-1]["key"])] = leaf
    return _containers(root, ckpt_dir)


def _containers(node, where: str):
    if not isinstance(node, dict) or not node:
        return node
    types = {t for t, _ in node}
    if types == {_DICT_KEY}:
        return {k: _containers(v, where) for (_, k), v in node.items()}
    if types == {_LIST_INDEX}:
        items = sorted((int(k), v) for (_, k), v in node.items())
        if [i for i, _ in items] != list(range(len(items))):
            raise ValueError(f"{where}: list indices are not 0..n-1")
        return [_containers(v, where) for _, v in items]
    raise ValueError(f"{where}: key types {sorted(types)}")


def load_serving(directory: str):
    """(params, model_state) of a serving artifact's ``params/``."""
    tree = restore_tree(os.path.join(directory, "params"))
    if isinstance(tree, dict) and "params" in tree:
        return tree["params"], tree.get("model_state") or {}
    return tree, {}
