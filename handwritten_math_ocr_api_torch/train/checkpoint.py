"""Loading the serving artifact that the JAX package's
``train/checkpoint.py::save_params_for_serving`` writes.

An artifact directory holds ``params/`` (an orbax PyTree checkpoint in OCDBT
format with zarr v2 arrays), ``vocab.json`` and ``model_config.json``. The
port reads the checkpoint without orbax or tensorstore
(``utils/ocdbt.py``): ``_METADATA``'s ``tree_metadata`` lists every leaf
with the keys of its path (``key_type`` 2 a dict key, 1 a list index) and
its value type, and each array is read by its path joined with dots. The
tree comes back as nested dicts and lists of numpy arrays, the structure
the JAX loader restores (a ``bfloat16`` leaf comes back as a CPU
``torch.bfloat16`` tensor: numpy has no such dtype).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.config import ModelConfig, load_model_config
from ..core.tokenizer import load_vocab
from ..utils.ocdbt import OcdbtStore, read_array

_DICT_KEY, _LIST_INDEX = 2, 1
_EMPTY = {"Dict": dict, "List": list, "None": lambda: None}
_ARRAYS = ("jax.Array", "np.ndarray", "scalar")


def restore_tree(ckpt_dir: str):
    """The PyTree of the orbax checkpoint in ``ckpt_dir``, leaves as numpy
    arrays (``bfloat16``: torch tensors)."""
    with open(os.path.join(ckpt_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{ckpt_dir}: a checkpoint without OCDBT is not "
                         "implemented")
    if meta.get("use_zarr3", False):
        raise ValueError(f"{ckpt_dir}: zarr3 arrays are not implemented")
    store = OcdbtStore(ckpt_dir)
    root: Dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if value.get("skip_deserialize"):
            if kind not in _EMPTY:
                raise ValueError(f"{ckpt_dir}: value type {kind!r} not "
                                 "implemented")
            leaf = _EMPTY[kind]()
        elif kind in _ARRAYS:
            leaf = read_array(store, ".".join(k["key"] for k in keys))
        else:
            raise ValueError(f"{ckpt_dir}: value type {kind!r} not "
                             "implemented")
        node = root
        for k in keys[:-1]:
            node = node.setdefault((k["key_type"], k["key"]), {})
        node[(keys[-1]["key_type"], keys[-1]["key"])] = leaf
    return _containers(root, ckpt_dir)


def _containers(node, where: str):
    """Nested ``{(key_type, key): child}`` -> dicts and lists."""
    if not isinstance(node, dict) or not node:
        return node
    types = {t for t, _ in node}
    if types == {_DICT_KEY}:
        return {k: _containers(v, where) for (_, k), v in node.items()}
    if types == {_LIST_INDEX}:
        items = sorted((int(k), v) for (_, k), v in node.items())
        if [i for i, _ in items] != list(range(len(items))):
            raise ValueError(f"{where}: list indices {[i for i, _ in items]}"
                             " are not 0..n-1")
        return [_containers(v, where) for _, v in items]
    raise ValueError(f"{where}: key types {sorted(types)} not implemented")


def load_params_for_serving(directory: str):
    """Returns (params, model_state, vocab, idx2char, ModelConfig), as the
    JAX package's loader does: the current artifact's tree is
    ``{"params", "model_state"}``, a legacy one holds the params alone."""
    path = os.path.abspath(directory)
    vocab, idx2char = load_vocab(os.path.join(path, "vocab.json"))
    cfg: ModelConfig = load_model_config(path)
    tree = restore_tree(os.path.join(path, "params"))
    if isinstance(tree, dict) and "params" in tree:  # current format
        params = tree["params"]
        model_state = tree.get("model_state") or {}
    else:  # legacy params-only artifact
        params, model_state = tree, {}
    return params, model_state, vocab, idx2char, cfg


def leaves_with_paths(tree, path: Tuple[str, ...] = ()) -> List:
    """("/"-joined path, leaf) of every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves_with_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_paths(v, path + (str(i),))]
    return [("/".join(path), tree)]


def tree_digest(tree) -> str:
    """sha256 over the leaves sorted by path (``leaves_with_paths``; list
    indices as decimal strings): each leaf's path, dtype name, shape and
    C-order bytes. The
    same tree gives the same digest from numpy leaves (``ml_dtypes``'
    bfloat16 too) and from tensors."""
    h = hashlib.sha256()
    for path, leaf in sorted(leaves_with_paths(tree), key=lambda x: x[0]):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            dtype = str(t.dtype).replace("torch.", "")
            shape = tuple(t.shape)
            data = (t.view(torch.int16) if t.dtype == torch.bfloat16
                    else t).numpy().tobytes()
        else:
            a = np.asarray(leaf)
            dtype, shape, data = str(a.dtype), a.shape, a.tobytes()
        h.update(f"{path}\0{dtype}\0{shape}\0".encode())
        h.update(data)
    return h.hexdigest()
