"""Training checkpoints and serving artifacts.

The port of ``handwritten_math_ocr_api_tpu/train/checkpoint.py``.

Training checkpoints, ``<dir>/<name>/``: ``state.pt``, a ``torch.save`` of
plain containers of CPU tensors (``params``, ``opt_state``,
``model_state``, ``step`` and, when tracked, ``ema_params``; loaded with
``weights_only=True``), and ``train_meta.json`` with the JAX package's keys
(``epoch``, ``metric_value``, ``scheduler``, ``extra``). A checkpoint that
the JAX package wrote (an orbax OCDBT directory) is read too, its
``params``, ``ema_params``, ``step`` and ``model_state`` only
(``params_only=True``): its optimizer state belongs to optax.

Serving artifacts: ``params/``, ``vocab.json`` and ``model_config.json``.
``load_params_for_serving`` reads the JAX package's, whose ``params/`` is an
orbax PyTree checkpoint in OCDBT format with zarr v2 arrays, without orbax
or tensorstore (``utils/ocdbt.py``): ``_METADATA``'s ``tree_metadata``
lists every leaf with the keys of its path (``key_type`` 2 a dict key, 1 a
list index) and its value type, and each array is read by its path joined
with dots. The tree comes back as nested dicts and lists of numpy arrays,
the structure the JAX loader restores (a ``bfloat16`` leaf comes back as a
CPU ``torch.bfloat16`` tensor: numpy has no such dtype). It also reads the
port's own artifacts, whose ``params/`` holds ``params.pt``
(``save_params_for_serving``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import ModelConfig, load_model_config
from ..core.tokenizer import load_vocab, save_vocab
from ..parallel.mesh import full_tensors, is_dtensor
from ..utils import tree as tree_lib
from ..utils.ocdbt import OcdbtStore, read_array

_META = "train_meta.json"
_STATE = "state.pt"
_PARAMS = "params.pt"

_DICT_KEY, _LIST_INDEX = 2, 1
_EMPTY = {"Dict": dict, "List": list, "None": lambda: None}
_ARRAYS = ("jax.Array", "np.ndarray", "scalar")


def restore_tree(ckpt_dir: str, keys=None):
    """The PyTree of the orbax checkpoint in ``ckpt_dir``, leaves as numpy
    arrays (``bfloat16``: torch tensors); with ``keys``, only the top-level
    entries named there."""
    with open(os.path.join(ckpt_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{ckpt_dir}: a checkpoint without OCDBT is not "
                         "implemented")
    if meta.get("use_zarr3", False):
        raise ValueError(f"{ckpt_dir}: zarr3 arrays are not implemented")
    store = OcdbtStore(ckpt_dir)
    root: Dict = {}
    wanted = keys
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        if wanted is not None and keys[0]["key"] not in wanted:
            continue
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
    ours = os.path.join(path, "params", _PARAMS)
    if os.path.exists(ours):
        tree = _to_numpy(torch.load(ours, map_location="cpu",
                                    weights_only=True))
    else:
        tree = restore_tree(os.path.join(path, "params"))
    if isinstance(tree, dict) and "params" in tree:  # current format
        params = tree["params"]
        model_state = tree.get("model_state") or {}
    else:  # legacy params-only artifact
        params, model_state = tree, {}
    return params, model_state, vocab, idx2char, cfg


def _cpu(node):
    """Every tensor or numpy array of ``node`` as a CPU tensor of its own
    (``torch.save``'s ``weights_only`` load takes tensors, not arrays)."""
    def leaf(x):
        if torch.is_tensor(x):
            return x.detach().cpu().clone()
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(x))
        return x

    return tree_lib.map_tree(leaf, node)


def _to_numpy(node):
    """float32 and integer tensors to numpy arrays (bfloat16 stays a
    tensor, as the OCDBT reader returns it)."""
    return tree_lib.map_tree(
        lambda x: (x.numpy() if torch.is_tensor(x)
                   and x.dtype != torch.bfloat16 else x), node)


def save_checkpoint(directory: str, name: str, state, epoch: int,
                    metric: float, scheduler_state: Optional[Dict] = None,
                    extra: Optional[Dict] = None) -> str:
    """Write ``<directory>/<name>/`` (state.pt and train_meta.json);
    returns its path. A state on a device mesh (DTensors) is gathered
    whole, by every rank, and written by rank 0 alone, in the one-device
    format."""
    path = os.path.abspath(os.path.join(directory, name))
    with torch.no_grad():
        whole = [full_tensors(t) for t in (state.params, state.opt_state,
                                           state.model_state,
                                           state.ema_params)]
    if dist.is_initialized() and dist.get_rank() != 0:
        return path
    os.makedirs(path, exist_ok=True)
    params, opt_state, model_state, ema_params = (_cpu(t) for t in whole)
    tree = {"params": params, "opt_state": opt_state,
            "model_state": model_state, "step": int(state.step)}
    if ema_params is not None:
        tree["ema_params"] = ema_params
    tmp = os.path.join(path, _STATE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, _STATE))
    meta = {"epoch": epoch, "metric_value": metric,
            "scheduler": scheduler_state or {}, "extra": extra or {}}
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)
    return path


def _read_saved(path: str, params_only: bool) -> Dict:
    """The saved tree of a port checkpoint, or the params, EMA, step and
    model state of a JAX one (leaves: tensors or numpy arrays)."""
    ours = os.path.join(path, _STATE)
    if os.path.exists(ours):
        return torch.load(ours, map_location="cpu", weights_only=True)
    if not os.path.exists(os.path.join(path, "_METADATA")):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if not params_only:
        raise ValueError(f"{path} was written by the JAX package: its "
                         "optimizer state is optax's; restore it with "
                         "params_only=True")
    return restore_tree(path, keys=("params", "ema_params", "step",
                                    "model_state"))


def _like(template, saved, what: str):
    """``saved`` (a tree, any dict order) in the structure of ``template``,
    each leaf a tensor of the template leaf's dtype on its device (a
    DTensor leaf's: placed as it is); a missing leaf or another shape
    raises ValueError."""
    by_path = dict(zip(tree_lib.paths(saved), tree_lib.leaves(saved)))
    want = tree_lib.paths(template)
    if set(by_path) != set(want):
        raise ValueError(f"{what}: the checkpoint's tree does not match "
                         f"this model's ({len(by_path)} leaves saved, "
                         f"{len(want)} wanted)")

    def take(t, p):
        x = by_path[p]
        x = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"{what}: {'/'.join(p)} is {tuple(x.shape)} in "
                             f"the checkpoint, {tuple(t.shape)} here")
        if is_dtensor(t):
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(x.to(device=t.device, dtype=t.dtype),
                                     t.device_mesh, t.placements)
        return x.to(device=t.device, dtype=t.dtype)

    flat = [take(t, p) for t, p in zip(tree_lib.leaves(template), want)]
    return tree_lib.unflatten(template, flat)


def load_checkpoint(directory: str, name: str, template,
                    params_only: bool = False):
    """(state, meta): the checkpoint ``<directory>/<name>`` restored into
    the structure, dtypes and device of ``template`` (a ``TrainState``).

    ``params_only`` keeps the template's optimizer state: an evaluation, an
    export or a resume under another optimizer chain must not depend on
    the training run's. Otherwise an optimizer state of another structure
    (warmup toggled, another model) raises ValueError, as orbax's restore
    does in the JAX package. The model state (a ResNet encoder's
    BatchNorm statistics) is restored into the template's, on its device
    in float32. The EMA: restored when the template tracks it
    and the checkpoint has it; a checkpoint without it seeds the shadow as
    a copy of the restored params (never the same tensors, which the step
    updates in place)."""
    path = os.path.abspath(os.path.join(directory, name))
    saved = _read_saved(path, params_only)
    params = _like(template.params, saved["params"], "params")
    params = tree_lib.map_tree(lambda p: p.requires_grad_(True), params)
    opt_state = template.opt_state
    if not params_only:
        if "opt_state" not in saved:
            raise ValueError(f"{path} holds no optimizer state")
        opt_state = _like(template.opt_state, saved["opt_state"],
                          "optimizer state")
    ema = template.ema_params
    if ema is not None:
        if "ema_params" in saved:
            ema = _like(template.ema_params, saved["ema_params"],
                        "ema_params")
        else:
            ema = tree_lib.map_tree(lambda p: p.detach().clone(), params)
    model_state = saved.get("model_state") or {}
    if model_state:
        model_state = _like(template.model_state, model_state,
                            "model_state")
    step = saved.get("step", 0)
    state = template.replace(params=params, opt_state=opt_state,
                             model_state=model_state or template.model_state,
                             step=int(np.asarray(step)), ema_params=ema)
    meta_path = os.path.join(path, _META)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def save_params_for_serving(directory: str, params, vocab: Dict[str, int],
                            model_cfg: ModelConfig,
                            model_state: Optional[Dict] = None) -> str:
    """A serving artifact: ``params/params.pt`` (the params and model
    state, float32 CPU tensors), ``vocab.json`` and ``model_config.json``,
    which ``load_params_for_serving`` (and so the serving app) reads."""
    path = os.path.abspath(directory)
    os.makedirs(os.path.join(path, "params"), exist_ok=True)
    torch.save({"params": _cpu(params),
                "model_state": _cpu(model_state or {})},
               os.path.join(path, "params", _PARAMS))
    save_vocab(vocab, os.path.join(path, "vocab.json"))
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(dataclasses.asdict(model_cfg), f, indent=2)
    return path


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
