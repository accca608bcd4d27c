"""The weights a cell runs with: the shipped checkpoint, or weights drawn
from the run's seed on the card.

Both kinds are made by the benchmark and handed, the same tree, to the
program and to the reference. Seeded weights are drawn by a
``torch.Generator`` on the device in two large calls (one uniform and one
normal buffer, sliced into the leaves), in the layout of the port's and the
JAX package's parameter tree, with their initialisers' scales: xavier-uniform
matrices, N(0, 2 / fan_in) convolutions, N(0, 0.02^2) tables, N(0, 0.05^2)
biases, LayerNorm and BatchNorm scales 1 + N(0, 0.05^2). The BatchNorm
statistics are mean 0 and variance 1. A configuration may take its decoder
(and ``memory_norm``) from a shipped checkpoint instead (``decoder_from``),
so that the encoder alone is drawn; the head biases that it names are then
set to its value."""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import torch

from . import checkpoint
from .manifest import REPO_ROOT

# (path, shape, kind, scale): kind "u" uniform in +-scale, "n" normal
# times scale, plus 1 for "n1" (norm scales), "c" a constant
Spec = List[Tuple[tuple, tuple, str, float]]


def _linear(spec, path, fi, fo, bias=True):
    spec.append((path + ("w",), (fi, fo), "u", math.sqrt(6.0 / (fi + fo))))
    if bias:
        spec.append((path + ("b",), (fo,), "n", 0.05))


def _norm(spec, path, d):
    spec.append((path + ("scale",), (d,), "n1", 0.05))
    spec.append((path + ("bias",), (d,), "n", 0.05))


def _mha(spec, path, d, kvd):
    n = d + 2 * kvd
    spec.append((path + ("w_qkv",), (d, n), "u", math.sqrt(6.0 / (d + n))))
    spec.append((path + ("b_qkv",), (n,), "n", 0.05))
    spec.append((path + ("w_out",), (d, d), "u", math.sqrt(3.0 / d)))
    spec.append((path + ("b_out",), (d,), "n", 0.05))


def _conv(spec, path, k, cin, cout):
    spec.append((path + ("w",), (k, k, cin, cout), "n",
                 math.sqrt(2.0 / (k * k * cin))))


def resnet18_spec(model: dict) -> Tuple[Spec, Spec]:
    """(params spec, model state spec) of a ResNet-18 model."""
    rc, d = model["resnet"], model["d_model"]
    p: Spec = []
    s: Spec = []
    c0 = rc["stage_channels"][0]
    _conv(p, ("encoder", "conv1"), 7, rc["in_channels"], c0)
    _norm(p, ("encoder", "bn1"), c0)
    s += [(("resnet", "bn1", "mean"), (c0,), "c", 0.0),
          (("resnet", "bn1", "var"), (c0,), "c", 1.0)]
    cin = c0
    for i, (cout, nb) in enumerate(zip(rc["stage_channels"],
                                       rc["stage_blocks"])):
        for b in range(nb):
            stride = 2 if (b == 0 and i > 0) else 1
            base = ("encoder", "layers", i, b)
            _conv(p, base + ("conv1",), 3, cin, cout)
            _norm(p, base + ("bn1",), cout)
            _conv(p, base + ("conv2",), 3, cout, cout)
            _norm(p, base + ("bn2",), cout)
            names = ["bn1", "bn2"]
            if stride != 1 or cin != cout:
                _conv(p, base + ("downsample", "conv"), 1, cin, cout)
                _norm(p, base + ("downsample", "bn"), cout)
                names.append("downsample")
            for n in names:
                sp = ("resnet", "layers", i, b) + (
                    (n,) if n != "downsample" else ("downsample", "bn"))
                s += [(sp + ("mean",), (cout,), "c", 0.0),
                      (sp + ("var",), (cout,), "c", 1.0)]
            cin = cout
    _linear(p, ("projection",), rc["stage_channels"][-1], d)
    _decoder(p, model)
    if model.get("memory_norm"):
        _norm(p, ("memory_norm",), d)
    return p, s


def swin_spec(model: dict) -> Tuple[Spec, Spec]:
    """(params spec, model state spec) of a Swin-T model."""
    sc, d = model["swin"], model["d_model"]
    ps, dim, ws = sc["patch_size"], sc["embed_dim"], sc["window_size"]
    p: Spec = []
    p.append((("encoder", "patch_embed", "conv", "w"),
              (ps, ps, sc["in_channels"], dim), "n",
              1.0 / math.sqrt(ps * ps * sc["in_channels"])))
    p.append((("encoder", "patch_embed", "conv", "b"), (dim,), "n", 0.05))
    _norm(p, ("encoder", "patch_embed", "norm"), dim)
    for i, depth in enumerate(sc["depths"]):
        c = dim * 2 ** i
        for b in range(depth):
            base = ("encoder", "stages", i, "blocks", b)
            _norm(p, base + ("norm1",), c)
            _mha(p, base + ("attn",), c, c)
            p.append((base + ("attn", "rel_bias_table"),
                      ((2 * ws - 1) ** 2, sc["num_heads"][i]), "n", 0.02))
            _norm(p, base + ("norm2",), c)
            hid = int(c * sc["mlp_ratio"])
            _linear(p, base + ("mlp", "fc1"), c, hid)
            _linear(p, base + ("mlp", "fc2"), hid, c)
        if i < len(sc["depths"]) - 1:
            _norm(p, ("encoder", "merges", i, "norm"), 4 * c)
            _linear(p, ("encoder", "merges", i, "reduction"), 4 * c, 2 * c,
                    bias=False)
    _linear(p, ("projection",), dim * 2 ** (len(sc["depths"]) - 1), d)
    _decoder(p, model)
    if model.get("memory_norm"):
        _norm(p, ("memory_norm",), d)
    return p, []


def _decoder(p: Spec, model: dict) -> None:
    d, V, T = model["d_model"], model["vocab_size"], model["max_seq_len"]
    kvd = d // model["nhead"] * (model.get("nhead_kv") or model["nhead"])
    p.append((("decoder", "embedding", "table"), (V, d), "n", 0.02))
    p.append((("decoder", "pos", "table"), (T, d), "n", 0.02))
    for i in range(model["num_decoder_layers"]):
        base = ("decoder", "layers", i)
        _mha(p, base + ("self_attn",), d, kvd)
        _mha(p, base + ("cross_attn",), d, d)
        for n in ("norm1", "norm2", "norm3"):
            _norm(p, base + (n,), d)
        _linear(p, base + ("ffn", "fc1"), d, model["dim_feedforward"])
        _linear(p, base + ("ffn", "fc2"), model["dim_feedforward"], d)
    _linear(p, ("decoder", "fc_out"), d, V)


def _place(tree, path, value):
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        default = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            while len(node) <= k:
                node.append(default if isinstance(nxt, int) else {})
                default = [] if isinstance(nxt, int) else {}
            node = node[k]
        else:
            node = node.setdefault(k, default)
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = value
    else:
        node[path[-1]] = value


def draw(spec: Spec, gen: torch.Generator, device) -> dict:
    """The tree of ``spec``'s leaves, float32 on ``device``."""
    n_u = sum(math.prod(sh) for _, sh, k, _ in spec if k == "u")
    n_n = sum(math.prod(sh) for _, sh, k, _ in spec if k in ("n", "n1"))
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(n_n, generator=gen, device=device)
    tree: dict = {}
    iu = i_n = 0
    for path, shape, kind, scale in spec:
        size = math.prod(shape)
        if kind == "u":
            leaf = uni[iu:iu + size].view(shape) * scale
            iu += size
        elif kind in ("n", "n1"):
            leaf = nor[i_n:i_n + size].view(shape) * scale
            i_n += size
            if kind == "n1":
                leaf = leaf + 1.0
        else:
            leaf = torch.full(shape, scale, device=device)
        _place(tree, path, leaf.contiguous())
    return tree


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v, device) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32, device=device)


def load(config: dict, seed: int, device) -> Tuple[dict, dict]:
    """(params, model state) of the configuration, for this run's seed."""
    w = config["weights"]
    model = config["model"]
    if w["kind"] == "checkpoint":
        return checkpoint.load_serving(os.path.join(REPO_ROOT, w["dir"]))
    specs = {"resnet18": resnet18_spec, "swin_t": swin_spec}
    if w["kind"] != "seeded" or model["encoder"] not in specs:
        raise ValueError(f"weights {w!r} for encoder {model['encoder']!r}")
    # a configuration may fix its weights' seed (one model for every run,
    # as a checkpoint is); otherwise they are drawn from the run's seed
    gen = torch.Generator(device=device).manual_seed(
        int(w.get("seed", seed)) + 77)
    pspec, sspec = specs[model["encoder"]](model)
    params = draw(pspec, gen, device)
    state = draw(sspec, gen, device) if sspec else {}
    if w.get("decoder_from"):
        shipped, _ = checkpoint.load_serving(
            os.path.join(REPO_ROOT, w["decoder_from"]))
        for key in ("decoder", "memory_norm"):
            params[key] = _tensors(shipped[key], device)
    from .reference import Vocab

    vocab = Vocab(os.path.join(REPO_ROOT, config["vocab"]))
    for tok, value in w.get("head_bias", {}).items():
        params["decoder"]["fc_out"]["b"][vocab.ids[tok]] = float(value)
    return params, state
