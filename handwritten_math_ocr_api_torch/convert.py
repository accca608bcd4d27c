"""Parameters for the port: from the JAX package's tree, or seeded random.

The port keeps the JAX package's parameter tree as it is — nested dicts and
lists with the same names, linear weights ``(in, out)`` — with tensor
leaves. ``to_torch`` carries a tree whose leaves are numpy arrays (a JAX
tree after ``np.asarray`` on each leaf) or tensors onto a device:

- matmul weights and biases go to the compute dtype (``cfg.dtype``), the
  dtype the JAX functions cast them to at each use;
- LayerNorm scales and biases, embedding tables, relative-position bias
  tables and the output projection ``fc_out`` stay float32, as the JAX
  functions use them;
- in a tree from ``ops/quant.py::quantize_decoder_params``, the int8
  weights ``{k}_q`` stay int8 and their scales ``{k}_scale`` float32 (the
  JAX dequant matmul multiplies by them in float32).

``random_params`` builds a tree of the same structure and shapes as the JAX
package's ``init_model`` for the Swin-T encoder (any ``nhead_kv``: the
self-attention projection ``(D, D + 2 kvd)``), with numpy from a seed
(numpy's generator, so not the JAX values). Its weights follow
``init_model``'s initialisers; unlike a fresh ``init_model``, every bias
and every LayerNorm bias is drawn from N(0, 0.05^2) and every LayerNorm
scale from 1 + N(0, 0.05^2), as a trained model's are nonzero and not one
(the same draws as ``tests/torch_swin_oracle.py``'s state dict), so that a
check on these weights sees a bias or a norm parameter that a kernel drops
or misplaces. ``init_params`` builds the same tree with ``init_model``'s
own initialisers (zero biases, unit LayerNorm scales), the from-scratch
start of training.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.config import ModelConfig
from .core.device import resolve_device

_FLOAT32_LEAVES = {"scale", "bias", "table", "rel_bias_table"}


def to_torch(tree, cfg: ModelConfig, device=None):
    """Nested dicts/lists of arrays -> the same structure of tensors on
    ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    compute = getattr(torch, cfg.dtype)

    def walk(node, key, in_fc_out):
        if isinstance(node, dict):
            return {k: walk(v, k, in_fc_out or k == "fc_out")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key, in_fc_out) for v in node]
        t = (node if isinstance(node, torch.Tensor)
             else torch.from_numpy(np.array(node)))  # a writable copy
        if t.dtype == torch.int8:
            dtype = torch.int8
        elif (in_fc_out or key in _FLOAT32_LEAVES
              or key.endswith("_scale")):
            dtype = torch.float32
        else:
            dtype = compute
        return t.to(device=dev, dtype=dtype).contiguous()

    return walk(tree, None, False)


class _Init:
    """The JAX package's initialisers, drawn from one numpy generator, with
    the perturbed biases and norms of ``random_params``."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def xavier(self, fan_in: int, fan_out: int) -> np.ndarray:
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return self.rng.uniform(-limit, limit,
                                (fan_in, fan_out)).astype(np.float32)

    def normal(self, shape, std: float) -> np.ndarray:
        return (self.rng.standard_normal(shape) * std).astype(np.float32)

    def bias(self, dim: int) -> np.ndarray:
        return self.normal((dim,), 0.05)

    def linear(self, fan_in: int, fan_out: int, bias: bool = True):
        p = {"w": self.xavier(fan_in, fan_out)}
        if bias:
            p["b"] = self.bias(fan_out)
        return p

    def norm(self, dim: int):
        return {"scale": 1.0 + self.bias(dim), "bias": self.bias(dim)}

    def mha(self, d: int, kvd: int = 0):
        """The packed (d, d + 2 kvd) projection; kvd = d unless given
        (MQA/GQA self-attention: the KV heads' width)."""
        n = d + 2 * (kvd or d)
        return {"w_qkv": self.xavier(d, n), "b_qkv": self.bias(n),
                "w_out": self.xavier(d, d), "b_out": self.bias(d)}

    def mlp(self, d: int, hidden: int):
        return {"fc1": self.linear(d, hidden), "fc2": self.linear(hidden, d)}


class _FreshInit(_Init):
    """``init_model``'s initialisers: zero biases, LayerNorm scale 1 and
    bias 0 (the weights drawn as ``_Init`` draws them)."""

    def bias(self, dim: int) -> np.ndarray:
        return np.zeros((dim,), np.float32)

    def norm(self, dim: int):
        return {"scale": np.ones((dim,), np.float32),
                "bias": np.zeros((dim,), np.float32)}


def random_params(cfg: ModelConfig, seed: int = 0):
    """A seeded numpy parameter tree for a Swin-T ``ModelConfig``."""
    return _tree(cfg, _Init(seed))


def init_params(cfg: ModelConfig, seed: int = 0):
    """The tree of a freshly initialised model, as the JAX package's
    ``init_model`` builds it: xavier-uniform matrices, zero biases, unit
    LayerNorm scales, N(0, 0.02^2) embedding, position and relative-bias
    tables, the patch embedding N(0, 1 / (ps^2 Cin)); float32 numpy leaves
    drawn from a numpy generator seeded by ``seed``."""
    return _tree(cfg, _FreshInit(seed))


def _tree(cfg: ModelConfig, init: _Init):
    if cfg.encoder != "swin_t":
        raise NotImplementedError("only the swin_t encoder is ported")
    sc = cfg.swin
    ps, dim = sc.patch_size, sc.embed_dim
    encoder = {
        "patch_embed": {
            "conv": {"w": init.normal(
                (ps, ps, sc.in_channels, dim),
                1.0 / math.sqrt(ps * ps * sc.in_channels)),
                     "b": init.bias(dim)},
            "norm": init.norm(dim),
        },
        "stages": [],
        "merges": [],
    }
    ws = sc.window_size
    for i, depth in enumerate(sc.depths):
        sdim = dim * 2 ** i
        blocks = []
        for _ in range(depth):
            attn = init.mha(sdim)
            attn["rel_bias_table"] = init.normal(
                ((2 * ws - 1) ** 2, sc.num_heads[i]), 0.02)
            blocks.append({"norm1": init.norm(sdim), "attn": attn,
                           "norm2": init.norm(sdim),
                           "mlp": init.mlp(sdim, int(sdim * sc.mlp_ratio))})
        encoder["stages"].append({"blocks": blocks})
        if i < len(sc.depths) - 1:
            encoder["merges"].append({
                "norm": init.norm(4 * sdim),
                "reduction": init.linear(4 * sdim, 2 * sdim, bias=False)})
    d = cfg.d_model
    decoder = {
        "embedding": {"table": init.normal((cfg.vocab_size, d), 0.02)},
        "pos": {"table": init.normal((cfg.max_seq_len, d), 0.02)},
        "layers": [{"self_attn": init.mha(d, cfg.kv_dim),
                    "cross_attn": init.mha(d),
                    "norm1": init.norm(d), "norm2": init.norm(d),
                    "norm3": init.norm(d),
                    "ffn": init.mlp(d, cfg.dim_feedforward)}
                   for _ in range(cfg.num_decoder_layers)],
        "fc_out": init.linear(d, cfg.vocab_size),
    }
    params = {"encoder": encoder,
              "projection": init.linear(sc.num_features, d),
              "decoder": decoder}
    if cfg.memory_norm:
        params["memory_norm"] = init.norm(d)
    return params
