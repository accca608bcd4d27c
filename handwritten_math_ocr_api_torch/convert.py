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

The ResNet encoders (``resnet18``, ``res18trans``) add their trunk
(Kaiming-normal HWIO convolutions, N(0, 2 / fan_in), and BatchNorm
``scale``/``bias``: 1 and 0 in ``init_params``, 1 + N(0, 0.05^2) and
N(0, 0.05^2) in ``random_params``) and, for ``res18trans``, the
transformer encoder (``trans_encoder``). Their BatchNorm running
statistics are the model state, a tree of its own: ``init_state`` (mean
0, var 1, as the JAX ``init_resnet_params``) or ``random_state`` (mean
N(0, 0.05^2), var 1 + |N(0, 0.1^2)|, so that a check sees a statistic
that is dropped or misplaced); ``{}`` for Swin. ``state_to_torch`` carries
a state tree onto a device in float32, as the JAX package keeps it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.config import ModelConfig
from .core.device import resolve_device
from .utils import tree

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


def state_to_torch(state, device=None):
    """A model state (BatchNorm statistics; nested dicts and lists of
    arrays or tensors) -> the same structure of float32 tensors on
    ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    return tree.map_tree(
        lambda t: torch.as_tensor(np.array(t) if not torch.is_tensor(t)
                                  else t).to(dev, torch.float32).contiguous(),
        state or {})


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

    def conv(self, kh: int, kw: int, cin: int, cout: int):
        """Kaiming normal for ReLU nets: N(0, 2 / fan_in), HWIO."""
        return {"w": self.normal((kh, kw, cin, cout),
                                 math.sqrt(2.0 / (kh * kw * cin)))}

    def stats(self, dim: int):
        """BatchNorm running statistics, perturbed away from 0 and 1."""
        return {"mean": self.bias(dim),
                "var": 1.0 + np.abs(self.normal((dim,), 0.1))}


class _FreshInit(_Init):
    """``init_model``'s initialisers: zero biases, LayerNorm scale 1 and
    bias 0 (the weights drawn as ``_Init`` draws them)."""

    def bias(self, dim: int) -> np.ndarray:
        return np.zeros((dim,), np.float32)

    def norm(self, dim: int):
        return {"scale": np.ones((dim,), np.float32),
                "bias": np.zeros((dim,), np.float32)}

    def stats(self, dim: int):
        return {"mean": np.zeros((dim,), np.float32),
                "var": np.ones((dim,), np.float32)}


def random_params(cfg: ModelConfig, seed: int = 0):
    """A seeded numpy parameter tree for a ``ModelConfig``."""
    return _tree(cfg, _Init(seed))


def random_state(cfg: ModelConfig, seed: int = 0):
    """The model state (BatchNorm statistics) that goes with
    ``random_params``: perturbed, from a generator of its own; ``{}`` for
    Swin."""
    return _state(cfg, _Init(seed + 10_007))  # not random_params' draws


def init_state(cfg: ModelConfig):
    """The model state of a fresh model: BatchNorm mean 0 and var 1 (the
    JAX ``init_model``'s); ``{}`` for Swin."""
    return _state(cfg, _FreshInit(0))


def init_params(cfg: ModelConfig, seed: int = 0):
    """The tree of a freshly initialised model, as the JAX package's
    ``init_model`` builds it: xavier-uniform matrices, zero biases, unit
    LayerNorm scales, N(0, 0.02^2) embedding, position and relative-bias
    tables, the patch embedding N(0, 1 / (ps^2 Cin)); float32 numpy leaves
    drawn from a numpy generator seeded by ``seed``."""
    return _tree(cfg, _FreshInit(seed))


def _resnet_blocks(cfg: ModelConfig):
    """(stage, block, cin, cout, stride, has downsample) of the trunk."""
    rc = cfg.resnet
    cin = rc.stage_channels[0]
    for i, (cout, n) in enumerate(zip(rc.stage_channels, rc.stage_blocks)):
        for b in range(n):
            stride = 2 if (b == 0 and i > 0) else 1
            yield i, b, cin, cout, stride, stride != 1 or cin != cout
            cin = cout


def _resnet_tree(cfg: ModelConfig, init: _Init):
    rc = cfg.resnet
    c0 = rc.stage_channels[0]
    enc = {"conv1": init.conv(7, 7, rc.in_channels, c0),
           "bn1": init.norm(c0),
           "layers": [[] for _ in rc.stage_channels]}
    for i, _, cin, cout, _, down in _resnet_blocks(cfg):
        block = {"conv1": init.conv(3, 3, cin, cout),
                 "bn1": init.norm(cout),
                 "conv2": init.conv(3, 3, cout, cout),
                 "bn2": init.norm(cout)}
        if down:
            block["downsample"] = {"conv": init.conv(1, 1, cin, cout),
                                   "bn": init.norm(cout)}
        enc["layers"][i].append(block)
    return enc


def _state(cfg: ModelConfig, init: _Init):
    if cfg.encoder == "swin_t":
        return {}
    rc = cfg.resnet
    st = {"bn1": init.stats(rc.stage_channels[0]),
          "layers": [[] for _ in rc.stage_channels]}
    for i, _, _, cout, _, down in _resnet_blocks(cfg):
        block = {"bn1": init.stats(cout), "bn2": init.stats(cout)}
        if down:
            block["downsample"] = {"bn": init.stats(cout)}
        st["layers"][i].append(block)
    return {"resnet": st}


def _trans_encoder(cfg: ModelConfig, init: _Init):
    d = cfg.d_model
    return {"layers": [{"self_attn": init.mha(d), "norm1": init.norm(d),
                        "norm2": init.norm(d),
                        "ffn": init.mlp(d, cfg.dim_feedforward)}
                       for _ in range(cfg.num_encoder_layers)],
            "pos": {"table": init.normal((cfg.encoder_len, d), 0.02)}}


def _tree(cfg: ModelConfig, init: _Init):
    if cfg.encoder not in ("swin_t", "resnet18", "res18trans"):
        raise ValueError(f"unknown encoder: {cfg.encoder}")
    if cfg.encoder == "swin_t":
        encoder, features = _swin_tree(cfg, init), cfg.swin.num_features
    else:
        encoder = _resnet_tree(cfg, init)
        features = cfg.resnet.stage_channels[-1]
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
              "projection": init.linear(features, d),
              "decoder": decoder}
    if cfg.encoder == "res18trans":
        params["trans_encoder"] = _trans_encoder(cfg, init)
    if cfg.memory_norm:
        params["memory_norm"] = init.norm(d)
    return params


def _swin_tree(cfg: ModelConfig, init: _Init):
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
    return encoder
