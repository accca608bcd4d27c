"""Reference PyTorch ``.pth`` checkpoint -> the port's parameter trees.

Port of ``handwritten_math_ocr_api_tpu/compat/torch_convert.py``, with its
own copy of every mapping: a user of the reference brings a trained model
across. It reads both of the reference's artifact styles, a training
checkpoint that bundles ``model_state_dict`` and a whole pickled module
(whose ``state_dict()`` is taken), for all three encoders, and returns the
trees the JAX converter returns, leaf for leaf, as float32 numpy arrays:
``(params, model_state)``, the model state holding a ResNet trunk's
BatchNorm running statistics.

Key mappings (torch's (out, in) linear weights become (in, out);
convolutions go from OIHW to HWIO):

- decoder: ``decoder.embedding``, ``decoder.pos_encoder``,
  ``decoder.{decoder|transformer_decoder}.layers.N.{self_attn,
  multihead_attn, linear1, linear2, norm1..3}``, ``decoder.fc_out``;
- Swin encoder (torchvision's ``swin_t`` under ``encoder.swin.features``):
  the patch embedding ``features.0.{0,2}``, the blocks of
  ``features.{1,3,5,7}``, the merges ``features.{2,4,6}``; the trunk's
  final norm and head are not read;
- ResNet encoder: ``encoder.features.{0,1,4..7}`` -> conv1, bn1 and the
  four stages, ``encoder.projection``, and for res18trans
  ``encoder.transformer_encoder``, whose positional table is zeros (the
  reference drew a new random one every forward: it cannot be recovered).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.config import ModelConfig


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` file -> {name: numpy array}: a state dict, a bundle
    holding ``model_state_dict``, or a whole pickled module (read with
    ``weights_only=False`` only when the safe load refuses it)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    elif isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {k: np.asarray(v.detach().cpu().numpy())
            for k, v in obj.items() if hasattr(v, "detach")}


def _lin(sd, prefix) -> Dict[str, np.ndarray]:
    p = {"w": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _ln(sd, prefix) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _mha(sd, prefix) -> Dict[str, np.ndarray]:
    return {"w_qkv": sd[f"{prefix}.in_proj_weight"].T,
            "b_qkv": sd[f"{prefix}.in_proj_bias"],
            "w_out": sd[f"{prefix}.out_proj.weight"].T,
            "b_out": sd[f"{prefix}.out_proj.bias"]}


def _conv(sd, key) -> Dict[str, np.ndarray]:
    return {"w": sd[key].transpose(2, 3, 1, 0)}  # OIHW -> HWIO


def convert_decoder(sd: Dict[str, np.ndarray], cfg: ModelConfig,
                    prefix: str = "decoder") -> Dict:
    """The reference's decoder -> the decoder tree. Its inner
    ``TransformerDecoder`` is ``decoder`` or ``transformer_decoder``."""
    inner = None
    for cand in ("decoder", "transformer_decoder"):
        if f"{prefix}.{cand}.layers.0.self_attn.in_proj_weight" in sd:
            inner = f"{prefix}.{cand}"
            break
    if inner is None:
        raise KeyError(f"no transformer decoder layers under '{prefix}.*'")
    layers = []
    for i in range(cfg.num_decoder_layers):
        lp = f"{inner}.layers.{i}"
        layers.append({
            "self_attn": _mha(sd, f"{lp}.self_attn"),
            "cross_attn": _mha(sd, f"{lp}.multihead_attn"),
            "norm1": _ln(sd, f"{lp}.norm1"),
            "norm2": _ln(sd, f"{lp}.norm2"),
            "norm3": _ln(sd, f"{lp}.norm3"),
            "ffn": {"fc1": _lin(sd, f"{lp}.linear1"),
                    "fc2": _lin(sd, f"{lp}.linear2")},
        })
    return {"embedding": {"table": sd[f"{prefix}.embedding.weight"]},
            "pos": {"table": sd[f"{prefix}.pos_encoder.weight"]},
            "layers": layers,
            "fc_out": _lin(sd, f"{prefix}.fc_out")}


def convert_swin_encoder(sd: Dict[str, np.ndarray], cfg: ModelConfig,
                         prefix: str = "encoder.swin") -> Dict:
    """torchvision ``swin_t`` keys (under ``prefix``) -> the Swin tree."""
    f = f"{prefix}.features" if prefix else "features"
    params = {
        "patch_embed": {
            "conv": {"w": sd[f"{f}.0.0.weight"].transpose(2, 3, 1, 0),
                     "b": sd[f"{f}.0.0.bias"]},
            "norm": _ln(sd, f"{f}.0.2"),
        },
        "stages": [],
        "merges": [],
    }
    for si, depth in enumerate(cfg.swin.depths):
        blocks = []
        for b in range(depth):
            bp = f"{f}.{2 * si + 1}.{b}"
            blocks.append({
                "norm1": _ln(sd, f"{bp}.norm1"),
                "attn": {
                    "w_qkv": sd[f"{bp}.attn.qkv.weight"].T,
                    "b_qkv": sd[f"{bp}.attn.qkv.bias"],
                    "w_out": sd[f"{bp}.attn.proj.weight"].T,
                    "b_out": sd[f"{bp}.attn.proj.bias"],
                    "rel_bias_table":
                        sd[f"{bp}.attn.relative_position_bias_table"],
                },
                "norm2": _ln(sd, f"{bp}.norm2"),
                "mlp": {"fc1": _lin(sd, f"{bp}.mlp.0"),
                        "fc2": _lin(sd, f"{bp}.mlp.3")},
            })
        params["stages"].append({"blocks": blocks})
        if si < len(cfg.swin.depths) - 1:
            mp = f"{f}.{2 * si + 2}"
            params["merges"].append({
                "norm": _ln(sd, f"{mp}.norm"),
                "reduction": {"w": sd[f"{mp}.reduction.weight"].T},
            })
    return params


def convert_torchvision_swin(sd: Dict[str, np.ndarray], cfg: ModelConfig
                             ) -> Dict:
    """A raw torchvision ``swin_t`` state dict (ImageNet weights) -> the
    Swin tree, its RGB patch convolution averaged into one input channel
    (the reference's 1-channel surgery): the start of ``train
    --init-from``."""
    sd = dict(sd)
    w = np.asarray(sd["features.0.0.weight"])
    if w.shape[1] == 3:
        sd["features.0.0.weight"] = w.mean(axis=1, keepdims=True)
    return convert_swin_encoder(sd, cfg, prefix="")


def _bn_from(sd, prefix) -> Tuple[Dict, Dict]:
    return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
            {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]})


def convert_resnet_encoder(sd: Dict[str, np.ndarray], cfg: ModelConfig,
                           prefix: str = "encoder.features"
                           ) -> Tuple[Dict, Dict]:
    """The reference's ResNet trunk (a Sequential of torchvision resnet's
    children but the last two: 0 conv1, 1 bn1, 4..7 the stages) ->
    (params, BatchNorm statistics)."""
    bn1_p, bn1_s = _bn_from(sd, f"{prefix}.1")
    params = {"conv1": _conv(sd, f"{prefix}.0.weight"), "bn1": bn1_p,
              "layers": []}
    state = {"bn1": bn1_s, "layers": []}
    for li, nblocks in enumerate(cfg.resnet.stage_blocks):
        blocks_p, blocks_s = [], []
        for b in range(nblocks):
            bp = f"{prefix}.{li + 4}.{b}"
            p1, s1 = _bn_from(sd, f"{bp}.bn1")
            p2, s2 = _bn_from(sd, f"{bp}.bn2")
            block_p = {"conv1": _conv(sd, f"{bp}.conv1.weight"), "bn1": p1,
                       "conv2": _conv(sd, f"{bp}.conv2.weight"), "bn2": p2}
            block_s = {"bn1": s1, "bn2": s2}
            if f"{bp}.downsample.0.weight" in sd:
                dp, ds = _bn_from(sd, f"{bp}.downsample.1")
                block_p["downsample"] = {
                    "conv": _conv(sd, f"{bp}.downsample.0.weight"), "bn": dp}
                block_s["downsample"] = {"bn": ds}
            blocks_p.append(block_p)
            blocks_s.append(block_s)
        params["layers"].append(blocks_p)
        state["layers"].append(blocks_s)
    return params, state


def convert_trans_encoder(sd: Dict[str, np.ndarray], cfg: ModelConfig,
                          prefix: str = "encoder.transformer_encoder"
                          ) -> Dict:
    """res18trans's transformer encoder -> its tree, with a zero
    positional table (the module docstring)."""
    layers = []
    for i in range(cfg.num_encoder_layers):
        lp = f"{prefix}.layers.{i}"
        layers.append({"self_attn": _mha(sd, f"{lp}.self_attn"),
                       "norm1": _ln(sd, f"{lp}.norm1"),
                       "norm2": _ln(sd, f"{lp}.norm2"),
                       "ffn": {"fc1": _lin(sd, f"{lp}.linear1"),
                               "fc2": _lin(sd, f"{lp}.linear2")}})
    return {"layers": layers,
            "pos": {"table": np.zeros((cfg.encoder_len, cfg.d_model),
                                      np.float32)}}


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_arrays(v) for v in tree]
    return np.ascontiguousarray(tree)


def convert_state_dict(sd: Dict[str, np.ndarray], cfg: ModelConfig
                       ) -> Tuple[Dict, Dict]:
    """A whole reference model's state dict -> (params, model_state),
    numpy leaves."""
    state: Dict = {}
    if cfg.encoder == "swin_t":
        enc = convert_swin_encoder(sd, cfg)
    else:
        enc, bn_state = convert_resnet_encoder(sd, cfg)
        state["resnet"] = bn_state
    params = {"encoder": enc,
              "projection": _lin(sd, "encoder.projection"),
              "decoder": convert_decoder(sd, cfg)}
    if cfg.encoder == "res18trans":
        params["trans_encoder"] = convert_trans_encoder(sd, cfg)
    return _arrays(params), _arrays(state)


def convert_checkpoint(pth_path: str, cfg: ModelConfig) -> Tuple[Dict, Dict]:
    """A ``.pth`` file -> (params, model_state)."""
    return convert_state_dict(load_torch_state_dict(pth_path), cfg)
