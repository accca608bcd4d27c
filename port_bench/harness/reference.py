"""The plain reference: the model's forward pass in float32 on plain
``torch`` operations, and the tokenizer's inverse.

Frozen copies, reduced to the deterministic float32 forward, of the port's
plain model code at commit e13765f3a37352e31b622845f2ae26a6960b06e8:
``models/layers.py`` (linear, layer norm, attention, MLP),
``models/swin.py`` (patch embed, shifted-window blocks with the relative
bias and torchvision's region mask, patch merging; no final norm),
``models/resnet.py`` (the ResNet-18 trunk with eval-mode BatchNorm, the
height pool and projection), ``models/model.py::encode`` and
``models/decoder.py::decoder_forward`` (post-norm layers, learned
positions, float32 head), and ``core/tokenizer.py``'s token regex and
clean-up. It imports nothing of the program: it reads the configuration's
dict and a parameter tree of arrays, and works out every derived table
itself. TF32 is off wherever it runs."""

from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tensors(tree, device, dtype=torch.float32):
    """A tree of arrays or tensors -> float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors(v, device, dtype) for v in tree]
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.asarray(tree))
    return t.to(device=device, dtype=dtype)


# -- layers -----------------------------------------------------------------

def linear(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def split_heads(x, h):
    *lead, L, D = x.shape
    return x.reshape(*lead, L, h, D // h).transpose(-3, -2)


def merge_heads(x):
    x = x.transpose(-3, -2)
    *lead, L, H, Dh = x.shape
    return x.reshape(*lead, L, H * Dh)


def attention(q, k, v, mask=None):
    logits = (q / math.sqrt(q.shape[-1])) @ k.transpose(-1, -2)
    if mask is not None:
        logits = logits + mask
    return torch.softmax(logits, dim=-1) @ v


def mha(p, query, kv, num_heads, mask=None):
    d = query.shape[-1]
    w, b = p["w_qkv"], p["b_qkv"]
    kvd = (w.shape[1] - d) // 2
    kv_heads = num_heads * kvd // d
    q = query @ w[:, :d] + b[:d]
    k = kv @ w[:, d:d + kvd] + b[d:d + kvd]
    v = kv @ w[:, d + kvd:] + b[d + kvd:]
    q, k, v = split_heads(q, num_heads), split_heads(k, kv_heads), \
        split_heads(v, kv_heads)
    if kv_heads != num_heads:
        g = num_heads // kv_heads
        k = k.repeat_interleave(g, dim=-3)
        v = v.repeat_interleave(g, dim=-3)
    out = merge_heads(attention(q, k, v, mask))
    return out @ p["w_out"] + p["b_out"]


def mlp(p, x, act):
    return linear(p["fc2"], act(linear(p["fc1"], x)))


# -- Swin-T -----------------------------------------------------------------

def relative_position_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[..., 0] += ws - 1
    rel[..., 1] += ws - 1
    rel[..., 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(pad_h, pad_w, ws, sh, sw):
    if sh == 0 and sw == 0:
        return None
    region = np.zeros((pad_h, pad_w), np.float32)
    count = 0
    for h0, h1 in ((0, pad_h - ws), (pad_h - ws, pad_h - sh),
                   (pad_h - sh, pad_h)):
        for w0, w1 in ((0, pad_w - ws), (pad_w - ws, pad_w - sw),
                       (pad_w - sw, pad_w)):
            region[h0:h1, w0:w1] = count
            count += 1
    nwh, nww = pad_h // ws, pad_w // ws
    region = region.reshape(nwh, ws, nww, ws).transpose(0, 2, 1, 3)
    region = region.reshape(nwh * nww, ws * ws)
    diff = region[:, None, :] - region[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_attention(p, x, ws, shift, heads):
    B, H, W, C = x.shape
    pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    ph, pw = H + pad_b, W + pad_r
    sh = 0 if ws >= ph else shift
    sw = 0 if ws >= pw else shift
    if sh or sw:
        x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
    nwh, nww = ph // ws, pw // ws
    win = x.reshape(B, nwh, ws, nww, ws, C).permute(0, 1, 3, 2, 4, 5)
    win = win.reshape(B, nwh * nww, ws * ws, C)
    N = ws * ws
    index = torch.as_tensor(relative_position_index(ws).reshape(-1),
                            device=x.device)
    bias = p["rel_bias_table"][index].reshape(N, N, heads).permute(2, 0, 1)
    sm = shift_mask(ph, pw, ws, sh, sw)
    mask = bias[None] if sm is None else (
        bias[None] + torch.as_tensor(sm, device=x.device)[:, None])
    qkv = win @ p["w_qkv"] + p["b_qkv"]
    q, k, v = (split_heads(t, heads) for t in qkv.split(C, dim=-1))
    out = merge_heads(attention(q, k, v, mask[None]))   # (B, nW, N, C)
    out = out @ p["w_out"] + p["b_out"]
    out = out.reshape(B, nwh, nww, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    x = out.reshape(B, ph, pw, C)
    if sh or sw:
        x = torch.roll(x, shifts=(sh, sw), dims=(1, 2))
    return x[:, :H, :W]


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def swin_encode(p, sc, x):
    w = p["patch_embed"]["conv"]["w"]
    ps, _, cin, dim = w.shape
    B, H, W, _ = x.shape
    h, wd = H // ps, W // ps
    patches = x[:, :h * ps, :wd * ps].reshape(B, h, ps, wd, ps, cin)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(B, h, wd, -1)
    x = patches @ w.reshape(ps * ps * cin, dim) + p["patch_embed"]["conv"]["b"]
    x = layer_norm(p["patch_embed"]["norm"], x)
    ws = sc["window_size"]
    for i, depth in enumerate(sc["depths"]):
        for d in range(depth):
            bp = p["stages"][i]["blocks"][d]
            shift = 0 if d % 2 == 0 else ws // 2
            x = x + window_attention(bp["attn"], layer_norm(bp["norm1"], x),
                                     ws, shift, sc["num_heads"][i])
            x = x + mlp(bp["mlp"], layer_norm(bp["norm2"], x), gelu_tanh)
        if i < len(sc["depths"]) - 1:
            mp = p["merges"][i]
            B, H, W, C = x.shape
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            cat = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                             x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            x = layer_norm(mp["norm"], cat) @ mp["reduction"]["w"]
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C)


# -- ResNet-18 --------------------------------------------------------------

def _conv(p, x, stride, padding):
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), stride=stride,
                    padding=padding)


def _bn(p, s, x, eps=1e-5):
    inv = torch.rsqrt(s["var"] + eps) * p["scale"]
    return ((x - s["mean"][:, None, None]) * inv[:, None, None]
            + p["bias"][:, None, None])


def resnet_encode(p, s, x):
    x = x.permute(0, 3, 1, 2)
    x = torch.relu(_bn(p["bn1"], s["bn1"], _conv(p["conv1"], x, 2, 3)))
    x = F.max_pool2d(x, 3, 2, 1)
    for i, blocks in enumerate(p["layers"]):
        for b, bp in enumerate(blocks):
            bs = s["layers"][i][b]
            stride = 2 if (b == 0 and i > 0) else 1
            h = torch.relu(_bn(bp["bn1"], bs["bn1"],
                               _conv(bp["conv1"], x, stride, 1)))
            h = _bn(bp["bn2"], bs["bn2"], _conv(bp["conv2"], h, 1, 1))
            ident = x
            if "downsample" in bp:
                ident = _bn(bp["downsample"]["bn"], bs["downsample"]["bn"],
                            _conv(bp["downsample"]["conv"], x, stride, 0))
            x = torch.relu(h + ident)
    return x.permute(0, 2, 3, 1)       # (B, H', W', C)


# -- the model --------------------------------------------------------------

def encode(params, state, model: dict, images_u8: Tensor) -> Tensor:
    """uint8 (B, H, W) -> memory (B, L_enc, d_model), float32."""
    x = (images_u8.float() / 255.0 * 2.0 - 1.0)[..., None]
    if model["encoder"] == "swin_t":
        feats = swin_encode(params["encoder"], model["swin"], x)
        memory = linear(params["projection"], feats)
    elif model["encoder"] == "resnet18":
        feats = resnet_encode(params["encoder"], state["resnet"], x)
        memory = linear(params["projection"], feats.mean(dim=1))
    else:
        raise ValueError(f"encoder {model['encoder']!r} has no reference")
    if model.get("memory_norm"):
        memory = layer_norm(params["memory_norm"], memory)
    return memory


def decoder_logits(dec, model: dict, memory: Tensor, ids: Tensor) -> Tensor:
    """Teacher-forced logits (B, L, V) over input ids (B, L)."""
    B, L = ids.shape
    x = dec["embedding"]["table"][ids] + dec["pos"]["table"][:L][None]
    mask = torch.triu(torch.full((L, L), float("-inf"), device=ids.device),
                      diagonal=1)
    for p in dec["layers"]:
        x = layer_norm(p["norm1"], x + mha(p["self_attn"], x, x,
                                           model["nhead"], mask))
        x = layer_norm(p["norm2"], x + mha(p["cross_attn"], x, memory,
                                           model["nhead"]))
        x = layer_norm(p["norm3"], x + mlp(p["ffn"], x, torch.relu))
    return linear(dec["fc_out"], x)


# -- tokens -----------------------------------------------------------------

TOKEN_PATTERN = re.compile(
    r"(<unk>|\\[a-zA-Z]+|[{}_^$%&#]|[0-9]+|[a-zA-Z]+|[^\s])")
_CLEAN = ((re.compile(r"\\begin\s+\{"), r"\\begin{"),
          (re.compile(r"\\end\s+\{"), r"\\end{"),
          (re.compile(r"\{(\s+)([a-zA-Z]+)(\s+)\}"), r"{\2}"),
          (re.compile(r"\\\s+\\"), r"\\\\"))
EMPTY_RESULT = (r"\text{Unable to detect a formula from the image. "
                r"Please verify the model.}")


def clean(text: str) -> str:
    for pat, rep in _CLEAN:
        text = pat.sub(rep, text)
    return text


class Vocab:
    """The serving vocab's token ids, and served texts back to ids."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            self.ids: Dict[str, int] = json.load(f)["vocab"]
        self.sos = self.ids["<sos>"]
        self.eos = self.ids["<eos>"]
        self.pad = self.ids["<pad>"]

    def ids_of(self, text: str) -> Optional[List[int]]:
        """The token ids a served text was detokenized from (the empty
        result: none), or None where the text is not the clean-up of any
        sequence of vocab tokens."""
        if text == EMPTY_RESULT:
            return []
        toks = TOKEN_PATTERN.findall(text)
        if any(t not in self.ids for t in toks):
            return None
        if clean(" ".join(toks)) != text:
            return None
        return [self.ids[t] for t in toks]
