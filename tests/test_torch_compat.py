"""The port's reference-checkpoint converter (``compat/torch_convert.py``)
and the CLI's ``convert-checkpoint``, ``convert-encoder`` and ``export``
against the JAX package's, on the CPU in float32.

Reference-layout models are built here from seeded ``torch.nn`` modules
with the reference's module names, as ``tests/test_compat.py`` builds
them: the decoder (``decoder.embedding``, ``pos_encoder``, a
``TransformerDecoder`` and ``fc_out``), the ResNet trunk as a Sequential
of torchvision resnet's children but the last two (``encoder.features``)
with ``encoder.projection`` and, for res18trans,
``encoder.transformer_encoder``; the Swin encoder's torchvision keys come
from ``tests/test_compat.py``'s fabricated state dict. The models are
small: stage channels (8, 16, 32, 64), d_model 32, 4 heads, 2 decoder
and 2 encoder layers, FFN 64, T 12, vocab 20, 32x64 images, a two-stage
Swin of width 8.

Tolerances: converted trees equal JAX's exactly, leaf for leaf; the
converted trunk's features and the converted model's memory and logits
within 1e-4 absolute and relative of the torch module's ``eval()``
forward (float32 convolutions and matmuls summed in another order);
confidences within 1e-4; tokens and strings exactly.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from handwritten_math_ocr_api_tpu.compat import torch_convert as jtc
from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.cli import main
from handwritten_math_ocr_api_torch.compat import torch_convert as tc
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.tokenizer import (
    Tokenizer,
    save_vocab,
)
from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
from handwritten_math_ocr_api_torch.models import decoder as tdec
from handwritten_math_ocr_api_torch.models import model as tmodel
from handwritten_math_ocr_api_torch.models import resnet as tres
from handwritten_math_ocr_api_torch.serve.app import ServerState
from handwritten_math_ocr_api_torch.train.checkpoint import (
    load_params_for_serving,
)
from handwritten_math_ocr_api_torch.utils import tree

from test_compat import _fake_swin_sd
import torch_threads  # noqa: F401  (one CPU thread: see the module)

nn = torch.nn
TOL = 1e-4
CONF_TOL = 1e-4
T = 12
CHANNELS = (8, 16, 32, 64)
CFG = tcfg.ModelConfig(
    img_h=32, img_w=64, d_model=32, nhead=4, dim_feedforward=64,
    dropout=0.0, num_decoder_layers=2, max_seq_len=T, vocab_size=20,
    encoder="resnet18", num_encoder_layers=2,
    resnet=tcfg.ResNetConfig(stage_channels=CHANNELS),
    swin=tcfg.SwinConfig(embed_dim=8, depths=(1, 1), num_heads=(2, 2),
                         window_size=4, stochastic_depth=0.0),
    dtype="float32")
VOCAB = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
         **{f"t{i}": i for i in range(4, 20)}}
ENCODERS = ("resnet18", "res18trans", "swin_t")


def jax_config(cfg):
    d = dataclasses.asdict(cfg)
    d["swin"] = jcfg.SwinConfig(**d["swin"])
    d["resnet"] = jcfg.ResNetConfig(**d["resnet"])
    return jcfg.ModelConfig(**d)


class Holder(nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            setattr(self, k, v)


class RefDecoder(nn.Module):
    """The reference decoder's module names."""

    def __init__(self, cfg):
        super().__init__()
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_encoder = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        layer = nn.TransformerDecoderLayer(cfg.d_model, cfg.nhead,
                                           cfg.dim_feedforward, 0.0)
        self.decoder = nn.TransformerDecoder(layer, cfg.num_decoder_layers)
        self.fc_out = nn.Linear(cfg.d_model, cfg.vocab_size)

    def forward(self, memory, tgt):
        L = tgt.size(1)
        x = self.embedding(tgt) + self.pos_encoder(torch.arange(L))[None]
        mask = torch.triu(torch.full((L, L), float("-inf")), diagonal=1)
        out = self.decoder(x.permute(1, 0, 2), memory.permute(1, 0, 2),
                           tgt_mask=mask)
        return self.fc_out(out.permute(1, 0, 2))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + idt)


def trunk(blocks=(2, 2, 2, 2)):
    """resnet18's children but avgpool and fc, 1-channel, at CHANNELS,
    with perturbed BatchNorm parameters and running statistics."""
    seq = [nn.Conv2d(1, CHANNELS[0], 7, 2, 3, bias=False),
           nn.BatchNorm2d(CHANNELS[0]), nn.ReLU(inplace=True),
           nn.MaxPool2d(3, 2, 1)]
    cin = CHANNELS[0]
    for i, (cout, n) in enumerate(zip(CHANNELS, blocks)):
        stage = []
        for b in range(n):
            stage.append(BasicBlock(cin, cout, 2 if (b == 0 and i > 0)
                                    else 1))
            cin = cout
        seq.append(nn.Sequential(*stage))
    t = nn.Sequential(*seq)
    with torch.no_grad():
        for m in t.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(-0.1, 0.1)
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 1.5)
    return t


def reference_model(encoder, seed=0, cfg=CFG):
    """A seeded reference-layout model of ``encoder`` (ResNet ones) with
    the EOS logit raised by 0.3, so that decodes end at different steps
    (res18trans) or soon (resnet18)."""
    torch.manual_seed(seed)
    enc = Holder(features=trunk(),
                 projection=nn.Linear(CHANNELS[-1], cfg.d_model))
    if encoder == "res18trans":
        layer = nn.TransformerEncoderLayer(cfg.d_model, cfg.nhead,
                                           cfg.dim_feedforward, 0.0)
        enc.transformer_encoder = nn.TransformerEncoder(
            layer, cfg.num_encoder_layers)
    model = Holder(encoder=enc, decoder=RefDecoder(cfg))
    with torch.no_grad():
        model.decoder.fc_out.bias[2] += 0.3
    return model.eval()


def state_dict(encoder, seed=0):
    if encoder == "swin_t":
        sd = _fake_swin_sd(CFG.swin)
        ref = Holder(encoder=Holder(projection=nn.Linear(
            CFG.swin.num_features, CFG.d_model)), decoder=RefDecoder(CFG))
        sd.update({k: v.detach().numpy()
                   for k, v in ref.state_dict().items()})
        return sd
    return {k: v.detach().numpy().copy() for k, v in
            reference_model(encoder, seed).state_dict().items()}


def assert_same_tree(got, want):
    g = dict(zip(tree.paths(got), tree.leaves(got)))
    w = dict(zip(tree.paths(want), tree.leaves(want)))
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg="/".join(k))


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 1, 1, 1))
            + rng.uniform(0.2, 2.0, (n, 1, 1, 1))
            * rng.standard_normal((n, CFG.img_h, CFG.img_w, 1))
            ).astype(np.float32)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_convert_state_dict_matches_jax(encoder):
    """``convert_state_dict`` gives JAX's (params, model state) leaf for
    leaf: dtype, shape and every value; the tree has ``init_model``'s
    paths and shapes."""
    cfg = CFG.replace(encoder=encoder)
    sd = state_dict(encoder)
    got = tc.convert_state_dict(sd, cfg)
    want = jtc.convert_state_dict(sd, jax_config(cfg))
    for g, w in zip(got, want):
        assert_same_tree(g, jax.tree_util.tree_map(np.asarray, w))
    fresh = convert.random_params(cfg)
    assert tree.structure(got[0]) == tree.structure(fresh)
    assert tree.structure(got[1]) == tree.structure(
        convert.random_state(cfg))


@pytest.mark.parametrize("blocks", [(1, 1, 1, 1), (2, 2, 2, 2)])
def test_converted_trunk_matches_module(blocks):
    """The converted trunk (eval mode, the module's running statistics)
    against the module's own ``eval()`` forward, within TOL."""
    torch.manual_seed(1)
    ref = trunk(blocks).eval()
    sd = {f"encoder.features.{k}": v.detach().numpy()
          for k, v in ref.state_dict().items()}
    cfg = CFG.replace(resnet=dataclasses.replace(CFG.resnet,
                                                 stage_blocks=blocks))
    params, state = tc.convert_resnet_encoder(sd, cfg)
    x = _images(3, 2)
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    got, _ = tres.resnet_apply(convert.to_torch(params, cfg, "cpu"),
                               convert.state_to_torch(state, "cpu"),
                               torch.from_numpy(x), cfg.resnet)
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(), want,
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("encoder", ["resnet18", "res18trans"])
def test_converted_model_matches_module(encoder):
    """The whole converted model against the reference module in eval
    mode: the memory (trunk, height mean, projection and, for res18trans,
    the transformer encoder with the converted zero positional table)
    and the teacher-forced logits, within TOL."""
    cfg = CFG.replace(encoder=encoder)
    ref = reference_model(encoder, 3)
    params, state = tc.convert_state_dict(
        {k: v.detach().numpy() for k, v in ref.state_dict().items()}, cfg)
    x = _images(2, 4)
    caps = np.random.default_rng(4).integers(4, 20, (2, 7))
    with torch.no_grad():
        f = ref.encoder.features(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        mem = ref.encoder.projection(f.mean(dim=2).permute(0, 2, 1))
        if encoder == "res18trans":
            mem = ref.encoder.transformer_encoder(
                mem.permute(1, 0, 2)).permute(1, 0, 2)
        want_logits = ref.decoder(mem, torch.from_numpy(caps[:, :-1]))
    tp = convert.to_torch(params, cfg, "cpu")
    ts = convert.state_to_torch(state, "cpu")
    got = tmodel.encode(tp, cfg, torch.from_numpy(x), model_state=ts)
    np.testing.assert_allclose(got.numpy(), mem.numpy(), atol=TOL, rtol=TOL)
    logits = tmodel.forward(tp, cfg, torch.from_numpy(x),
                            torch.from_numpy(caps), model_state=ts)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits.numpy(),
                               atol=TOL, rtol=TOL)
    dec = tdec.decoder_forward(tp["decoder"], cfg, mem,
                               torch.from_numpy(caps[:, :-1]))
    np.testing.assert_allclose(dec.numpy(), want_logits.numpy(), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("style", ["state_dict", "bundle", "module"])
def test_load_torch_state_dict_reads_every_style(tmp_path, style):
    """A bare state dict, a ``{"model_state_dict": ...}`` training bundle
    and a whole pickled module read to the same arrays as JAX's reader
    gives."""
    model = reference_model("resnet18", 5)
    obj = {"state_dict": model.state_dict(),
           "bundle": {"model_state_dict": model.state_dict(), "epoch": 3},
           "module": model}[style]
    path = str(tmp_path / "m.pth")
    torch.save(obj, path)
    got = tc.load_torch_state_dict(path)
    want = jtc.load_torch_state_dict(path)
    assert got.keys() == want.keys() == model.state_dict().keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("encoder", ["resnet18", "res18trans"])
def test_convert_checkpoint_cli_serves(tmp_path, encoder):
    """``convert-checkpoint`` on a ``.pth`` bundle -> a serving artifact
    holding the BatchNorm statistics -> the app's engine: its formulas
    equal, and its confidences within CONF_TOL of, an engine's on the
    in-memory converted tree and JAX's engine's on JAX's conversion."""
    cfg = CFG.replace(encoder=encoder)
    model = reference_model(encoder, 7)
    pth = str(tmp_path / "best_model.pth")
    torch.save({"model_state_dict": model.state_dict()}, pth)
    vpath = str(tmp_path / "vocab.json")
    save_vocab(VOCAB, vpath)
    overrides = json.dumps({
        "img_h": cfg.img_h, "img_w": cfg.img_w, "d_model": cfg.d_model,
        "nhead": cfg.nhead, "dim_feedforward": cfg.dim_feedforward,
        "num_decoder_layers": cfg.num_decoder_layers,
        "num_encoder_layers": cfg.num_encoder_layers,
        "max_seq_len": cfg.max_seq_len, "dtype": "float32",
        "resnet": {"stage_channels": list(CHANNELS)}})
    out = str(tmp_path / "artifact")
    assert main(["convert-checkpoint", pth, vpath, out, "--encoder",
                 encoder, "--model-overrides", overrides]) == 0
    params, ms, vocab, _, cfg2 = load_params_for_serving(out)
    assert cfg2 == cfg.replace(dropout=cfg2.dropout, swin=cfg2.swin)
    assert vocab == VOCAB
    assert "resnet" in ms and ms["resnet"]["bn1"]["var"].dtype == np.float32
    p_mem, s_mem = tc.convert_checkpoint(pth, cfg)
    assert_same_tree(params, p_mem)
    assert_same_tree(ms, s_mem)

    images = _images(3, 8)
    srv = ServerState(tcfg.ServeConfig(model_dir=out), device="cpu")
    srv.initialize_model()
    got = [srv.engine.predict_single(im) for im in images]
    engine = DecodeEngine(p_mem, cfg, tcfg.DecodeConfig(), Tokenizer(VOCAB),
                          model_state=s_mem, device="cpu")
    want = [engine.predict_single(im) for im in images]
    jp, js = jtc.convert_checkpoint(pth, jax_config(cfg))
    jeng = JEngine(jp, js, jax_config(cfg), jcfg.DecodeConfig(),
                   JTokenizer(VOCAB))
    for other in (want, [jeng.predict_single(im) for im in images]):
        assert [g[0] for g in got] == [w[0] for w in other]
        np.testing.assert_allclose([g[1] for g in got],
                                   [w[1] for w in other], atol=CONF_TOL)
    assert len({round(g[1], 5) for g in got}) == len(images)


def test_convert_encoder_cli_matches_jax(tmp_path):
    """``convert-encoder`` on torchvision ``swin_t`` keys with an RGB
    patch embedding: the artifact's encoder tree equals JAX's
    ``convert_torchvision_swin`` leaf for leaf (the patch convolution
    averaged to one channel), and its vocab holds the four specials."""
    sd = _fake_swin_sd(tcfg.SwinConfig())
    raw = {k.replace("encoder.swin.", ""): v for k, v in sd.items()}
    raw["features.0.0.weight"] = np.random.default_rng(3).standard_normal(
        (96, 3, 4, 4)).astype(np.float32)
    pth = str(tmp_path / "swin_t.pth")
    torch.save({k: torch.from_numpy(v) for k, v in raw.items()}, pth)
    out = str(tmp_path / "enc")
    assert main(["convert-encoder", pth, out]) == 0
    params, ms, vocab, _, cfg = load_params_for_serving(out)
    assert ms == {} and len(vocab) == 4 and cfg.encoder == "swin_t"
    want = jtc.convert_torchvision_swin(
        jtc.load_torch_state_dict(pth), jcfg.ModelConfig(encoder="swin_t"))
    assert_same_tree(params, {"encoder": want})
    assert params["encoder"]["patch_embed"]["conv"]["w"].shape[2] == 1
