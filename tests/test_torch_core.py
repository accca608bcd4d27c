"""The PyTorch port's jax-free parts against the JAX package: config
loading, tokenizer, preprocessing, batch buckets, the parameter tree of
``convert.random_params`` and the dtype rules of ``convert.to_torch``; and
the port's import and device rules."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.core import tokenizer as jtok
from handwritten_math_ocr_api_tpu.data import preprocess as jpre
from handwritten_math_ocr_api_tpu.decode.api import pick_bucket as j_pick
from handwritten_math_ocr_api_tpu.models.model import init_model

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core import tokenizer as ttok
from handwritten_math_ocr_api_torch.core.device import resolve_device
from handwritten_math_ocr_api_torch.data import preprocess as tpre
from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
from handwritten_math_ocr_api_torch.decode.api import pick_bucket as t_pick
from handwritten_math_ocr_api_torch.train import loop as tloop
from handwritten_math_ocr_api_torch.train import step as tstep

import torch_threads  # noqa: F401  (one CPU thread: see the module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "handwritten_math_ocr_api_torch")
MODEL_DIR = os.path.join(REPO, "serving_model_r4")
VOCAB = os.path.join(MODEL_DIR, "vocab.json")


def jax_config(cfg):
    """The JAX package's ModelConfig with the same values as a port one."""
    d = dataclasses.asdict(cfg)
    d["swin"] = jcfg.SwinConfig(**d["swin"])
    d["resnet"] = jcfg.ResNetConfig(**d["resnet"])
    return jcfg.ModelConfig(**d)


def _port_sources():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "kernel_ab.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(tree, top_level_only):
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_and_no_host_only_packages(path):
    """Nowhere jax or the JAX package; at module level none of the packages
    the GPU machine lacks."""
    with open(path) as f:
        tree = ast.parse(f.read())
    anywhere = set(_imports(tree, top_level_only=False))
    assert not anywhere & {"jax", "jaxlib", "handwritten_math_ocr_api_tpu",
                           "flax", "optax", "orbax"}, anywhere
    top = set(_imports(tree, top_level_only=True))
    assert not top & {"PIL", "cv2", "fastapi", "triton"}, top


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'handwritten_math_ocr_api_tpu', 'PIL', 'cv2'):\n"
            "    sys.modules[m] = None\n"
            "import handwritten_math_ocr_api_torch.decode.api\n"
            "import handwritten_math_ocr_api_torch.convert\n"
            "import handwritten_math_ocr_api_torch.train.loop\n"
            "import handwritten_math_ocr_api_torch.train.vocab_extend\n"
            "import handwritten_math_ocr_api_torch.train.gqa_convert\n"
            "import handwritten_math_ocr_api_torch.data.synthetic\n"
            "import handwritten_math_ocr_api_torch.cli\n"
            "import handwritten_math_ocr_api_torch.compat.torch_convert\n"
            "import handwritten_math_ocr_api_torch.models.resnet\n"
            "import chip_smoke\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_chip_smoke_fails_without_cuda():
    """No card: non-zero exit and no result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.load_model_config(MODEL_DIR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.to_torch({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.create_train_state(cfg, tcfg.TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.make_train_step(cfg, tcfg.TrainConfig(), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.make_eval_step(cfg, tcfg.TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train_model(tcfg.Config(model=cfg), [], [], None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_serving_config_matches_jax_loader():
    """serving_model_r4's config loads to the same values through the
    port's loader and the JAX loader's parsing."""
    port = tcfg.load_model_config(MODEL_DIR)
    with open(os.path.join(MODEL_DIR, "model_config.json")) as f:
        raw = json.load(f)
    raw["swin"] = jcfg.SwinConfig(**{**raw["swin"],
                                     "depths": tuple(raw["swin"]["depths"]),
                                     "num_heads": tuple(
                                         raw["swin"]["num_heads"])})
    raw["resnet"] = jcfg.ResNetConfig(**{
        **raw["resnet"],
        "stage_channels": tuple(raw["resnet"]["stage_channels"]),
        "stage_blocks": tuple(raw["resnet"]["stage_blocks"])})
    jax_cfg = jcfg.ModelConfig(**raw)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    assert (port.head_dim, port.kv_heads, port.encoder_len) == (
        jax_cfg.head_dim, jax_cfg.kv_heads, jax_cfg.encoder_len)
    assert port.vocab_size == len(ttok.load_vocab(VOCAB)[0]) == 138


def test_config_defaults_match_jax():
    assert dataclasses.asdict(tcfg.ModelConfig()) == dataclasses.asdict(
        jcfg.ModelConfig())
    assert dataclasses.asdict(tcfg.DecodeConfig()) == dataclasses.asdict(
        jcfg.DecodeConfig())
    assert (tcfg.PAD_ID, tcfg.SOS_ID, tcfg.EOS_ID, tcfg.UNK_ID) == (
        jcfg.PAD_ID, jcfg.SOS_ID, jcfg.EOS_ID, jcfg.UNK_ID)


FORMULAS = [r"\frac { a } { b } + x ^ { 2 }",
            r"\begin {matrix} a \end {matrix}",
            r"\sqrt { \alpha _ 1 2 }", r"{ \Sigma } \\ \\ q", "", "x=12y"]


@pytest.mark.parametrize("formula", FORMULAS)
def test_tokenizer_matches_jax(formula):
    vocab, idx2char = ttok.load_vocab(VOCAB)
    assert (vocab, idx2char) == jtok.load_vocab(VOCAB)
    t, j = ttok.Tokenizer(vocab, idx2char), jtok.Tokenizer(vocab, idx2char)
    assert ttok.tokenize_latex(formula) == jtok.tokenize_latex(formula)
    ids = t.encode(formula, max_len=16)
    assert ids == j.encode(formula, max_len=16)
    assert t.decode(ids) == j.decode(ids)
    assert t.decode_batch([ids, ids[::-1]]) == j.decode_batch([ids, ids[::-1]])
    text = t.decode(ids)
    assert ttok.clean_latex_output(text) == jtok.clean_latex_output(text)
    assert ttok.clean_latex_output(formula) == jtok.clean_latex_output(formula)


def test_preprocess_matches_jax():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (3, 8, 12), dtype=np.uint8)
    want = jpre.preprocess_batch_numpy(imgs)
    np.testing.assert_array_equal(tpre.preprocess_batch_numpy(imgs), want)
    np.testing.assert_array_equal(
        tpre.preprocess_batch_numpy(torch.from_numpy(imgs)).numpy(), want)
    np.testing.assert_array_equal(tpre.normalize(imgs[0]),
                                  jpre.normalize(imgs[0]))


def test_image_loaders_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    path = str(tmp_path / "formula.png")
    Image.fromarray(rng.integers(0, 256, (57, 211, 3), dtype=np.uint8)).save(
        path)
    np.testing.assert_array_equal(tpre.load_image_cv2(path, 96, 320),
                                  jpre.load_image_cv2(path, 96, 320))
    with Image.open(path) as img:
        np.testing.assert_array_equal(tpre.resize_pil_u8(img),
                                      jpre.resize_pil_u8(img))
    with pytest.raises(FileNotFoundError):
        tpre.load_image_cv2(str(tmp_path / "missing.png"))


def test_pick_bucket_matches_jax():
    buckets = tcfg.DecodeConfig().batch_buckets
    for n in range(1, 80):
        assert t_pick(n, buckets) == j_pick(n, buckets)


def test_random_params_tree_matches_jax_init():
    """Same structure, shapes and dtype as the JAX package's init_model at
    the full serving width (shapes only: no values are compared)."""
    cfg = tcfg.load_model_config(MODEL_DIR)
    jax_cfg = jax_config(cfg)
    abstract, _ = jax.eval_shape(lambda k: init_model(k, jax_cfg),
                                 jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), abstract)
    ours = convert.random_params(cfg, seed=0)
    got = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), ours)
    assert got == want


def test_random_params_draws_biases_and_norms():
    """Every bias and LayerNorm bias is drawn around 0 and every LayerNorm
    scale around 1 (std 0.05), so that checks on these weights see a
    dropped or misplaced bias or norm parameter; the same seed gives the
    same tree."""
    cfg = tcfg.load_model_config(MODEL_DIR)
    tree = convert.random_params(cfg, seed=0)
    seen = {"bias": 0, "scale": 0}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, key)
        elif key in ("b", "b_qkv", "b_out", "bias"):
            seen["bias"] += 1
            assert 0.02 < node.std() < 0.1 and abs(node.mean()) < 0.05, key
        elif key == "scale":
            seen["scale"] += 1
            assert 0.02 < node.std() < 0.1, key
            assert abs(node.mean() - 1.0) < 0.05, key

    walk(tree, None)
    assert seen["bias"] > 100 and seen["scale"] > 40, seen
    again = convert.random_params(cfg, seed=0)
    np.testing.assert_array_equal(
        again["decoder"]["layers"][3]["norm2"]["bias"],
        tree["decoder"]["layers"][3]["norm2"]["bias"])


def test_to_torch_dtype_rules():
    cfg = tcfg.ModelConfig()  # bfloat16 compute
    tree = {"encoder": {"w_qkv": np.ones((2, 6), np.float32),
                        "rel_bias_table": np.ones((9, 2), np.float32),
                        "norm": {"scale": np.ones(2, np.float32),
                                 "bias": np.zeros(2, np.float32)}},
            "decoder": {"embedding": {"table": np.ones((4, 2), np.float32)},
                        "fc_out": {"w": np.ones((2, 4), np.float32),
                                   "b": np.ones(4, np.float32)},
                        "layers": [{"b_out": np.ones(2, np.float32)}]}}
    out = convert.to_torch(tree, cfg, "cpu")
    assert out["encoder"]["w_qkv"].dtype == torch.bfloat16
    assert out["decoder"]["layers"][0]["b_out"].dtype == torch.bfloat16
    for t in (out["encoder"]["rel_bias_table"],
              out["encoder"]["norm"]["scale"],
              out["encoder"]["norm"]["bias"],
              out["decoder"]["embedding"]["table"],
              out["decoder"]["fc_out"]["w"], out["decoder"]["fc_out"]["b"]):
        assert t.dtype == torch.float32
