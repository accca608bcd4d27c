"""``parallel/mesh.py`` of the port against the JAX package's.

``make_mesh``'s shapes and errors on JAX's virtual CPU devices and the
port's ``["cpu"] * n``; ``param_spec`` against JAX's ``param_spec`` on
every leaf path of the Swin, ``resnet18``, ``res18trans`` and MQA trees at
tensor 1, 2 and 4 (a vocab of 22 and a 6-wide FFN make some sharded
dimensions not divide: the fallback to replication); the trees' paths
against JAX's; ``replicate`` and ``split_rows``. Exact comparisons.
"""

import re

import numpy as np
import pytest
import torch

import jax

from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.models.model import init_model
from handwritten_math_ocr_api_tpu.parallel import mesh as jmesh

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.decode.constrain import build_tables
from handwritten_math_ocr_api_torch.parallel import mesh as tmesh
from handwritten_math_ocr_api_torch.utils import tree
import torch_threads  # noqa: F401  (one CPU thread: see the module)

SWIN = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window_size=4)
RESNET = dict(stage_channels=(8, 16, 32, 64))
BASE = dict(img_h=32, img_w=64, d_model=32, nhead=4, dim_feedforward=6,
            num_decoder_layers=2, max_seq_len=12, vocab_size=22,
            num_encoder_layers=2)
MODELS = {
    "swin": {},
    "resnet18": {"encoder": "resnet18"},
    "res18trans": {"encoder": "res18trans"},
    "mqa": {"nhead_kv": 1},
}


def _configs(kw):
    t = tcfg.ModelConfig(**BASE, **kw, swin=tcfg.SwinConfig(**SWIN),
                         resnet=tcfg.ResNetConfig(**RESNET))
    j = jcfg.ModelConfig(**BASE, **kw, swin=jcfg.SwinConfig(**SWIN),
                         resnet=jcfg.ResNetConfig(**RESNET))
    return t, j


@pytest.mark.parametrize("model", MODELS)
def test_param_spec_matches_jax_on_every_leaf(model):
    cfg, jc = _configs(MODELS[model])
    params = convert.random_params(cfg, 0)
    shapes = jax.eval_shape(lambda k: init_model(k, jc)[0],
                            jax.random.PRNGKey(0))
    jpaths = [jmesh._path_str(p) for p, _ in
              jax.tree_util.tree_leaves_with_path(shapes)]
    paths = ["/".join(p) for p in tree.paths(params)]
    assert sorted(paths) == sorted(jpaths)
    fallbacks = 0
    for t in (1, 2, 4):
        for path, leaf in zip(paths, tree.leaves(params)):
            want = tuple(jmesh.param_spec(path, leaf.shape, t))
            got = tmesh.param_spec(path, leaf.shape, t)
            assert got == want, (path, t)
            ruled = any(re.match(pattern, path)
                        for pattern, _ in tmesh.TP_RULES)
            fallbacks += ruled and got == ()
    assert fallbacks > 0


def test_tp_rules_are_jax_rules():
    assert [(p, tuple(s)) for p, s in jmesh.TP_RULES] == list(
        tmesh.TP_RULES)


@pytest.mark.parametrize("data,tensor,n", [(-1, 1, 8), (4, 2, 8),
                                           (-1, 2, 8), (2, 1, 2)])
def test_make_mesh_shapes(data, tensor, n):
    want = jmesh.make_mesh(data, tensor, jax.devices()[:n])
    got = tmesh.make_mesh(data, tensor, ["cpu"] * n)
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    assert len(got.data_devices) == got.shape["data"]


@pytest.mark.parametrize("data,tensor,n", [(3, 2, 8), (-1, 3, 8),
                                           (4, 1, 2)])
def test_make_mesh_errors(data, tensor, n):
    with pytest.raises(AssertionError):
        jmesh.make_mesh(data, tensor, jax.devices()[:n])
    with pytest.raises(AssertionError):
        tmesh.make_mesh(data, tensor, ["cpu"] * n)


def test_make_mesh_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()


def test_make_mesh_orders_devices_row_major():
    devs = [torch.device("cuda", i) for i in range(4)]
    m = tmesh.make_mesh(2, 2, devs)
    assert m.data_devices == [devs[0], devs[2]]
    assert list(m.devices[1]) == devs[2:]


def test_replicate_shares_repeated_devices():
    mesh = tmesh.make_mesh(3, devices=["cpu"] * 3)
    x = torch.arange(6.0)
    tables = build_tables({"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
                           "{": 4, "}": 5, "x": 6}, "cpu")
    src = {"a": [x, {"b": x * 2}], "t": tables, "n": None, "k": 3}
    copies = tmesh.replicate(src, mesh)
    assert len(copies) == 3
    assert all(c is copies[0] for c in copies)
    c = copies[0]
    assert c["a"][0].data_ptr() == x.data_ptr()   # already there: shared
    assert type(c["t"]) is type(tables)
    assert torch.equal(c["t"].cls, tables.cls)
    assert c["n"] is None and c["k"] == 3


def test_split_rows():
    mesh = tmesh.make_mesh(4, devices=["cpu"] * 4)
    x = torch.arange(24).reshape(8, 3)
    parts = tmesh.split_rows(x, mesh)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    assert torch.equal(torch.cat(parts), x)
    with pytest.raises(ValueError):
        tmesh.split_rows(x[:6], mesh)
    np.testing.assert_array_equal(
        torch.cat(tmesh.split_rows(torch.zeros(4, 1), mesh)).numpy(),
        np.zeros((4, 1)))
