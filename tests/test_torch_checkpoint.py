"""The port's reader of the orbax serving checkpoint against the JAX loader.

``utils/zstd.py`` (libzstd through ctypes), ``utils/ocdbt.py`` (the OCDBT
store and its zarr v2 arrays) and ``train/checkpoint.py``
(``load_params_for_serving``, ``tree_digest``): the shipped
``serving_model_r4`` read leaf for leaf equal to the JAX loader's tree with
the same nesting, and to the digest in ``tests/fixtures/
torch_r4_quality.json``; small checkpoints saved here by the JAX package
(both artifact shapes; float32, bfloat16, int32 and scalar leaves); B-trees
with interior nodes and out-of-line values written by tensorstore; and the
refusals (a truncated data file, a flipped byte in a node or a chunk, a
compressor, filter, dtype or order the reader lacks, no libzstd).
"""

import ctypes.util
import json
import os
import shutil
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core.config import ModelConfig as JModelConfig
from handwritten_math_ocr_api_tpu.train import checkpoint as jckpt

from handwritten_math_ocr_api_torch.train import checkpoint as tckpt
from handwritten_math_ocr_api_torch.utils import ocdbt, zstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "serving_model_r4")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_r4_quality.json")


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_tree(got, want, path="") -> int:
    """Structure (dict keys, list lengths) and every leaf's dtype, shape and
    bytes equal; returns the leaf count. A torch bfloat16 leaf is compared
    by its bits with an ml_dtypes bfloat16 one."""
    import torch

    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        return sum(_same_tree(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        return sum(_same_tree(g, w, f"{path}/{i}")
                   for i, (g, w) in enumerate(zip(got, want)))
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        assert tuple(got.shape) == want.shape, path
        assert got.view(torch.int16).numpy().tobytes() == want.tobytes(), path
        return 1
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path
    return 1


def test_serving_model_r4_matches_jax_loader():
    """Every one of the 321 leaves bit-equal to the JAX loader's, lists where
    JAX has lists (decoder layers, Swin stages and blocks), and the digest
    equal to the committed fixture's."""
    params, state, vocab, idx2char, cfg = tckpt.load_params_for_serving(
        MODEL_DIR)
    jparams, jstate, jvocab, jidx2char, jcfg = jckpt.load_params_for_serving(
        MODEL_DIR)
    want = _numpy(jparams)
    assert _same_tree(params, want) == 321
    assert isinstance(params["decoder"]["layers"], list)
    assert isinstance(params["encoder"]["stages"][0]["blocks"], list)
    assert state == {} and jstate == {}
    assert vocab == jvocab and idx2char == jidx2char
    assert cfg.num_decoder_layers == jcfg.num_decoder_layers == 8
    assert cfg.vocab_size == jcfg.vocab_size
    with open(FIXTURE) as f:
        fixture = json.load(f)
    assert tckpt.tree_digest(params) == tckpt.tree_digest(want)
    assert tckpt.tree_digest(params) == fixture["tree_digest"]
    assert fixture["n_leaves"] == 321
    assert fixture["n_params"] == sum(
        x.size for x in jax.tree_util.tree_leaves(want))


def _small_tree():
    rng = np.random.default_rng(0)
    return {
        "a": {"w": jnp.asarray(rng.standard_normal((64, 64)), jnp.float32),
              "b": jnp.asarray(rng.standard_normal((5,)), jnp.bfloat16)},
        "layers": [{"i": jnp.arange(7, dtype=jnp.int32)},
                   {"i": jnp.asarray([-3, 0, 2**31 - 1], jnp.int32)}],
        "s": jnp.float32(3.5),
    }


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """A checkpoint saved by the JAX package's save_params_for_serving."""
    path = str(tmp_path_factory.mktemp("ckpt") / "artifact")
    jckpt.save_params_for_serving(path, _small_tree(), {"<pad>": 0},
                                  JModelConfig())
    return path


@pytest.mark.parametrize("legacy", [False, True])
def test_small_checkpoint_matches_saved_tree(tmp_path, legacy):
    """Both artifact shapes: {"params", "model_state"} and a legacy
    params-only tree; float32, bfloat16, int32 and 0-d leaves keep their
    dtype, and the JAX loader reads the same tree."""
    tree = _small_tree()
    path = str(tmp_path / "artifact")
    jckpt.save_params_for_serving(path, tree, {"<pad>": 0, "x": 1},
                                  JModelConfig())
    if legacy:
        import orbax.checkpoint as ocp

        shutil.rmtree(os.path.join(path, "params"))
        ocp.PyTreeCheckpointer().save(os.path.join(path, "params"), tree)
    params, state, vocab, _, cfg = tckpt.load_params_for_serving(path)
    assert _same_tree(params, _numpy(tree)) == 5
    assert state == {} and vocab == {"<pad>": 0, "x": 1}
    assert cfg.d_model == JModelConfig().d_model
    jparams, jstate = jckpt.load_params_for_serving(path)[:2]
    assert _same_tree(params, _numpy(jparams)) == 5
    assert tckpt.tree_digest(params) == tckpt.tree_digest(_numpy(tree))


def test_restore_tree_value_types(tmp_path):
    """Numpy arrays, Python scalars (0-d arrays here) and the empty
    containers orbax records without data."""
    import orbax.checkpoint as ocp

    tree = {"n": np.arange(3, dtype=np.int64), "s": 1.5, "i": 3, "e": {},
            "l": [], "none": None, "nested": [{"x": np.ones((2, 1))}]}
    ocp.PyTreeCheckpointer().save(str(tmp_path / "ckpt"), tree)
    got = tckpt.restore_tree(str(tmp_path / "ckpt"))
    assert got["e"] == {} and got["l"] == [] and got["none"] is None
    np.testing.assert_array_equal(got["n"], tree["n"])
    assert got["n"].dtype == np.int64
    assert got["s"].shape == () and float(got["s"]) == 1.5
    assert got["i"].shape == () and int(got["i"]) == 3
    np.testing.assert_array_equal(got["nested"][0]["x"], np.ones((2, 1)))
    assert sorted(p for p, _ in tckpt.leaves_with_paths(got)) == [
        "i", "n", "nested/0/x", "none", "s"]


def test_tree_digest_sees_each_part():
    base = {"a": [np.zeros(3, np.float32)], "b": np.ones((2, 2), np.int32)}
    d0 = tckpt.tree_digest(base)
    assert d0 == tckpt.tree_digest({"b": base["b"], "a": base["a"]})
    variants = [
        {"a": [np.zeros(3, np.float64)], "b": base["b"]},
        {"a": [np.zeros((3, 1), np.float32)], "b": base["b"]},
        {"a": [np.array([0, 0, 1], np.float32)], "b": base["b"]},
        {"c": [np.zeros(3, np.float32)], "b": base["b"]},
    ]
    assert len({d0, *map(tckpt.tree_digest, variants)}) == 5


def test_crc32c_check_value():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    assert ocdbt.crc32c(b"") == 0


@pytest.mark.parametrize("manifest_kind", ["single", "numbered"])
def test_btree_with_interior_nodes_matches_tensorstore(tmp_path,
                                                       manifest_kind):
    """A tree of several heights, nodes packed into shared data files,
    out-of-line values and many versions (tensorstore's own writer), read
    key for key equal to tensorstore's reads; a numbered manifest is
    refused by name."""
    import tensorstore as ts

    base = f"file://{tmp_path}/db/"
    spec = {"driver": "ocdbt", "base": base,
            "config": {"max_decoded_node_bytes": 300,
                       "max_inline_value_bytes": 16,
                       "version_tree_arity_log2": 1,
                       "manifest_kind": manifest_kind}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(1)
    for g in range(5):
        with ts.Transaction() as txn:
            for i in range(20):
                value = rng.bytes(int(rng.integers(0, 40)))
                kv.with_transaction(txn).write(f"k{g:02d}/item{i:03d}",
                                               value).result()
    if manifest_kind == "numbered":
        with pytest.raises(ValueError, match="numbered"):
            ocdbt.OcdbtStore(str(tmp_path / "db"))
        return
    store = ocdbt.OcdbtStore(str(tmp_path / "db"))
    keys = sorted(k.decode() for k in kv.list().result())
    assert store.keys() == keys and len(keys) == 100
    assert store.keys("k03/") == [k for k in keys if k.startswith("k03/")]
    for k in keys:
        assert store.get(k) == kv.read(k).result().value, k
    with pytest.raises(KeyError):
        store.get("k99/none")


def _copy(src, tmp_path):
    dst = str(tmp_path / "artifact")
    shutil.copytree(src, dst)
    return dst


def test_truncated_data_file_refused(small_ckpt, tmp_path):
    path = _copy(small_ckpt, tmp_path)
    data_dir = os.path.join(path, "params", "ocdbt.process_0", "d")
    biggest = max((os.path.join(data_dir, f) for f in os.listdir(data_dir)),
                  key=os.path.getsize)
    with open(biggest, "r+b") as f:
        f.truncate(os.path.getsize(biggest) // 2)
    with pytest.raises(ValueError, match="truncated data file"):
        tckpt.load_params_for_serving(path)


def test_flipped_byte_in_a_node_refused(small_ckpt, tmp_path):
    path = _copy(small_ckpt, tmp_path)
    node_dir = os.path.join(path, "params", "d")
    (node,) = [os.path.join(node_dir, f) for f in os.listdir(node_dir)]
    with open(node, "r+b") as f:
        data = bytearray(f.read())
        data[len(data) // 2] ^= 0x40
        f.seek(0)
        f.write(data)
    with pytest.raises(ValueError, match="CRC-32C"):
        tckpt.load_params_for_serving(path)


def test_flipped_byte_in_a_chunk_refused(small_ckpt, tmp_path):
    """A chunk's zstd frame carries no check value: a broken frame header
    is zstd's error, named."""
    path = _copy(small_ckpt, tmp_path)
    store = ocdbt.OcdbtStore(os.path.join(path, "params"))
    file, offset, _ = store._values[b"params.a.w/0.0"]
    with open(file, "r+b") as f:
        f.seek(offset)
        f.write(b"\x00")
    with pytest.raises(ValueError, match="zstd: Unknown frame descriptor"):
        tckpt.load_params_for_serving(path)


def test_bad_manifest_refused(small_ckpt, tmp_path):
    path = _copy(small_ckpt, tmp_path)
    manifest = os.path.join(path, "params", "manifest.ocdbt")
    with open(manifest, "r+b") as f:
        f.write(struct.pack(">I", ocdbt.NODE_MAGIC))
    with pytest.raises(ValueError, match="magic"):
        tckpt.load_params_for_serving(path)


class _FakeStore:
    """The two methods read_array uses, over a dict."""

    def __init__(self, values):
        self.values = values

    def __contains__(self, key):
        return key in self.values

    def get(self, key):
        return self.values[key]


def _zarray(**kw):
    meta = {"chunks": [2, 2], "compressor": None, "dimension_separator": ".",
            "dtype": "<f4", "fill_value": None, "filters": None,
            "order": "C", "shape": [3, 4], "zarr_format": 2}
    meta.update(kw)
    return json.dumps(meta).encode()


@pytest.mark.parametrize("kw, cause", [
    ({"compressor": {"id": "blosc", "cname": "lz4"}}, "compressor 'blosc'"),
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ({"dtype": "<c8"}, "dtype '<c8'"),
    ({"dtype": [["x", "<f4"]]}, "structured"),
    ({"order": "K"}, "order 'K'"),
    ({"zarr_format": 3}, "zarr_format 3"),
])
def test_unimplemented_zarr_features_refused(kw, cause):
    store = _FakeStore({"x/.zarray": _zarray(**kw)})
    with pytest.raises(ValueError, match=cause):
        ocdbt.read_array(store, "x")


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("fill", [None, 7, "NaN"])
def test_zarr_chunks_edges_and_fill(order, fill):
    """A (3, 4) array in (2, 2) chunks: edge chunks cut to the shape, a
    missing chunk read as fill_value (zeros where null), big-endian dtype
    read to native order."""
    want = np.arange(12, dtype=">f4").reshape(3, 4)
    values = {"x/.zarray": _zarray(order=order, fill_value=fill,
                                   dtype=">f4")}
    for i in range(2):
        for j in range(2):
            if (i, j) == (1, 1):
                continue  # missing chunk
            chunk = np.zeros((2, 2), ">f4")
            part = want[2 * i:2 * i + 2, 2 * j:2 * j + 2]
            chunk[:part.shape[0], :part.shape[1]] = part
            values[f"x/{i}.{j}"] = chunk.tobytes(order=order)
    got = ocdbt.read_array(_FakeStore(values), "x")
    fill_value = {None: 0.0, 7: 7.0, "NaN": np.nan}[fill]
    expect = want.astype(np.float32)
    expect[2:, 2:] = fill_value
    assert got.dtype == np.float32 and got.dtype.isnative
    np.testing.assert_array_equal(got, expect)


def test_missing_libzstd_refused(monkeypatch):
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    zstd.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="libzstd not found"):
            zstd.decompress(b"\x28\xb5\x2f\xfd", 0)
    finally:
        monkeypatch.undo()
        zstd.library.cache_clear()


def test_zstd_matches_zstandard_on_the_checkpoint_nodes():
    """Every compressed body of the checkpoint's manifest and node files
    equal to ``zstandard``'s (the chunks are held by the leaf comparison
    with the JAX loader)."""
    import glob

    import zstandard

    files = glob.glob(os.path.join(MODEL_DIR, "params", "**", "*.ocdbt"),
                      recursive=True)
    files += glob.glob(os.path.join(MODEL_DIR, "params", "**", "d", "*"),
                       recursive=True)
    checked = 0
    for path in files:
        with open(path, "rb") as f:
            head = f.read(4)
        if head not in (b"\x0c\xdb\x3a\x2a", b"\x0c\xdb\x20\xde"):
            continue  # a data file of chunks
        with open(path, "rb") as f:
            data = f.read()
        assert data[13] == 1, path  # zstd
        body = data[14:-4]
        want = zstandard.ZstdDecompressor().decompressobj().decompress(body)
        assert zstd.decompress(body, limit=1 << 24) == want, path
        checked += 1
    assert checked == 12
