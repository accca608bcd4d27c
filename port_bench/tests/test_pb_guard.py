"""The import check compares whole top-level names: the port's package
name begins with the JAX package's."""

import os
import subprocess
import sys
import types

import pb_tiny

from harness import guard


def test_whole_top_level_names():
    mods = {"handwritten_math_ocr_api_torch": 1,
            "handwritten_math_ocr_api_torch.serve.app": 1,
            "jaxtyping": 1, "jax_like": 1, "numpy": 1}
    assert guard.loaded(guard.JAX_NAMES, mods) == []
    mods.update({"handwritten_math_ocr_api_tpu.decode": 1, "jax.numpy": 1,
                 "jaxlib": 1, "flax.linen": 1})
    assert guard.loaded(guard.JAX_NAMES, mods) == [
        "flax.linen", "handwritten_math_ocr_api_tpu.decode", "jax.numpy",
        "jaxlib"]
    assert guard.loaded(guard.PROGRAM_NAMES, mods) == [
        "handwritten_math_ocr_api_torch",
        "handwritten_math_ocr_api_torch.serve.app"]


def test_imported_by_finds_a_program_import():
    mod = types.ModuleType("fake_reference")
    mod.ok = os.path.join
    prog = types.ModuleType("handwritten_math_ocr_api_torch.models")
    mod.models = prog

    def f():
        pass
    f.__module__ = "handwritten_math_ocr_api_torch.models.decoder"
    mod.decoder_forward = f
    assert guard.imported_by(mod, guard.PROGRAM_NAMES) == [
        "decoder_forward", "models"]


def test_the_reference_imports_neither_the_program_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import harness.reference, harness.judge, harness.checkpoint, "
            "harness.weights, harness.images; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('handwritten_math_ocr_api_torch', 'handwritten_math_ocr_api_tpu',"
            " 'jax', 'jaxlib', 'flax')]; print(bad); sys.exit(1 if bad else 0)"
            % pb_tiny.BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_run_refuses_when_jax_is_loaded(monkeypatch):
    import run as R

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    try:
        R.check_imports()
    except R.Refused as e:
        assert "jax" in str(e)
    else:
        raise AssertionError("a run with jax loaded was not refused")


def test_a_run_without_a_card_prints_nothing(tmp_path):
    """run.py exits non-zero and prints no result line without CUDA
    (here: this machine's CPU build); and in a directory that holds only
    the benchmark's files."""
    out = subprocess.run(
        [sys.executable, os.path.join(pb_tiny.BENCH_DIR, "run.py"),
         "--workload", "swin_t_r4.bulk_closed", "--seed", "1",
         "--seconds", "1"], capture_output=True, text=True, timeout=300,
        cwd=pb_tiny.REPO_ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
