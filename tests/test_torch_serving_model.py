"""The shipped ``serving_model_r4`` weights through both packages.

The JAX loader reads the orbax checkpoint; ``convert.to_torch`` carries the
tree to the port. Both engines decode the first test images of
``data_calib_hard`` in float32 (the JAX one on its Pallas route, in
interpret mode), and the tokens must be equal; on the default route, and
on the port's fused route against JAX's fused decoder step. Marked
``slow``: a full Swin-T encode and up to 150 decode steps through
interpreted kernels take minutes on the CPU. Skips where the checkpoint is
absent (it is not part of a git checkout).
"""

import glob
import os

import numpy as np
import pytest

import torch_threads  # noqa: F401  (one CPU thread: see the module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "serving_model_r4")
IMAGES = sorted(glob.glob(os.path.join(
    REPO, "data_calib_hard", "test_formulas", "*.png")))[:4]


def _engines(**port_route):
    if not os.path.isdir(os.path.join(MODEL_DIR, "params")) or not IMAGES:
        pytest.skip("serving_model_r4 checkpoint or test images absent")
    import jax

    from handwritten_math_ocr_api_tpu.core.tokenizer import (
        Tokenizer as JTokenizer,
    )
    from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
    from handwritten_math_ocr_api_tpu.train.checkpoint import (
        load_params_for_serving,
    )

    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
    from handwritten_math_ocr_api_torch.data.preprocess import load_image_cv2
    from handwritten_math_ocr_api_torch.decode.api import DecodeEngine

    params, state, vocab, idx2char, jcfg = load_params_for_serving(MODEL_DIR)
    jcfg = jcfg.replace(dtype="float32")
    cfg = load_model_config(MODEL_DIR).replace(dtype="float32")
    images = np.stack([load_image_cv2(p, cfg.img_h, cfg.img_w)
                       for p in IMAGES])[..., None]
    jax_engine = JEngine(params, state, jcfg,
                         tokenizer=JTokenizer(vocab, idx2char),
                         use_pallas=True,
                         use_fused=port_route.get("use_fused", False))
    np_params = jax.tree_util.tree_map(np.array, params)
    engine = DecodeEngine(np_params, cfg, tokenizer=Tokenizer(vocab, idx2char),
                          device="cpu", **port_route)
    return jax_engine, engine, images


@pytest.mark.slow
def test_serving_model_r4_tokens_match_jax():
    jax_engine, engine, images = _engines()
    want = jax_engine.decode_tokens(images)
    got = engine.decode_tokens(images)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=1e-3)
    assert engine.predict_batch(images) == jax_engine.predict_batch(images)


@pytest.mark.slow
def test_serving_model_r4_fused_route_matches_jax():
    """The port's fused route on the shipped weights. JAX runs its fused
    decoder step but not its whole-block encoder kernel: that kernel pads
    before LN1 and so differs from swin_block on these weights (their LN1
    biases are nonzero); the port's block kernel computes swin_block's
    function, which is JAX's default encoder."""
    jax_engine, engine, images = _engines(use_fused=True,
                                          pallas_encoder_block=True)
    want = jax_engine.decode_tokens(images)
    got = engine.decode_tokens(images)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=1e-3)
