"""PyTorch/CUDA port of the handwritten-math OCR framework (image -> LaTeX).

The package mirrors ``handwritten_math_ocr_api_tpu`` module by module and is
held against it by the ``tests/test_torch_*.py`` parity tests. It imports
torch and numpy only. Served greedy decoding, beam search and continuous
batching run on an NVIDIA Hopper card; the TPU's Pallas kernels on those
paths are hand-written CUDA kernels under ``csrc/`` (see ``ops/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of dropping to the CPU.

Public API (lazy — importing the package pulls in no torch):

    from handwritten_math_ocr_api_torch import (
        ModelConfig, DecodeConfig, Tokenizer, DecodeEngine,
        load_model_config, load_vocab,
    )
"""

__version__ = "0.1.0"

_LAZY = {
    "ModelConfig": ("handwritten_math_ocr_api_torch.core.config",
                    "ModelConfig"),
    "DecodeConfig": ("handwritten_math_ocr_api_torch.core.config",
                     "DecodeConfig"),
    "load_model_config": ("handwritten_math_ocr_api_torch.core.config",
                          "load_model_config"),
    "Tokenizer": ("handwritten_math_ocr_api_torch.core.tokenizer",
                  "Tokenizer"),
    "load_vocab": ("handwritten_math_ocr_api_torch.core.tokenizer",
                   "load_vocab"),
    "DecodeEngine": ("handwritten_math_ocr_api_torch.decode.api",
                     "DecodeEngine"),
}

__all__ = list(_LAZY) + ["__version__"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
