"""High-level decode API: ``DecodeEngine``, greedy only.

Port of ``handwritten_math_ocr_api_tpu/decode/api.py`` for the serving
surfaces that greedy decoding answers: ``decode_tokens``, ``predict_batch``
(space-joined token strings), ``predict_single`` and
``predict_with_confidence`` ((cleaned LaTeX, confidence) with the
reference's confidence = exp(mean log-prob) and its fallback string),
``warmup`` and the batch buckets a request batch is padded up to.

The engine runs on ``cuda`` unless it is given ``device="cpu"``, and raises
without a CUDA device. It has two routes, both all kernels on the card:

- the default, the JAX engine's ``use_pallas=True`` configuration: every
  encode through the window attention and patch merging kernels, every
  decode step through the cache-append attention kernel, layer by layer;
- ``use_fused=True, pallas_encoder_block=True``, the JAX engine's fused
  serving configuration (``SERVING_USE_FUSED=1``,
  ``SERVING_PALLAS_ENCODER=1``): the Swin blocks of stages 1-3 as
  whole-block kernels (stage 4 keeps window attention, the merges keep
  their kernel) and every decode step as one launch of the fused
  decoder-step kernel. The two switches are independent, as in JAX.

Beam search, sampling, constrained and streaming decoding are not ported
yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import to_torch
from ..core.config import DecodeConfig, ModelConfig
from ..core.device import resolve_device
from ..core.tokenizer import Tokenizer, clean_latex_output
from ..data.preprocess import normalize
from ..models import model as model_mod
from ..ops.fused_step import build_stacked
from .fused import greedy_decode_fused
from .greedy import GreedyResult, greedy_decode

EMPTY_RESULT_FALLBACK = (
    r"\text{Unable to detect a formula from the image. Please verify the model.}"
)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class DecodeEngine:
    """Bucketed image -> LaTeX greedy decoding on one device."""

    def __init__(self, params, cfg: ModelConfig,
                 decode_cfg: Optional[DecodeConfig] = None,
                 tokenizer: Optional[Tokenizer] = None, *,
                 use_fused: bool = False, pallas_encoder_block: bool = False,
                 device=None):
        """``params``: the model's parameter tree with numpy or tensor
        leaves (a JAX tree after ``np.asarray`` on each leaf, or
        ``convert.random_params``); ``convert.to_torch`` moves it to
        ``device`` with the port's dtype rules. ``use_fused`` stacks the
        decoder weights for the fused step once, here, from ``params``
        (float32 biases and norms, as the JAX engine's bundle);
        ``pallas_encoder_block`` selects the whole-block Swin kernel."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.decode_cfg = decode_cfg or DecodeConfig()
        self.tokenizer = tokenizer
        self.params = to_torch(params, cfg, self.device)
        self.use_fused = use_fused
        self.pallas_encoder_block = pallas_encoder_block
        self.stacked = None
        if use_fused:
            if cfg.kv_heads != cfg.nhead:
                raise NotImplementedError(
                    "use_fused: grouped (MQA/GQA) self-attention is not "
                    "ported; the fused step takes MHA configs only")
            self.stacked = build_stacked(params["decoder"], cfg,
                                          self.device)
        self.last_steps = 0  # decoder steps of the latest decode

    def _pad_batch(self, images) -> Tuple[torch.Tensor, int]:
        """(B, H, W, 1) float or uint8 (or (B, H, W) uint8) -> a normalized
        float32 batch on the device, padded with zero images to the next
        batch bucket."""
        images = np.asarray(images)
        B = images.shape[0]
        bucket = pick_bucket(B, self.decode_cfg.batch_buckets)
        if bucket > B:
            pad = np.zeros((bucket - B, *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        if x.dtype == torch.uint8:  # ship uint8, normalize on the device
            x = normalize(x)
            if x.ndim == 3:
                x = x[..., None]
        return x.float(), B

    @torch.inference_mode()
    def decode_tokens(self, images) -> GreedyResult:
        """images: (B, H, W, 1). Returns the GreedyResult of the true batch
        (bucket padding cut off)."""
        x, B = self._pad_batch(images)
        memory = model_mod.encode(
            self.params, self.cfg, x,
            use_pallas_block=self.pallas_encoder_block)
        max_len = self.decode_cfg.max_seq_len
        if self.use_fused:
            res = greedy_decode_fused(self.params["decoder"], self.stacked,
                                      self.cfg, memory, max_len)
        else:
            res = greedy_decode(self.params["decoder"], self.cfg, memory,
                                max_len)
        self.last_steps = res.steps
        return GreedyResult(res.tokens[:B], res.lengths[:B],
                            res.logprob_sum[:B], res.token_count[:B],
                            res.steps)

    def predict_batch(self, images) -> List[str]:
        """Batched decode -> list of space-joined LaTeX token strings."""
        res = self.decode_tokens(images)
        return self.tokenizer.decode_batch(res.tokens.cpu().numpy())

    def predict_single(self, image) -> Tuple[str, float]:
        """Serving decode -> (cleaned latex, confidence); the fallback string
        and 0.0 when nothing was decoded."""
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[None]
        return self.predict_with_confidence(image)[0]

    def predict_with_confidence(self, images) -> List[Tuple[str, float]]:
        """Per image (cleaned latex, confidence): confidence =
        exp(logprob_sum / token_count), the eos step in the sum but not in
        the count."""
        res = self.decode_tokens(images)
        tokens = res.tokens.cpu().numpy()
        lp = res.logprob_sum.cpu().numpy()
        counts = res.token_count.cpu().numpy()
        out: List[Tuple[str, float]] = []
        for i in range(tokens.shape[0]):
            if counts[i] == 0:
                out.append((EMPTY_RESULT_FALLBACK, 0.0))
                continue
            conf = float(np.exp(lp[i] / counts[i]))
            latex = clean_latex_output(self.tokenizer.decode(tokens[i]))
            out.append((latex, conf))
        return out

    def warmup(self, batch_sizes: Sequence[int] = (1,),
               dtype=np.float32) -> None:
        """Run one decode per batch size, so the first request pays no
        kernel build or allocator growth."""
        h, w = self.cfg.img_h, self.cfg.img_w
        for b in batch_sizes:
            self.decode_tokens(np.zeros((b, h, w, 1), dtype))
