"""High-level decode API: ``DecodeEngine``, greedy and beam search.

Port of ``handwritten_math_ocr_api_tpu/decode/api.py`` for the serving
surfaces that greedy and beam decoding answer: ``decode_tokens`` and
``predict_batch`` (space-joined token strings), both with ``beam_size``,
``predict_single`` and ``predict_with_confidence`` ((cleaned LaTeX,
confidence) with the reference's confidence = exp(mean log-prob) and its
fallback string; greedy, as in the reference, whatever ``beam_size``),
``warmup`` and the batch buckets a request batch is padded up to.

The engine runs on ``cuda`` unless it is given ``device="cpu"``, and raises
without a CUDA device. It has two routes, both all kernels on the card:

- the default, the JAX engine's ``use_pallas=True`` configuration: every
  encode through the window attention and patch merging kernels, every
  decode step (greedy or beam) through the cache-append attention kernel,
  layer by layer;
- ``use_fused=True, pallas_encoder_block=True``, the JAX engine's fused
  serving configuration (``SERVING_USE_FUSED=1``,
  ``SERVING_PALLAS_ENCODER=1``): the Swin blocks of stages 1-3 as
  whole-block kernels (stage 4 keeps window attention, the merges keep
  their kernel); every greedy step as one launch of the fused decoder-step
  kernel, every beam step as one launch of the ragged step kernel and one
  of the beam cache reorder. The two switches are independent, as in JAX.

Beam search decodes the images of the request only: the zero images that
pad a batch to its bucket are encoded (the encoder runs at the bucket) but
not decoded, as their rows of the result are dropped anyway. Sampling,
constrained and streaming decoding are not ported yet.
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
from ..ops.fused_step import build_stacked_full
from ..ops.swin_block import with_float32_biases
from .beam import beam_decode
from .fused import beam_decode_fused, greedy_decode_fused
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
    """Bucketed image -> LaTeX greedy and beam decoding on one device."""

    def __init__(self, params, cfg: ModelConfig,
                 decode_cfg: Optional[DecodeConfig] = None,
                 tokenizer: Optional[Tokenizer] = None, *,
                 use_fused: bool = False, pallas_encoder_block: bool = False,
                 device=None):
        """``params``: the model's parameter tree with numpy or tensor
        leaves (a JAX tree after ``np.asarray`` on each leaf, or
        ``convert.random_params``); ``convert.to_torch`` moves it to
        ``device`` with the port's dtype rules. ``use_fused`` stacks the
        decoder weights for the fused steps once, here, from ``params``
        (``build_stacked_full``: float32 biases, norms, embedding and head
        tables, as the JAX engine's bundle; greedy and beam share it);
        ``pallas_encoder_block`` selects the whole-block Swin kernel and
        gives its blocks their float32 biases."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.decode_cfg = decode_cfg or DecodeConfig()
        self.tokenizer = tokenizer
        self.params = to_torch(params, cfg, self.device)
        if pallas_encoder_block:
            self.params["encoder"] = with_float32_biases(
                params["encoder"], self.params["encoder"])
        self.use_fused = use_fused
        self.pallas_encoder_block = pallas_encoder_block
        self.stacked = None
        if use_fused:
            if cfg.kv_heads != cfg.nhead:
                raise NotImplementedError(
                    "use_fused: grouped (MQA/GQA) self-attention is not "
                    "ported; the fused step takes MHA configs only")
            self.stacked = build_stacked_full(params["decoder"], cfg,
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
    def decode_tokens(self, images, beam_size: Optional[int] = None):
        """images: (B, H, W, 1). Returns the GreedyResult, or with
        ``beam_size`` > 1 the BeamResult, of the true batch (bucket padding
        cut off)."""
        x, B = self._pad_batch(images)
        memory = model_mod.encode(
            self.params, self.cfg, x,
            use_pallas_block=self.pallas_encoder_block)
        max_len = self.decode_cfg.max_seq_len
        if beam_size and beam_size > 1:
            if self.use_fused:
                res = beam_decode_fused(self.params["decoder"], self.stacked,
                                        self.cfg, memory[:B], beam_size,
                                        max_len)
            else:
                res = beam_decode(self.params["decoder"], self.cfg,
                                  memory[:B], beam_size, max_len)
            self.last_steps = res.steps
            return res
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

    def predict_batch(self, images,
                      beam_size: Optional[int] = None) -> List[str]:
        """Batched decode (greedy, or beam search with ``beam_size`` > 1)
        -> list of space-joined LaTeX token strings."""
        res = self.decode_tokens(images, beam_size)
        return self.tokenizer.decode_batch(res.tokens.cpu().numpy())

    def predict_single(self, image,
                       beam_size: Optional[int] = None) -> Tuple[str, float]:
        """Serving decode -> (cleaned latex, confidence); the fallback string
        and 0.0 when nothing was decoded. Greedy whatever ``beam_size``, as
        the reference's serving path (and the JAX engine) decodes."""
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
               beam_sizes: Sequence[int] = (), dtype=np.float32) -> None:
        """Run one decode per batch size, greedy and at each beam size, so
        the first request pays no kernel build or allocator growth."""
        h, w = self.cfg.img_h, self.cfg.img_w
        for b in batch_sizes:
            dummy = np.zeros((b, h, w, 1), dtype)
            self.decode_tokens(dummy)
            for k in beam_sizes:
                self.decode_tokens(dummy, beam_size=k)
