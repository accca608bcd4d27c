"""High-level decode API: ``DecodeEngine``, greedy and beam search.

Port of ``handwritten_math_ocr_api_tpu/decode/api.py`` for the serving
surfaces that greedy and beam decoding answer: ``decode_tokens`` and
``predict_batch`` (space-joined token strings), both with ``beam_size``,
``predict_single`` and ``predict_with_confidence`` ((cleaned LaTeX,
confidence) with the reference's confidence = exp(mean log-prob) and its
fallback string; greedy, as in the reference, whatever ``beam_size``),
``warmup`` and the batch buckets a request batch is padded up to.

The engine serves every encoder of ``ModelConfig``: Swin-T, and the
ResNet encoders (``resnet18``, ``res18trans``) with the BatchNorm
statistics of ``model_state``, whose convolutions are cuDNN's (they are
no kernel of the TPU package) and whose 10 memory columns feed the same
decoder kernels. What follows of the encoder kernels is Swin's.

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

``quantize=True`` is the JAX engine's weight-only int8 decoder
(``SERVING_QUANTIZE=1``), on either route as in JAX. On the default route
every decoder projection and the head are int8 with per-column scales
(``ops/quant.py::quantize_decoder_params``, from the float32 tree) and run
through the dequant matmul kernel. On the fused route the greedy and beam
steps stream the int8 bundle (``ops/fused_step.py::quantize_stacked`` of
the stacked, compute-dtype weights) through their int8 entries, while the
cross K/V projection and the greedy float32 head keep the float weights.

Self-attention with fewer KV heads than heads (``nhead_kv``) is served as
the JAX engine serves it. The default route attends through grouped
attention on plain ops for every MQA/GQA config (the cache-append kernel
is MHA only, as in JAX). The fused route takes MHA and MQA
(``nhead_kv=1``: the greedy and beam step kernels' MQA entries). A GQA
config (1 < ``nhead_kv`` < ``nhead``) with ``use_fused`` logs a warning
and decodes on the default route, as JAX's engine does.

Beam search decodes the images of the request only: the zero images that
pad a batch to its bucket are encoded (the encoder runs at the bucket) but
not decoded, as their rows of the result are dropped anyway.

The other decode modes of the JAX engine, on both routes:

- ``constrained=True``: greedy decoding under the pushdown mask of
  ``decode/constrain.py`` (structurally valid LaTeX by construction);
  beam, sampled and streamed decodes ignore it, as in JAX;
- ``sample_tokens`` and ``predict_single_sampled``: temperature, top-k and
  top-p sampling (``decode/sampling.py``) from a seeded
  ``torch.Generator`` on the engine's device; the default route steps
  through ``decoder_step``, the fused one through the fused step kernel
  (``greedy_decode_fused(rng=...)``);
- ``predict_stream``: the greedy tokens in segments (``decode/
  streaming.py``) through ``decoder_step`` on the float (or, on the
  default route, int8) decoder tree, on the fused route too, as JAX's
  engine streams; one host read a segment.
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import state_to_torch, to_torch
from ..core.config import DecodeConfig, ModelConfig
from ..core.device import resolve_device
from ..core.tokenizer import Tokenizer, clean_latex_output
from ..data.preprocess import normalize
from ..models import model as model_mod
from ..ops.fused_step import build_stacked_full, quantize_stacked
from ..ops.quant import quantize_decoder_params
from ..ops.swin_block import with_float32_biases
from .beam import beam_decode
from .constrain import build_tables
from .fused import beam_decode_fused, greedy_decode_fused
from .greedy import GreedyResult, greedy_decode
from .sampling import sample_decode
from .streaming import stream_report, stream_segment, stream_start

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
                 quantize: bool = False, constrained: bool = False,
                 model_state=None, device=None):
        """``params``: the model's parameter tree with numpy or tensor
        leaves (a JAX tree after ``np.asarray`` on each leaf, or
        ``convert.random_params``); ``convert.to_torch`` moves it to
        ``device`` with the port's dtype rules. ``use_fused`` stacks the
        decoder weights for the fused steps once, here, from ``params``
        (``build_stacked_full``: float32 biases, norms, embedding and head
        tables, as the JAX engine's bundle; greedy and beam share it);
        ``pallas_encoder_block`` selects the whole-block Swin kernel and
        gives its blocks their float32 biases. ``quantize`` makes the
        decoder's weights int8: the stacked bundle's with ``use_fused``,
        else the decoder tree's (quantized from ``params`` before it moves
        to the device). A GQA config with ``use_fused`` warns and takes the
        default route (and, with ``quantize``, its int8 decoder tree), as
        the JAX engine does. ``constrained`` constrains greedy decoding
        (module docstring); its tables come from the tokenizer's vocab,
        so it raises ``ValueError`` without one. ``model_state``: the
        model's state tree (a ResNet encoder's BatchNorm statistics, as
        ``load_params_for_serving`` returns it), moved to ``device`` in
        float32; a ResNet encoder ignores ``pallas_encoder_block``, as in
        JAX."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.decode_cfg = decode_cfg or DecodeConfig()
        self.tokenizer = tokenizer
        self.constraint = None
        if constrained:
            if tokenizer is None:
                raise ValueError(
                    "constrained decoding needs a tokenizer (its vocab "
                    "derives the grammar class tables)")
            self.constraint = build_tables(tokenizer.vocab, self.device)
        if use_fused and 1 < cfg.kv_heads < cfg.nhead:
            # the fused steps take MHA and MQA (nhead_kv=1) only
            logging.getLogger(__name__).warning(
                "use_fused requested but config is GQA (nhead_kv=%d of %d "
                "heads): falling back to the default decode path",
                cfg.kv_heads, cfg.nhead)
            use_fused = False
        if quantize and not use_fused:
            params = dict(params)
            params["decoder"] = quantize_decoder_params(params["decoder"])
        self.params = to_torch(params, cfg, self.device)
        self.model_state = state_to_torch(model_state, self.device)
        if pallas_encoder_block and cfg.encoder == "swin_t":
            self.params["encoder"] = with_float32_biases(
                params["encoder"], self.params["encoder"])
        self.use_fused = use_fused
        self.pallas_encoder_block = pallas_encoder_block
        self.quantize = quantize
        self.stacked = None
        if use_fused:
            self.stacked = build_stacked_full(params["decoder"], cfg,
                                               self.device)
            if quantize:
                self.stacked = quantize_stacked(self.stacked)
        self.last_steps = 0  # decoder steps of the latest decode
        self.stream_reads = 0  # host reads of predict_stream's segments

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

    def _encode(self, x):
        return model_mod.encode(self.params, self.cfg, x,
                                use_pallas_block=self.pallas_encoder_block,
                                model_state=self.model_state)

    @staticmethod
    def _trim(res: GreedyResult, B: int) -> GreedyResult:
        return GreedyResult(res.tokens[:B], res.lengths[:B],
                            res.logprob_sum[:B], res.token_count[:B],
                            res.steps)

    def _result(self, tokens, lp_sum, count) -> Tuple[str, float]:
        """(cleaned latex, confidence) of one row's tokens, log-prob sum and
        count: confidence = exp(lp_sum / count), the fallback string and
        0.0 when nothing was decoded."""
        if count == 0:
            return EMPTY_RESULT_FALLBACK, 0.0
        conf = float(np.exp(lp_sum / count))
        return clean_latex_output(self.tokenizer.decode(tokens)), conf

    @torch.inference_mode()
    def decode_tokens(self, images, beam_size: Optional[int] = None):
        """images: (B, H, W, 1). Returns the GreedyResult, or with
        ``beam_size`` > 1 the BeamResult, of the true batch (bucket padding
        cut off)."""
        x, B = self._pad_batch(images)
        memory = self._encode(x)
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
                                      self.cfg, memory, max_len,
                                      constraint=self.constraint)
        else:
            res = greedy_decode(self.params["decoder"], self.cfg, memory,
                                max_len, constraint=self.constraint)
        self.last_steps = res.steps
        return self._trim(res, B)

    @torch.inference_mode()
    def sample_tokens(self, images, *, temperature: float = 1.0,
                      top_k: int = 0, top_p: float = 1.0,
                      seed: int = 0) -> GreedyResult:
        """Sampled decode of (B, H, W, 1) images (``decode/sampling.py``):
        greedy's result structure, of the true batch. The draws come from a
        generator on the engine's device seeded with ``seed``, over the
        batch's bucket."""
        x, B = self._pad_batch(images)
        memory = self._encode(x)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        filters = {"temperature": temperature, "top_k": top_k,
                   "top_p": top_p}
        max_len = self.decode_cfg.max_seq_len
        if self.use_fused:
            res = greedy_decode_fused(self.params["decoder"], self.stacked,
                                      self.cfg, memory, max_len, rng=gen,
                                      **filters)
        else:
            res = sample_decode(self.params["decoder"], self.cfg, memory,
                                gen, max_len, **filters)
        self.last_steps = res.steps
        return self._trim(res, B)

    def predict_single_sampled(self, image, *, temperature: float = 1.0,
                               top_k: int = 0, top_p: float = 1.0,
                               seed: int = 0) -> Tuple[str, float]:
        """Sampled serving decode -> (cleaned latex, confidence), the
        confidence from the raw distribution's log-probs."""
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[None]
        res = self.sample_tokens(image, temperature=temperature, top_k=top_k,
                                 top_p=top_p, seed=seed)
        return self._result(res.tokens[0].cpu().numpy(),
                            float(res.logprob_sum[0]),
                            int(res.token_count[0]))

    def predict_stream(self, image, segment_steps: int = 8) -> Iterator[dict]:
        """Streaming serving decode of one (H, W, 1) image: a generator of
        events, ``{"tokens": [...]}`` with each segment's fresh token
        strings (none for a segment that decoded none), then a final
        ``{"formula", "confidence", "done": True}`` with ``predict_single``'s
        confidence and fallback semantics. The cache stays on the device
        between segments; the host reads once a segment
        (``stream_reads`` counts the reads).

        The stream ends at its first EOS, after ``max_seq_len`` tokens, or,
        unlike JAX's, when the cache is full: a PAD token that the model
        emits is not a token of the stream, and JAX's loop runs on past its
        cache for as long as the model emits them (for ever, at a fixed
        point)."""
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[None]
        dec = self.params["decoder"]
        max_len = self.decode_cfg.max_seq_len
        with torch.inference_mode():
            x, _ = self._pad_batch(image)
            carry = stream_start(dec, self.cfg, self._encode(x)[:1],
                                 max_len, segment_steps)
        all_ids: List[int] = []
        eos_id, pad_id = self.tokenizer.eos_id, self.tokenizer.pad_id
        cap = carry.cache["self_k_0"].shape[2]
        done = False
        while not done and len(all_ids) < max_len and carry.step < cap:
            with torch.inference_mode():
                carry, toks = stream_segment(dec, self.cfg, carry,
                                             segment_steps)
                rep = stream_report(carry, toks)[0].cpu().numpy()
            self.stream_reads += 1
            done = bool(rep[segment_steps])
            fresh: List[str] = []
            for t in rep[:segment_steps].tolist():
                if t == pad_id:
                    break
                all_ids.append(t)
                if t == eos_id:
                    done = True
                    break
                fresh.append(self.tokenizer.idx2char.get(t, "<unk>"))
                if len(all_ids) >= max_len:
                    break
            if fresh:
                yield {"tokens": fresh}
        count = int(rep[segment_steps + 1])
        lp_sum = float(rep[segment_steps + 2:].view(np.float32)[0])
        latex, conf = self._result(all_ids, lp_sum, count)
        yield {"formula": latex, "confidence": conf, "done": True}

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
        return [self._result(t, lp_i, c)
                for t, lp_i, c in zip(tokens, lp, counts)]

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
