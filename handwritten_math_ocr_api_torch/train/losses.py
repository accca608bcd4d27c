"""Training loss: label-smoothed cross-entropy with PAD masked, and the
teacher-forced token accuracy.

The port of ``handwritten_math_ocr_api_tpu/train/losses.py``, whose loss is
``torch.nn.CrossEntropyLoss(ignore_index=pad, label_smoothing=eps)``: the
smoothing mass spread over all V classes (PAD's too), the mean taken over
the positions whose target is not PAD. A batch of PAD targets only gives 0,
as the JAX function's count of at least 1 does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smoothed_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           pad_id: int,
                           label_smoothing: float = 0.1) -> torch.Tensor:
    """logits (..., V); targets (...) int. Scalar float32 mean loss over
    the targets that are not ``pad_id``."""
    V = logits.shape[-1]
    total = F.cross_entropy(logits.float().reshape(-1, V),
                            targets.reshape(-1).long(), ignore_index=pad_id,
                            label_smoothing=label_smoothing, reduction="sum")
    count = (targets != pad_id).sum().clamp(min=1)
    return total / count


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                   pad_id: int) -> torch.Tensor:
    """Share of the non-PAD targets that the logits' argmax hits."""
    mask = targets != pad_id
    correct = ((logits.argmax(dim=-1) == targets) & mask).sum()
    return correct / mask.sum().clamp(min=1)
