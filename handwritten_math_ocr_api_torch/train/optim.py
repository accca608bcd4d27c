"""The optimizer: global-norm clip, Adam, optional warmup; and the plateau
scheduler.

The port of ``handwritten_math_ocr_api_tpu/train/optim.py``, whose chain is
``optax.chain(clip_by_global_norm(c), inject_hyperparams(adam)(lr),
[scale_by_schedule(min(1, (count + 1) / w))])``. ``Optimizer`` computes the
same update with optax's formulas, on flat lists of tensors with PyTorch's
multi-tensor ops:

- clip: where the global norm ``n`` of the gradients reaches ``c``, each
  gradient becomes ``g / n * c`` (optax's rule; ``clip_grad_norm_`` adds
  1e-6 to the norm and so differs);
- Adam (b1 0.9, b2 0.999, eps 1e-8): ``mu = (1 - b1) g + b1 mu``,
  ``nu = (1 - b2) g^2 + b2 nu``, update ``mu_hat / (sqrt(nu_hat) + eps)``
  with the bias corrections of the incremented count, times ``-lr``; the
  constants in float32 as optax holds them (``1 - b2`` is float32's
  ``1 - 0.999``, 1.3e-5 off 0.001);
- warmup: the update times ``min(1, (count + 1) / w)``, count starting at
  0: a factor of the learning rate, exact since Adam's update is linear in
  it.

The learning rate is a tensor of the state, read and replaced by
``get_learning_rate``/``set_learning_rate`` as the JAX functions read the
injected hyperparameter; the step reads no value on the host. The state is
a dict of tensors (``count``, ``mu``, ``nu``, ``lr``; ``warmup_count`` when
warmup is on), so that a checkpoint stores it as it is and a resume under
another chain sees another structure, as optax's state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig


# Adam's constants (optax's defaults), float32 as optax holds them
B1, B2, EPS = np.float32(0.9), np.float32(0.999), 1e-8


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip -> Adam -> warmup over a flat list of parameter tensors."""

    learning_rate: float = 3e-4
    grad_clip_norm: float = 1.0
    warmup_steps: int = 0

    def init(self, leaves: Sequence[torch.Tensor]) -> Dict:
        dev = leaves[0].device if leaves else None
        state = {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
            "lr": torch.tensor(self.learning_rate, dtype=torch.float32,
                               device=dev),
        }
        if self.warmup_steps > 0:
            state["warmup_count"] = torch.zeros((), dtype=torch.int32,
                                                device=dev)
        return state

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict,
               scales: Sequence[float] = ()
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(updates, the gradients' global norm before the clip) of
        ``grads`` (which it clips in place), advancing ``state`` in place.
        ``scales``: a factor for each leaf, the per-subtree multiplier of
        the JAX step's ``encoder_update_scale``, applied after the
        chain."""
        norm = global_norm(grads)
        clip = self.grad_clip_norm
        keep = norm < clip
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        # g / n * c where n >= c, else g unchanged (t / 1 * 1 = t exactly)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * clip))
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, float(B1))
        torch._foreach_add_(mu, torch._foreach_mul(grads,
                                                   float(np.float32(1) - B1)))
        torch._foreach_mul_(nu, float(B2))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, float(np.float32(1) - B2))
        torch._foreach_add_(nu, sq)
        state["count"] += 1
        t = state["count"].float()
        # (1 - b^t) in float32, as optax's bias correction
        c1 = 1.0 - torch.pow(torch.tensor(float(B1), device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(float(B2), device=t.device), t)
        mu_hat = torch._foreach_div(mu, c1)
        nu_hat = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, EPS)
        updates = torch._foreach_div(mu_hat, nu_hat)
        torch._foreach_mul_(updates, -state["lr"])
        if "warmup_count" in state:
            w = float(self.warmup_steps)
            factor = torch.clamp((state["warmup_count"].float() + 1.0) / w,
                                 max=1.0)
            torch._foreach_mul_(updates, factor)
            state["warmup_count"] += 1
        groups: Dict[float, List[torch.Tensor]] = {}
        for u, s in zip(updates, scales):
            if s != 1.0:
                groups.setdefault(s, []).append(u)
        for s, us in groups.items():
            torch._foreach_mul_(us, s)
        return updates, norm


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """The JAX package's chain for ``cfg``: clip at ``grad_clip_norm``,
    Adam at ``learning_rate``, warmup over ``warmup_steps`` (0: none)."""
    return Optimizer(learning_rate=cfg.learning_rate,
                     grad_clip_norm=cfg.grad_clip_norm,
                     warmup_steps=cfg.warmup_steps)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    a float32 scalar tensor."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def get_learning_rate(opt_state) -> float:
    return float(opt_state["lr"])


def set_learning_rate(opt_state, lr: float):
    """A new state with the learning rate replaced (the tensors of the old
    one shared)."""
    new = dict(opt_state)
    new["lr"] = torch.tensor(lr, dtype=torch.float32,
                             device=opt_state["lr"].device)
    return new


@dataclasses.dataclass
class PlateauScheduler:
    """torch ReduceLROnPlateau(mode='min') semantics, epoch-level."""

    factor: float = 0.5
    patience: int = 3
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed the epoch's val metric; returns the (possibly reduced) lr."""
        if metric < self.best:
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self) -> dict:
        return {"factor": self.factor, "patience": self.patience,
                "min_lr": self.min_lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    @classmethod
    def from_state_dict(cls, d: dict) -> "PlateauScheduler":
        return cls(**d)
