"""Training curves: the per-epoch metrics and their plot.

The port of ``handwritten_math_ocr_api_tpu/train/plots.py``; matplotlib is
imported inside ``save_plot``, which returns False without it.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

log = logging.getLogger(__name__)


class MetricHistory:
    """Accumulates per-epoch metrics and renders curves to a PNG."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def append(self, **metrics: float) -> None:
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(float(v))

    def save_plot(self, path: str) -> bool:
        """Loss curves and metric curves side by side. Returns False
        without matplotlib or without metrics."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            log.warning("matplotlib unavailable; skipping curve plot")
            return False
        if not self.history:
            return False
        loss_keys = [k for k in self.history if "loss" in k]
        other_keys = [k for k in self.history if "loss" not in k]
        fig, axes = plt.subplots(1, 2 if other_keys else 1,
                                 figsize=(12, 4.5))
        axes = axes if hasattr(axes, "__len__") else [axes]
        for k in loss_keys:
            axes[0].plot(self.history[k], label=k)
        axes[0].set_xlabel("epoch")
        axes[0].set_title("loss")
        axes[0].legend()
        if other_keys:
            for k in other_keys:
                axes[1].plot(self.history[k], label=k)
            axes[1].set_xlabel("epoch")
            axes[1].set_title("metrics")
            axes[1].legend()
        fig.tight_layout()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return True
