"""The test split: a CSV + PNG dataset and its batch loader.

The port of ``handwritten_math_ocr_api_tpu/data/dataset.py``'s evaluation
part. A split is ``{split}_labels.csv`` (columns ``image_filename,
latex_label``, read with the ``csv`` module) and its PNGs under
``{split}_formulas/``, decoded by the port's PNG reader. Each sample is the
uint8 image and ``<sos> tokens <eos>`` ids padded or cut to
``max_seq_len``. Batches are dicts: ``image`` uint8 (B, H, W, 1),
``caption`` int32 (B, L), ``length`` int32 (B,), ``valid`` bool (B,); the
last batch is padded to the batch size by repeating row 0, with ``valid``
false on the padding, as in JAX. Training loaders (shuffling, augmentation)
are not ported.

The loader assembles each batch in the caller's thread, decoding its PNGs
together (``data/png.py::decode_png_batch``), where JAX's prefetches in
worker threads (cv2 releases the interpreter lock). The port's decode loops
are bound by the host's launches, which such threads slow down: on an H100
the fused greedy decodes of the 2,000 test images took 32.75 s beside four
image threads and 1.56 s without them.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from ..core.config import DataConfig, ModelConfig
from ..core.tokenizer import Tokenizer
from .png import read_png_batch
from .preprocess import check_size, load_image_png


def read_labels(label_path: str) -> List[Tuple[str, str]]:
    """(image file name, LaTeX label) rows of a labels CSV."""
    with open(label_path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if not rows or rows[0][:2] != ["image_filename", "latex_label"]:
        raise ValueError(f"{label_path}: header is not "
                         "image_filename,latex_label")
    return [(r[0], r[1]) for r in rows[1:]]


class MathFormulaDataset:
    """Index-able dataset of (image_u8 (H, W), caption (L,), length)."""

    def __init__(self, img_dir: str, label_path: str, tokenizer: Tokenizer,
                 img_h: int = 96, img_w: int = 320, max_seq_len: int = 150):
        self.img_dir = img_dir
        self.rows = read_labels(label_path)
        self.tokenizer = tokenizer
        self.img_h, self.img_w = img_h, img_w
        self.max_seq_len = max_seq_len

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int):
        name, label = self.rows[idx]
        img = load_image_png(os.path.join(self.img_dir, name), self.img_h,
                             self.img_w)
        return (img, *self._caption(label))

    def _caption(self, label: str):
        ids = self.tokenizer.encode(label, max_len=self.max_seq_len)
        length = min(len(self.tokenizer.encode(label)), self.max_seq_len)
        return np.asarray(ids, np.int32), length

    def batch(self, idxs: Sequence[int]):
        """The samples ``idxs`` at once: images uint8 (n, H, W) and each
        sample's (caption, length)."""
        paths = [os.path.join(self.img_dir, self.rows[i][0]) for i in idxs]
        images = read_png_batch(paths)
        check_size(images[0], self.img_h, self.img_w, paths[0])
        captions = [self._caption(self.rows[i][1]) for i in idxs]
        return images, captions


class DataLoader:
    """Batches of a dataset, in order."""

    def __init__(self, dataset: MathFormulaDataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _assemble(self, idxs: range) -> Dict[str, np.ndarray]:
        imgs, captions = self.dataset.batch(idxs)
        B, target = len(idxs), self.batch_size
        H, W = self.dataset.img_h, self.dataset.img_w
        L = self.dataset.max_seq_len
        images = np.zeros((target, H, W, 1), np.uint8)
        images[:B, :, :, 0] = imgs
        caption = np.zeros((target, L), np.int32)
        lengths = np.zeros((target,), np.int32)
        valid = np.zeros((target,), bool)
        for j, (ids, ln) in enumerate(captions):
            caption[j] = ids
            lengths[j] = ln
            valid[j] = True
        if B < target:  # pad by repeating row 0 to keep shapes static
            images[B:] = images[0]
            caption[B:] = caption[0]
        return {"image": images, "caption": caption, "length": lengths,
                "valid": valid}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        for i in range(0, n, self.batch_size):
            yield self._assemble(range(i, min(i + self.batch_size, n)))


def get_test_loader(tokenizer: Tokenizer, data_cfg: DataConfig,
                    model_cfg: ModelConfig) -> DataLoader:
    """The test split's loader, in CSV order."""
    return DataLoader(
        MathFormulaDataset(data_cfg.img_dir("test"),
                           data_cfg.label_path("test"), tokenizer,
                           model_cfg.img_h, model_cfg.img_w,
                           model_cfg.max_seq_len),
        data_cfg.batch_size)
