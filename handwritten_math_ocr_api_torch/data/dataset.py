"""A CSV + PNG dataset and its batch loader.

The port of ``handwritten_math_ocr_api_tpu/data/dataset.py``. A split is
``{split}_labels.csv`` (columns ``image_filename, latex_label``, read with
the ``csv`` module) and its PNGs under ``{split}_formulas/``, decoded by the
port's PNG reader and stretch-resized to the model's size with cv2, as the
JAX loader resizes them. Each sample is the uint8 image and
``<sos> tokens <eos>`` ids padded or cut to ``max_seq_len``. Batches are
dicts: ``image`` uint8 (B, H, W, 1), ``caption`` int32 (B, L), ``length``
int32 (B,), ``valid`` bool (B,); a short last batch is dropped
(``drop_remainder``) or padded to the batch size by repeating row 0, with
``valid`` false on the padding, as in JAX. Shuffling draws each epoch's
order from ``np.random.default_rng(seed + epoch)``, so the batches are
JAX's; a dataset with ``set_epoch`` (a synthetic stream) is told the epoch
before each pass.

``num_workers`` > 0 assembles the batches in a producer thread feeding a
bounded queue of ``prefetch`` batches, each batch's samples loaded by a
pool of that many threads, as JAX's loader does; the producer stops when
the consumer leaves. ``num_workers=0`` assembles each batch in the
caller's thread, decoding a file dataset's PNGs together
(``data/png.py::decode_png_batch``): the test loader's way, since the
port's decode loops are bound by the host's launches, which such threads
slow down (on an H100 the fused greedy decodes of the 2,000 test images
took 32.75 s beside four image threads and 1.56 s without them). A batch's
images are stacked by numpy, where JAX's loader takes the host C++
library's ``assemble_batch``: on an H100 host that thread pool was slower
than ``np.stack`` for a training batch (``chip_smoke.py``'s
``native_timing``).
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import os
import queue
import threading
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from ..core.config import DataConfig, ModelConfig
from ..core.tokenizer import Tokenizer
from .png import read_png_batch
from .preprocess import load_image_png, stretch


def read_labels(label_path: str) -> List[Tuple[str, str]]:
    """(image file name, LaTeX label) rows of a labels CSV."""
    with open(label_path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if not rows or rows[0][:2] != ["image_filename", "latex_label"]:
        raise ValueError(f"{label_path}: header is not "
                         "image_filename,latex_label")
    return [(r[0], r[1]) for r in rows[1:]]


def encode_caption(tokenizer: Tokenizer, label: str, max_seq_len: int):
    """(ids (max_seq_len,) int32, length): the label's ids padded or cut,
    and the length of the uncut sequence capped at ``max_seq_len``."""
    ids = tokenizer.encode(label, max_len=max_seq_len)
    length = min(len(tokenizer.encode(label)), max_seq_len)
    return np.asarray(ids, np.int32), length


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
        return (img, *encode_caption(self.tokenizer, label,
                                     self.max_seq_len))

    def batch(self, idxs: Sequence[int]):
        """The samples ``idxs`` at once: images uint8 (n, H, W) and each
        sample's (caption, length)."""
        paths = [os.path.join(self.img_dir, self.rows[i][0]) for i in idxs]
        try:
            images = read_png_batch(paths)
        except ValueError as e:  # images of different sizes: one by one
            if "different sizes" not in str(e):
                raise
            images = np.stack([load_image_png(p, self.img_h, self.img_w)
                               for p in paths])
        if images.shape[1:] != (self.img_h, self.img_w):
            images = np.stack([stretch(im, self.img_h, self.img_w)
                               for im in images])
        captions = [encode_caption(self.tokenizer, self.rows[i][1],
                                   self.max_seq_len) for i in idxs]
        return images, captions


class DataLoader:
    """Batches of a dataset: see the module docstring."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 0, prefetch: int = 4,
                 drop_remainder: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the next pass (the shuffle and a stream's samples
        follow it); each pass advances it by one."""
        self._epoch = int(epoch)

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        batches = []
        for i in range(0, n, self.batch_size):
            chunk = order[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_remainder:
                continue
            batches.append(chunk)
        return batches

    def _samples(self, idxs, pool):
        """(images (n, H, W) uint8, [(caption, length)])."""
        if pool is None and hasattr(self.dataset, "batch"):
            return self.dataset.batch(idxs)
        get = self.dataset.__getitem__
        samples = list(pool.map(get, idxs) if pool is not None
                       else map(get, idxs))
        return (np.stack([s[0] for s in samples]),
                [(s[1], s[2]) for s in samples])

    def _assemble(self, idxs, pool=None) -> Dict[str, np.ndarray]:
        imgs, captions = self._samples(idxs, pool)
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
        if hasattr(self.dataset, "set_epoch"):  # streaming datasets
            self.dataset.set_epoch(self._epoch)
        batches = self._batch_indices()
        self._epoch += 1
        if self.num_workers <= 0:
            for idxs in batches:
                yield self._assemble(idxs)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure: List[BaseException] = []

        def put(item) -> bool:
            # a bounded put that notices the consumer leaving, so that an
            # early exit does not leave this thread blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set() or not put(
                                self._assemble(idxs, pool)):
                            return
            except BaseException as e:  # raised in the consumer
                failure.append(e)
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if failure:
                        raise failure[0]
                    return
                yield item
        finally:
            stop.set()
            t.join()


def get_data_loaders(tokenizer: Tokenizer, data_cfg: DataConfig,
                     model_cfg: ModelConfig):
    """(train, val) loaders: the train split shuffled by
    ``data_cfg.shuffle_seed`` with the remainder dropped, the validate
    split in order; both on ``data_cfg.num_workers`` threads. Augmentation
    runs in the train step, on the device."""
    def mk(split, shuffle):
        return DataLoader(
            MathFormulaDataset(data_cfg.img_dir(split),
                               data_cfg.label_path(split), tokenizer,
                               model_cfg.img_h, model_cfg.img_w,
                               model_cfg.max_seq_len),
            data_cfg.batch_size, shuffle=shuffle, seed=data_cfg.shuffle_seed,
            num_workers=data_cfg.num_workers, drop_remainder=shuffle)

    return mk("train", True), mk("validate", False)


def get_test_loader(tokenizer: Tokenizer, data_cfg: DataConfig,
                    model_cfg: ModelConfig) -> DataLoader:
    """The test split's loader, in CSV order, in the caller's thread."""
    return DataLoader(
        MathFormulaDataset(data_cfg.img_dir("test"),
                           data_cfg.label_path("test"), tokenizer,
                           model_cfg.img_h, model_cfg.img_w,
                           model_cfg.max_seq_len),
        data_cfg.batch_size)
