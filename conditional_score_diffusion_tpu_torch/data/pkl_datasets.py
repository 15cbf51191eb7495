"""The splits of a `.pklv4` dataset, as the JAX package's
`data/pkl_datasets.py` batches them.

Copied from there: `pkl_paths`, `load_pkl_images`, `_iterate` and the
batches of two datamodules (:class:`PKLDataModule`; the numpy batch assembly
of `data/native.py`, which its C++ extension only speeds up, by one float32
ulp):

* `General_PKLDataset`: GT images (resized bicubic to ``data.image_size``
  where they differ) degraded on the fly by ``data.task``:
  ``super-resolution`` (y the bicubic LR upsampled back by nearest
  neighbour), ``colorization`` (y the one-channel luma) or ``inpainting``
  (y the image with a random square of ``data.mask_coverage`` of its area
  set to 0; the batch also carries that ``mask``, [B, H, W, 1], 1 inside
  the square; in the test split with ``eval.use_seed`` each item's square
  is drawn from its own generator seeded with its index in the split);
* `LRHR_PKLDataset`: stored LQ/GT pairs, y the LQ image as it is (or
  upsampled by nearest neighbour where the recipe sets ``upscale_lr``);
* `unpaired_PKLDataset`: the GT images alone, a batch a bare NHWC array,
  resized bicubic to ``data.image_size`` (the unconditional recipes);
* `Haar_PKLDataset`: GT images decomposed ``data.level + 1`` times by the
  Haar transform (`ops/haar.py`), paired by ``data.map``: ``approx to
  detail`` (x the last level's detail bands, y its approximation),
  ``bicubic to approx`` or ``bicubic to haar`` (y the stored LQ image).

The train split is shuffled every epoch and, with ``data.use_flip``, each
image (and its LQ partner) flipped horizontally by a mask drawn from the
same numpy generator, ``np.random.default_rng(seed)``, as in JAX (the
inpainting squares after the flip mask, one item after another): the port
and the JAX package give the same batches.  Where `LRHR_PKLDataset` crops
(``data.use_crop``: every split, a ``data.image_size`` square of GT at a
corner drawn on the LQ grid) or rotates (``data.use_rot``: the train
split, k quarter turns), each pair is augmented in turn from that generator,
crop, flip (one draw a pair, not one mask a batch) and rotation, as JAX's
slow path does (`degradations.random_crop` / `random_flip` /
`random_rotation`).
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from . import register_datamodule
from .degradations import (
    bicubic_resize_np,
    grayscale,
    inpainting_degrade,
    nearest_upsample_np,
    random_crop,
    random_flip,
    random_rotation,
    random_square_mask,
    sr_degrade,
)

_PKL_FILES = {
    # dataset -> phase -> (LQ_file, GT_file)
    "DF2K": {
        "train": ("DF2K-tr_X4.pklv4", "DF2K-tr.pklv4"),
        "val": ("DIV2K-va_X4.pklv4", "DIV2K-va.pklv4"),
        "test": ("DIV2K-teFullMod8_X4.pklv4", "DIV2K-teFullMod8.pklv4"),
    },
    "celebA-HQ-160": {
        "train": ("CelebAHq_160_MBic_tr_X8.pklv4", "CelebAHq_160_MBic_tr.pklv4"),
        "val": ("CelebAHq_160_MBic_va_X8.pklv4", "CelebAHq_160_MBic_va.pklv4"),
        "test": ("CelebAHq_160_MBic_va_X8.pklv4", "CelebAHq_160_MBic_va.pklv4"),
    },
}


def pkl_paths(config, phase: str) -> Dict[str, str]:
    dataset = config.data.dataset
    base = os.path.join(config.data.base_dir, dataset)
    if dataset not in _PKL_FILES:
        # locally built datasets: {base_dir}/{dataset}/{dataset}-{phase}.pklv4 (GT)
        # and {dataset}-{phase}_X{scale}.pklv4 (LQ, optional)
        gt = f"{dataset}-{phase}.pklv4"
        scale = config.data.get("scale", 4)
        lq = f"{dataset}-{phase}_X{scale}.pklv4"
        if os.path.exists(os.path.join(base, gt)):
            return {"LQ": os.path.join(base, lq), "GT": os.path.join(base, gt)}
        raise NotImplementedError(f"{dataset} is not supported.")
    lq, gt = _PKL_FILES[dataset][phase]
    return {"LQ": os.path.join(base, lq), "GT": os.path.join(base, gt)}


def load_pkl_images(path: str, n_max: int = int(1e9)) -> List[np.ndarray]:
    """HWC uint8 image list from a .pklv4 file (a pickle this repo's dataset
    scripts write; load only trusted files)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        images = pickle.load(f)
    if len(images) == 0:
        raise ValueError(f"{path} holds no images")
    return [np.asarray(im) for im in images[:n_max]]


def assemble_batch(images: List[np.ndarray], flips: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 HWC images -> one float32 [0, 1] NHWC batch; image ``i``
    flipped horizontally where ``flips[i]``."""
    return np.stack([
        (im[:, ::-1] if flips is not None and flips[i] else im).astype(np.float32) / 255.0
        for i, im in enumerate(images)
    ])


GENERAL_TASKS = ("super-resolution", "colorization", "inpainting")


def make_general_batch(
    images: List[np.ndarray],
    task: str,
    image_size: int,
    scale: int = 4,
    flips: Optional[np.ndarray] = None,
    mask_coverage: float = 0.25,
    rng: Optional[np.random.Generator] = None,
    seeds: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """One `General_PKLDataset` batch of ``task``: ``{'x': GT, 'y': its
    degradation}`` (inpainting: and ``'mask'``, each item's square drawn
    from ``rng``, or from its own generator seeded with ``seeds[i]``)."""
    x = assemble_batch(images, flips)
    if x.shape[1] != image_size:
        x = bicubic_resize_np(x, image_size)
    if task == "super-resolution":
        return {"x": x, "y": sr_degrade(x, scale)}
    if task == "colorization":
        return {"x": x, "y": grayscale(x)}
    if task == "inpainting":
        mask = random_square_mask(x.shape, mask_coverage, rng, seeds=seeds)
        return {"x": x, "y": inpainting_degrade(x, mask), "mask": mask}
    raise NotImplementedError(f"task {task!r} not supported")


def make_lrhr_batch(
    lr: List[np.ndarray], hr: List[np.ndarray], upscale_lr: bool, flips: Optional[np.ndarray] = None
) -> Dict[str, np.ndarray]:
    """``{'x': HR, 'y': LQ}`` of stored pairs, each pair flipped together
    (LQ upsampled by nearest neighbour to the HR size when ``upscale_lr``)."""
    x, y = assemble_batch(hr, flips), assemble_batch(lr, flips)
    if upscale_lr:
        y = nearest_upsample_np(y, x.shape[1] // y.shape[1])
    return {"x": x, "y": y}


def make_augmented_lrhr_batch(
    lr: List[np.ndarray], hr: List[np.ndarray], upscale_lr: bool, rng: np.random.Generator,
    crop: int, scale: int, use_flip: bool, use_rot: bool,
) -> Dict[str, np.ndarray]:
    """``{'x': HR, 'y': LQ}`` of stored pairs, each pair cropped (``crop``, a
    GT size, or 0), flipped and rotated in turn with draws of ``rng``."""
    xs, ys = [], []
    for h, l in zip(hr, lr):
        if crop:
            h, l = random_crop(h, l, crop, scale, rng)
        if use_flip:
            h, l = random_flip(h, l, rng=rng)
        if use_rot:
            h, l = random_rotation(h, l, rng=rng)
        xs.append(h)
        ys.append(l)
    x = np.stack(xs).astype(np.float32) / 255.0
    y = np.stack(ys).astype(np.float32) / 255.0
    if upscale_lr:
        y = nearest_upsample_np(y, x.shape[1] // y.shape[1])
    return {"x": x, "y": y}


def iter_test_batches(config, batch_size=None) -> Iterator[Dict[str, np.ndarray]]:
    """The test split in order, as the recipe's datamodule's `test_iterator`
    yields it (incomplete last batch dropped)."""
    return PKLDataModule(config).test_iterator(batch_size)


DATAMODULES = ("General_PKLDataset", "LRHR_PKLDataset", "unpaired_PKLDataset", "Haar_PKLDataset")
HAAR_MAPS = ("approx to detail", "bicubic to approx", "bicubic to haar")


def make_unpaired_batch(
    images: List[np.ndarray], image_size: int, use_flip: bool, rng: np.random.Generator
) -> np.ndarray:
    """One float32 [0, 1] NHWC batch of GT images, each flipped horizontally
    where a draw of ``rng`` (one per image, in order) is below 0.5, resized
    bicubic to ``image_size``."""
    xs = []
    for im in images:
        hr = im.astype(np.float32) / 255.0
        if use_flip and rng.random() < 0.5:
            hr = np.ascontiguousarray(hr[:, ::-1, :])
        xs.append(hr)
    x = np.stack(xs)
    return bicubic_resize_np(x, image_size) if x.shape[1] != image_size else x


def make_haar_batch(
    hr: List[np.ndarray], lr: Optional[List[np.ndarray]], level: int, mapping: str,
    flips: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """One `Haar_PKLDataset` batch: the GT images through ``level + 1`` Haar
    decompositions (torch on the CPU), paired as ``mapping`` says; ``lr``
    (the stored LQ images) only for the maps that read it."""
    import torch

    from ..ops.haar import multi_level_haar_forward

    if mapping not in HAAR_MAPS:
        raise NotImplementedError(f"Mapping <<{mapping}>> is not supported")
    x = assemble_batch(hr, flips)
    approx, detail = (t.numpy() for t in multi_level_haar_forward(torch.from_numpy(x), int(level) + 1))
    if mapping == "approx to detail":
        return {"x": detail, "y": approx}
    y = assemble_batch(lr, flips)
    if mapping == "bicubic to approx":
        return {"x": approx, "y": y}
    return {"x": np.concatenate([approx, detail], axis=-1), "y": y}


class PKLDataModule:
    """The split iterators of `General_PKLDataset`, `LRHR_PKLDataset`,
    `unpaired_PKLDataset` and `Haar_PKLDataset` (JAX `GeneralPKLDataModule`,
    `LRHRPKLDataModule`, `UnpairedPKLDataModule`, `HaarPKLDataModule`).

    A split's files are read at its first use, and the LQ file only where
    the batches use it, so a machine that holds only some files can iterate
    what they make."""

    def __init__(self, config):
        self.config = config
        self.seed = config.seed
        if config.data.datamodule not in DATAMODULES:
            raise NotImplementedError(f"datamodule {config.data.datamodule!r} is not ported")
        self.lrhr = config.data.datamodule == "LRHR_PKLDataset"
        self.unpaired = config.data.datamodule == "unpaired_PKLDataset"
        self.haar = config.data.datamodule == "Haar_PKLDataset"
        # which datamodules read the stored LQ images
        self.reads_lq = self.lrhr or (self.haar and config.data.map != "approx to detail")
        self._images: Dict[str, Dict[str, List[np.ndarray]]] = {}

    def images(self, phase: str) -> Dict[str, List[np.ndarray]]:
        if phase not in self._images:
            paths = pkl_paths(self.config, phase)
            split = {"hr": load_pkl_images(paths["GT"])}
            if self.reads_lq:
                split["lr"] = load_pkl_images(paths["LQ"])
                if len(split["lr"]) != len(split["hr"]):
                    raise ValueError(f"{len(split['lr'])} LQ images for {len(split['hr'])} GT images")
            self._images[phase] = split
        return self._images[phase]

    def _iterate(self, n: int, batch_size: int, shuffle: bool, loop: bool, make_batch: Callable):
        rng = np.random.default_rng(self.seed)
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for i in range(0, n - batch_size + 1, batch_size):
                yield make_batch(order[i : i + batch_size], rng)
            if not loop:
                return

    def make_batch_fn(self, phase: str) -> Callable:
        """``make_batch(indices, rng)`` of ``phase``: the flip mask is drawn
        from ``rng`` (train only, with ``data.use_flip``)."""
        c = self.config
        use_flip = c.data.get("use_flip", False) and phase == "train"
        images = self.images(phase)
        hr = images["hr"]

        def flips_of(idx, rng):
            return (rng.random(len(idx)) < 0.5).astype(np.uint8) if use_flip else None

        if self.haar:
            level, mapping, lr = c.data.level, c.data.map, images.get("lr")

            def make_batch(idx, rng):
                return make_haar_batch(
                    [hr[i] for i in idx], None if lr is None else [lr[i] for i in idx], level, mapping,
                    flips_of(idx, rng),
                )

            return make_batch
        if self.unpaired:
            image_size = c.data.image_size
            return lambda idx, rng: make_unpaired_batch([hr[i] for i in idx], image_size, use_flip, rng)
        if self.lrhr:
            upscale_lr, lr = c.data.get("upscale_lr", False), images["lr"]
            # JAX crops in every split and rotates in the train split
            use_crop = c.data.get("use_crop", False)
            use_rot = c.data.get("use_rot", False) and phase == "train"
            if use_crop or use_rot:
                crop, scale = (c.data.image_size, c.data.scale) if use_crop else (0, 1)
                return lambda idx, rng: make_augmented_lrhr_batch(
                    [lr[i] for i in idx], [hr[i] for i in idx], upscale_lr, rng, crop, scale, use_flip, use_rot,
                )

            def make_batch(idx, rng):
                flips = flips_of(idx, rng)
                return make_lrhr_batch([lr[i] for i in idx], [hr[i] for i in idx], upscale_lr, flips)

            return make_batch
        task = c.data.task
        if task not in GENERAL_TASKS:
            raise NotImplementedError(f"task {task!r} not supported")
        image_size, scale = c.data.image_size, c.data.get("scale", 4)
        mask_coverage = c.data.get("mask_coverage", 0.25)
        use_seed = phase == "test" and c.eval.get("use_seed", False)

        def make_batch(idx, rng):
            flips = flips_of(idx, rng)
            seeds = np.asarray(idx) if use_seed else None
            return make_general_batch(
                [hr[i] for i in idx], task, image_size, scale, flips, mask_coverage, rng, seeds
            )

        return make_batch

    def iterator(self, phase: str, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of ``phase``: the train split shuffled and looped, the
        others in order, once (the incomplete last batch dropped)."""
        train = phase == "train"
        n = len(self.images(phase)["hr"])
        return self._iterate(n, batch_size, train, train, self.make_batch_fn(phase))

    def setup(self):
        """Nothing: a split is read at its first use."""

    def train_iterator(self, batch_size: Optional[int] = None):
        return self.iterator("train", batch_size or self.config.training.batch_size)

    def val_iterator(self, batch_size: Optional[int] = None):
        """The eval split, ``eval.loss_split`` (default ``val``): the eval
        loss and the visualization callbacks read it."""
        split = self.config.eval.get("loss_split", "val")
        return self.iterator(split, batch_size or self.config.eval.batch_size)

    def test_iterator(self, batch_size: Optional[int] = None):
        return self.iterator("test", batch_size or self.config.eval.batch_size)


for _name in DATAMODULES:
    register_datamodule(PKLDataModule, name=_name)


class PrefetchIterator:
    """Batches of ``iterator`` made ahead on a background thread, at most
    ``depth`` waiting (JAX `data/native.py:PrefetchIterator`): the host
    builds the next batch while the device runs the step.  `close` stops
    the thread (the train iterator never ends by itself)."""

    def __init__(self, iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def run():
            try:
                for item in iterator:
                    if not self._put(item):
                        return
            except BaseException as e:  # raised again in the consumer
                self._err = e
            finally:
                self._put(self._sentinel)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
