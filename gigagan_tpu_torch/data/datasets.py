"""Datasets and a batch loader for the trainer (counterpart of
gigagan_tpu/data/datasets.py): ``MockImageDataset`` (random pixels),
``SyntheticShapesDataset`` (a learnable distribution for health runs),
``ImageDataset`` (a local folder of images), ``TextImageDataset`` (the base
of (image, caption) datasets), ``MockTextImageDataset`` and
``DataLoader``.

Images are float32 (h, w, c) numpy arrays in [0, 1]; batches are stacked
(b, h, w, c) arrays, and (images, captions) tuples for text datasets
(``collate_tensors_or_str``).  The loader decodes on ``num_workers``
threads under a background prefetch producer, so the next batches load while the device
runs the current step.  Per-process sharding (data parallel) is not
ported.
"""

from __future__ import annotations

import itertools
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from queue import Empty, Full, Queue
from typing import Optional, Sequence

import numpy as np

from gigagan_tpu_torch.utils import exists


def collate_tensors_or_str(data):
    """Stack arrays, collect strings into a list: a batch of (image,
    caption) items → (images, [captions]); of arrays → (images,)."""
    if not isinstance(data[0], tuple):
        return (np.stack(data),)
    return tuple(list(datum) if isinstance(datum[0], str)
                 else np.stack(datum) for datum in zip(*data))


class DataLoader:
    """Batches of a map-style dataset: optional shuffle from a seeded
    numpy generator (a new permutation each pass), optional drop of the
    last partial batch, ``num_workers`` decode threads (items of up to
    ``prefetch + 1`` batches in flight, so the pool does not drain at a
    batch boundary) and a producer thread that keeps ``prefetch`` batches
    ready.  ``num_workers <= 1`` decodes on the producer thread,
    ``prefetch <= 0`` on the caller's.  The order of the batches does not
    depend on either.  ``collate_fn`` turns a batch's items into the batch
    (``np.stack`` by default)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, *,
                 num_workers: int = 4, prefetch: int = 2, collate_fn=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or np.stack
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n, bs = len(self.dataset), self.batch_size
        return n // bs if self.drop_last else -(-n // bs)

    def _index_batches(self):
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        return [order[start:start + self.batch_size]
                for start in range(0, stop, self.batch_size)]

    def _batches(self):
        index_batches = self._index_batches()
        if self.num_workers <= 1:
            for idx in index_batches:
                yield self.collate_fn([self.dataset[int(i)] for i in idx])
            return
        depth = max(self.prefetch, 1) + 1  # batches of items in flight
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            todo = iter(index_batches)
            for idx in itertools.islice(todo, depth):
                pending.append([pool.submit(self.dataset.__getitem__, int(i))
                                for i in idx])
            while pending:
                items = [f.result() for f in pending.pop(0)]
                idx = next(todo, None)
                if idx is not None:
                    pending.append([pool.submit(self.dataset.__getitem__,
                                                int(i)) for i in idx])
                yield self.collate_fn(items)

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches():
                    if not put(batch):
                        return
            except Exception as e:  # handed to the consumer, re-raised
                put(e)
                return
            put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the consumer stopped early (or finished): end the producer
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except Empty:
                    pass
            thread.join()


def cycle(dl):
    while True:
        yield from dl


def _loader(dataset, batch_size, kwargs):
    kwargs.setdefault("shuffle", True)
    kwargs.setdefault("drop_last", True)
    return DataLoader(dataset, batch_size, **kwargs)


class MockImageDataset:
    """Random images only, for the unconditional quickstart without data;
    the same pixels as the JAX package's for the same (seed, index)."""

    def __init__(self, image_size: int, length: int = int(1e5),
                 channels: int = 3, seed: int = 0):
        self.image_size = image_size
        self.channels = channels
        self.length = length
        self.seed = seed

    def get_dataloader(self, batch_size, **kwargs):
        return _loader(self, batch_size, kwargs)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        return rng.random(
            (self.image_size, self.image_size, self.channels)
        ).astype(np.float32)


class TextImageDataset:
    """The base of text-image datasets: a subclass returns (image (h, w, c)
    float32 in [0, 1], caption) per index."""

    def __init__(self):
        raise NotImplementedError

    def get_dataloader(self, batch_size, **kwargs):
        kwargs.setdefault("collate_fn", collate_tensors_or_str)
        return _loader(self, batch_size, kwargs)

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError


class MockTextImageDataset(TextImageDataset):
    """Random (standard normal, as the JAX package's) images with the
    caption 'mock text'; the same pixels as the JAX package's for the same
    (seed, index)."""

    def __init__(self, image_size: int, length: int = int(1e5),
                 channels: int = 3, seed: int = 0):
        self.image_size = image_size
        self.channels = channels
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        img = rng.standard_normal(
            (self.image_size, self.image_size, self.channels)
        ).astype(np.float32)
        return img, "mock text"


class SyntheticShapesDataset:
    """Structured synthetic images: a smooth two-colour gradient background
    and a few solid rectangles or ellipses.  A learnable distribution,
    unlike the pure-noise mock, for training-health runs without a
    dataset on disk (against noise no generator nears the data, and the
    R1 penalty climbs without bound).  The same pixels as the JAX
    package's for the same (seed, index)."""

    def __init__(self, image_size: int, length: int = int(1e5),
                 channels: int = 3, seed: int = 0, max_shapes: int = 3):
        self.image_size = image_size
        self.channels = channels
        self.length = length
        self.seed = seed
        self.max_shapes = max_shapes

    def get_dataloader(self, batch_size, **kwargs):
        return _loader(self, batch_size, kwargs)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        s, c = self.image_size, self.channels
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / max(s - 1, 1)
        # oriented two-colour gradient background
        theta = rng.uniform(0, 2 * np.pi)
        t = (np.cos(theta) * xx + np.sin(theta) * yy + 1.0) / 2.0
        c0 = rng.random(c).astype(np.float32)
        c1 = rng.random(c).astype(np.float32)
        img = t[..., None] * c1 + (1.0 - t[..., None]) * c0
        for _ in range(rng.integers(1, self.max_shapes + 1)):
            color = rng.random(c).astype(np.float32)
            cx, cy = rng.uniform(0.15, 0.85, size=2)
            rx, ry = rng.uniform(0.08, 0.3, size=2)
            if rng.random() < 0.5:  # ellipse
                m = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1.0
            else:  # rectangle
                m = (np.abs(xx - cx) < rx) & (np.abs(yy - cy) < ry)
            img = np.where(m[..., None], color, img)
        return np.clip(img, 0.0, 1.0).astype(np.float32)


def _load_image(path, image_size: int, hflip: bool,
                convert_to: Optional[str], rng: random.Random,
                fast_jpeg: bool = True):
    """One image: decode, resize the short side to ``image_size``
    (bilinear), flip left-right with probability ½ when ``hflip``, centre
    crop, → float32 (h, w, c) in [0, 1]."""
    from PIL import Image

    img = Image.open(path)
    if fast_jpeg and img.format == "JPEG":
        # decode straight to the smallest DCT scale at least the target's
        # short side; the resize below lands on the exact size
        img.draft("RGB", (image_size, image_size))
    if exists(convert_to) and img.mode != convert_to:
        img = img.convert(convert_to)
    elif img.mode != "RGB":
        img = img.convert("RGB")

    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize(
        (max(round(w * scale), image_size), max(round(h * scale), image_size)),
        Image.BILINEAR,
    )
    if hflip and rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)

    w, h = img.size
    left = (w - image_size) // 2
    top = (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))

    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


class ImageDataset:
    """The images of a local folder (searched recursively by extension),
    at least 101 of them.  PIL decodes them; it is imported when the
    dataset is built, not with this module."""

    def __init__(self, folder, image_size: int,
                 exts: Sequence[str] = ("jpg", "jpeg", "png", "tiff"),
                 augment_horizontal_flip: bool = False,
                 convert_image_to: Optional[str] = None, seed: int = 0,
                 fast_jpeg: bool = True):
        try:
            import PIL  # noqa: F401
        except ImportError as e:
            raise ImportError("PIL is required for ImageDataset") from e
        self.folder = folder
        self.image_size = image_size
        self.paths = [p for ext in exts
                      for p in Path(folder).glob(f"**/*.{ext}")]
        assert len(self.paths) > 0, "your folder contains no images"
        assert len(self.paths) > 100, (
            "you need at least 100 images, 10k for research paper, "
            "millions for miraculous results (try Laion-5B)"
        )
        self.augment_horizontal_flip = augment_horizontal_flip
        self.convert_image_to = convert_image_to
        self.seed = seed
        self.fast_jpeg = fast_jpeg
        self._counter = itertools.count()

    def get_dataloader(self, batch_size, **kwargs):
        return _loader(self, batch_size, kwargs)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        # a random.Random per call from (seed, index, call number): safe
        # under the loader's decode threads, and a new flip every epoch
        rng = random.Random(hash((self.seed, index, next(self._counter))))
        return _load_image(
            self.paths[index], self.image_size,
            self.augment_horizontal_flip, self.convert_image_to, rng,
            fast_jpeg=self.fast_jpeg,
        )
