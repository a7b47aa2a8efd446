"""Base dataset, batching loader and device prefetcher. Counterpart of
``segtpu/data/base.py``, without cv2: the augmentations run through the
numpy versions of OpenCV's calls in ``segtpu_torch/data/cv.py``.

Augmentation has segtpu's semantics and draw order: random long-side scale
0.5-2x of ``base_size`` (linear for images, nearest for labels), a rotation
of -10..10 degrees about the centre (pixels from outside the frame are 0,
so class 0 in labels), zero padding up to the crop, a random crop, a
horizontal flip and a Gaussian blur with sigma in [0, 1); val resizes the
shorter side to the crop (labels through PIL NEAREST) and takes the centre.
Every draw depends only on the sizes, and every output pixel of the resize
and the warp only on its own coordinates, so the chain is evaluated only
over the crop it keeps: the same pixels as segtpu's chain over the whole
frame, for a fraction of the work.

Each sample draws from a ``random.Random`` keyed on (seed, epoch, index), so
batches depend neither on the number of workers nor on their kind: threads
(``worker_type="thread"``) or forked processes (``"process"``), which
inherit the dataset instead of pickling it. The dataset code is numpy and
PIL only, so the children touch neither torch's thread pools nor CUDA.
"""

from __future__ import annotations

import random
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from segtpu_torch.data import cv

# Datasets visible to forked worker processes, registered before the pool
# forks and looked up by token inside the child.
_FORK_DATASETS: dict = {}


def _sample_rng(seed: int, epoch: int, idx: int) -> random.Random:
    """Per-sample RNG; a tuple of ints hashes the same in every process."""
    return random.Random(hash((seed, epoch, idx)))


def _process_fetch(args):
    token, idx, seed, epoch = args
    return _FORK_DATASETS[token].get(idx, rng=_sample_rng(seed, epoch, idx))


class BaseDataset:
    """Abstract dataset. Subclasses set ``num_classes``/``palette`` before
    calling ``super().__init__`` and implement ``_set_files`` and
    ``_load_data(index) -> (image HWC float32 [0, 255], label HW int, id)``.
    """

    def __init__(self, root, split, mean, std, base_size=None, augment=True,
                 val=False, crop_size=321, scale=True, flip=True, rotate=False,
                 blur=False, return_id=False, device_normalize=False):
        self.root = root
        self.split = split
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.augment = augment
        self.crop_size = crop_size
        self.base_size = base_size
        self.scale = scale
        self.flip = flip
        self.rotate = rotate
        self.blur = blur
        self.val = val
        self.return_id = return_id
        self.device_normalize = device_normalize
        self.files: List = []
        self._set_files()

    def _set_files(self):
        raise NotImplementedError

    def _load_data(self, index: int):
        raise NotImplementedError

    def _val_augmentation(self, image, label):
        """Shorter side resized to the crop, then the centre crop."""
        if self.crop_size:
            crop = self.crop_size
            h, w = label.shape
            if h < w:
                h, w = (crop, int(crop * w / h))
            else:
                h, w = (int(crop * h / w), crop)
            top, left = (h - crop) // 2, (w - crop) // 2
            image = cv.resize_linear(image, (h, w), (top, top + crop),
                                     (left, left + crop))
            # PIL NEAREST, as segtpu (its rounding is not cv2's)
            from PIL import Image

            label = np.asarray(Image.fromarray(label.astype(np.int32)).resize(
                (w, h), resample=Image.NEAREST), dtype=np.int32)
            label = label[top:top + crop, left:left + crop]
        return image, label

    def _train_augmentation(self, image, label, rng: random.Random):
        h, w = image.shape[:2]
        if self.base_size:
            if self.scale:
                longside = rng.randint(int(self.base_size * 0.5),
                                       int(self.base_size * 2.0))
            else:
                longside = self.base_size
            if h > w:
                h, w = (longside, int(1.0 * longside * w / h + 0.5))
            else:
                h, w = (int(1.0 * longside * h / w + 0.5), longside)
        rot = None
        if self.rotate:
            rot = cv.rotation_matrix((w / 2, h / 2), rng.randint(-10, 10), 1.0)
        out_hw, top, left = (h, w), 0, 0
        if self.crop_size:
            crop = self.crop_size
            out_hw = (crop, crop)
            top = rng.randint(0, max(h, crop) - crop)
            left = rng.randint(0, max(w, crop) - crop)
        flip = self.flip and rng.random() > 0.5
        sigma = rng.random() if self.blur else None

        # the kept window of the scaled, rotated (h, w) frame; the rest of
        # the crop is the zero padding
        rows = (top, min(top + out_hw[0], h))
        cols = (left, min(left + out_hw[1], w))
        win_img, win_lab = self._frame_window(image, label, (h, w), rot, rows, cols)
        image = np.zeros(out_hw + image.shape[2:], np.float32)
        label = np.zeros(out_hw, np.int32)
        image[:rows[1] - rows[0], :cols[1] - cols[0]] = win_img
        label[:rows[1] - rows[0], :cols[1] - cols[0]] = win_lab

        if flip:
            image = np.fliplr(image).copy()
            label = np.fliplr(label).copy()
        if sigma is not None:
            ksize = int(3.3 * sigma)
            ksize = ksize + 1 if ksize % 2 == 0 else ksize
            image = cv.gaussian_blur(image, ksize, sigma)
        return image, label

    @staticmethod
    def _frame_window(image, label, hw, rot, rows, cols):
        """Pixels ``rows`` x ``cols`` of the image and label resized to
        ``hw`` (the identity at their own size) and then warped by ``rot``
        (None: not rotated)."""
        def scaled(box_rows, box_cols):
            return (cv.resize_linear(image, hw, box_rows, box_cols),
                    cv.resize_nearest(label, hw, box_rows, box_cols))

        if rot is None:
            return scaled(rows, cols)
        y0, y1, x0, x1 = cv.warp_source_box(rot, hw, hw, rows, cols)
        src_img, src_lab = scaled((y0, y1), (x0, x1))
        return (cv.warp_affine_linear(src_img, rot, hw, rows, cols, (y0, x0)),
                cv.warp_affine_nearest(src_lab, rot, hw, rows, cols, (y0, x0)))

    def normalize(self, image: np.ndarray) -> np.ndarray:
        return (image.astype(np.float32) / 255.0 - self.mean) / self.std

    def __len__(self):
        return len(self.files)

    def get(self, index: int, rng: Optional[random.Random] = None):
        """(image HWC float32 normalized, or HWC uint8 raw pixels with
        ``device_normalize``; label HW int32[; id])."""
        image, label, image_id = self._load_data(index)
        label = np.asarray(label, np.int32)
        if self.val:
            image, label = self._val_augmentation(image, label)
        elif self.augment:
            image, label = self._train_augmentation(image, label, rng or random)
        # the augmented image is quantized to uint8, as the original repo
        # does before ToTensor
        image = np.asarray(image, np.float32).astype(np.uint8)
        if not self.device_normalize:
            image = self.normalize(image)
        if self.return_id:
            return image, label, image_id
        return image, label

    def __getitem__(self, index):
        return self.get(index)

    def __repr__(self):
        return (f"Dataset: {type(self).__name__}\n    # data: {len(self)}\n"
                f"    Split: {self.split}\n    Root: {self.root}")


class DataLoader:
    """Batching loader with fixed shapes. Train drops the ragged tail; val
    pads it with ignore-labeled (-100) samples. ``val_split`` holds out a
    ``RandomState(0)``-shuffled fraction of the dataset (``get_val_loader``),
    as segtpu does. Multi-host sharding is not ported (ROADMAP)."""

    def __init__(self, dataset: BaseDataset, batch_size: int, shuffle: bool,
                 num_workers: int = 4, val_split: float = 0.0,
                 drop_last: Optional[bool] = None, seed: int = 0,
                 indices: Optional[Sequence[int]] = None,
                 worker_type: str = "thread"):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type {worker_type!r}: thread or process")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self._epoch = 0
        self._skip_next = 0
        self.val_split = val_split
        self.worker_type = worker_type
        self._pool = None
        self._token = id(self)
        self._val_indices = None
        if worker_type == "process":
            # fork now, at construction: the CLIs build their loaders before
            # the model goes to the card, so the children fork from a
            # process without live CUDA state
            self._ensure_process_pool()
        if indices is not None:
            self.indices = np.asarray(indices)
            self.shuffle = shuffle
        elif val_split:
            n = len(dataset)
            idx = np.arange(n)
            np.random.RandomState(0).shuffle(idx)
            split_idx = int(n * val_split)
            self._val_indices = idx[:split_idx]
            self.indices = idx[split_idx:]
            self.shuffle = True  # the subset is sampled randomly each epoch
        else:
            self.indices = np.arange(len(dataset))
            self.shuffle = shuffle
        self.drop_last = (not dataset.val) if drop_last is None else drop_last

    def get_val_loader(self) -> Optional["DataLoader"]:
        """The held-out ``val_split`` samples: the train dataset's samples,
        so drop_last is off and the ragged tail is padded."""
        if self._val_indices is None or not self.val_split:
            return None
        return DataLoader(self.dataset, self.batch_size, False, self.num_workers,
                          indices=self._val_indices, drop_last=False,
                          worker_type=self.worker_type, seed=self.seed)

    def __len__(self):
        if self.drop_last:
            return len(self.indices) // self.batch_size
        return -(-len(self.indices) // self.batch_size)

    def _ensure_process_pool(self):
        if self._pool is None:
            import multiprocessing as mp

            # registered before the fork, and again after a close()
            _FORK_DATASETS[self._token] = self.dataset
            self._pool = mp.get_context("fork").Pool(self.num_workers)
        return self._pool

    def close(self):
        """Shut down worker processes (nothing to do for threads)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        _FORK_DATASETS.pop(self._token, None)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def set_epoch(self, n: int):
        """The next ``__iter__`` gives training epoch ``n + 1``'s order (a
        fresh loader starts at 0): the resume hook."""
        self._epoch = n

    def skip_batches(self, k: int):
        """The next ``__iter__`` skips its first ``k`` batches without
        fetching them and yields the rest of that epoch's order: a
        mid-epoch resume continues where the interrupted run stopped."""
        self._skip_next = int(k)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.indices.copy()
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        epoch, seed, bs = self._epoch, self.seed, self.batch_size
        skip, self._skip_next = self._skip_next, 0

        def fetch(idx):
            return self.dataset.get(int(idx), rng=_sample_rng(seed, epoch, int(idx)))

        def batches(mapper):
            for b in range(skip, len(self)):
                samples = list(mapper(order[b * bs:(b + 1) * bs]))
                images = np.stack([s[0] for s in samples])
                labels = np.stack([s[1] for s in samples])
                if len(samples) < bs:  # pad the ragged val tail
                    pad = bs - len(samples)
                    images = np.concatenate(
                        [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
                    labels = np.concatenate(
                        [labels, np.full((pad,) + labels.shape[1:], -100, labels.dtype)])
                yield images, labels

        if self.worker_type == "process":
            pool = self._ensure_process_pool()
            yield from batches(lambda chunk: pool.map(
                _process_fetch, [(self._token, int(i), seed, epoch) for i in chunk]))
        else:
            with ThreadPoolExecutor(self.num_workers) as pool:
                yield from batches(lambda chunk: pool.map(fetch, chunk))


class DevicePrefetcher:
    """Yields a loader's batches as torch tensors on ``device``, with the
    next batches' host-to-device copies running behind the current step.
    Counterpart of segtpu's ``DevicePrefetcher`` (``device_put`` there).

    A producer thread takes each batch from the loader; on a CUDA device it
    pins the arrays, copies them on a side ``torch.cuda.Stream`` and records
    an event. The consumer makes the current stream wait on that event and
    marks the tensors as used by it (``record_stream``), so the caching
    allocator does not hand their memory out while the step still reads it.
    At most ``depth`` batches wait in the queue. A loader's error is raised
    to the consumer. On the CPU the tensors are the loader's arrays."""

    def __init__(self, loader, device, depth: int = 2):
        import torch

        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import torch

        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        q: Queue = Queue(maxsize=self.depth)
        err: List[BaseException] = []
        stop = threading.Event()

        def produce():
            try:
                for batch in self.loader:
                    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
                    event = None
                    if cuda:
                        with torch.cuda.stream(side):
                            host = [t.pin_memory().to(self.device, non_blocking=True)
                                    for t in host]
                            event = torch.cuda.Event()
                            event.record(side)
                    q.put((host, event))
                    if stop.is_set():
                        break
            except BaseException as e:  # raised to the consumer
                err.append(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=produce, daemon=True,
                                  name="DevicePrefetcher")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if err:
                        raise err[0]
                    return
                tensors, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for t in tensors:
                        t.record_stream(current)
                yield tuple(tensors)
        finally:
            # the consumer left early: let the producer finish its batch
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.05)
                except Empty:
                    pass
