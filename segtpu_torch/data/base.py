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
    as segtpu does.

    Sharding, segtpu's across hosts and the port's within a node:

    * ``num_shards``/``shard_index`` are segtpu's: each node (a segtpu
      host) takes ``order[shard_index::num_shards]`` of every epoch's order.
      Train runs ``floor(n / num_shards) // batch_size`` batches on every
      node (lockstep; up to ``num_shards - 1`` trailing samples are not
      visited); val pads the global order with sentinel slots to a multiple
      of ``num_shards``, so that every sample is visited exactly once.
    * within a node, ``batch_size`` is split over the node's ranks in order
      (``core/mesh.py``'s ``local_rows``): rank l of L takes rows
      ``[l*b/L, (l+1)*b/L)`` of each node batch, and fetches only those. A
      batch that does not split raises.

    Under a process group, at the first ``len()`` or iteration, the node's
    ranks come from the group (``LOCAL_WORLD_SIZE`` ranks a node) and, left
    unset, so do ``num_shards``/``shard_index`` (one shard a node); outside
    one the loader is unsharded. A sharded loader needs a static
    ``crop_size``: every rank must yield one shape each step. So a config's
    ``batch_size`` is the node's, and the same config trains the same global
    batch on 1 or N devices of a node."""

    def __init__(self, dataset: BaseDataset, batch_size: int, shuffle: bool,
                 num_workers: int = 4, val_split: float = 0.0,
                 drop_last: Optional[bool] = None, seed: int = 0,
                 indices: Optional[Sequence[int]] = None,
                 worker_type: str = "thread",
                 num_shards: Optional[int] = None,
                 shard_index: Optional[int] = None):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type {worker_type!r}: thread or process")
        if num_shards is None and shard_index is not None:
            raise ValueError("shard_index requires num_shards")
        self._shard_args = (num_shards, shard_index)
        self._shards = None  # (num_shards, shard_index, local rows), resolved once
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
                          worker_type=self.worker_type, seed=self.seed,
                          num_shards=self._shard_args[0],
                          shard_index=self._shard_args[1])

    def shards(self) -> Tuple[int, int, Tuple[int, int]]:
        """``(num_shards, shard_index, (lo, hi))``: this rank's node shard
        and its rows of each node batch; resolved once."""
        if self._shards is not None:
            return self._shards
        from segtpu_torch.core import mesh

        num_shards, shard_index = self._shard_args
        if num_shards is None:
            nodes = mesh.world_size() // mesh.local_world_size()
            num_shards, shard_index = nodes, mesh.rank() // mesh.local_world_size()
        shard_index = shard_index or 0
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} of {num_shards} shards")
        rows = mesh.local_rows(self.batch_size)
        if (num_shards > 1 or rows != (0, self.batch_size)) and not self.dataset.crop_size:
            raise ValueError(
                "a sharded loader needs a static crop_size on the dataset (got "
                f"crop_size={self.dataset.crop_size!r}): every rank must yield "
                "one shape each step")
        self._shards = (num_shards, shard_index, rows)
        return self._shards

    def __len__(self):
        num_shards = self.shards()[0]
        if self.drop_last:
            return (len(self.indices) // num_shards) // self.batch_size
        per_shard = -(-len(self.indices) // num_shards)
        return -(-per_shard // self.batch_size)

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

    def batch_indices(self, epoch: int) -> List[np.ndarray]:
        """This rank's sample indices in each batch of training epoch
        ``epoch + 1``'s order (-1 marks a padded slot)."""
        num_shards, shard_index, (lo, hi) = self.shards()
        order = self.indices.copy()
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        if num_shards > 1:
            if not self.drop_last:
                pad = (-len(order)) % num_shards
                order = np.concatenate([order, np.full(pad, -1, order.dtype)])
            order = order[shard_index::num_shards]
        bs = self.batch_size
        out = []
        for b in range(len(self)):
            chunk = order[b * bs:(b + 1) * bs]
            chunk = np.concatenate([chunk, np.full(bs - len(chunk), -1, order.dtype)])
            out.append(chunk[lo:hi])
        return out

    def _pad_batch(self, rows: int):
        """An all-padding batch: zero images, ignore-labeled (-100)."""
        ds = self.dataset
        crop = ds.crop_size
        dtype = np.uint8 if ds.device_normalize else np.float32
        return (np.zeros((rows, crop, crop, len(ds.mean)), dtype),
                np.full((rows, crop, crop), -100, np.int32))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        chunks = self.batch_indices(self._epoch)
        self._epoch += 1
        epoch, seed = self._epoch, self.seed
        skip, self._skip_next = self._skip_next, 0

        def fetch(idx):
            return self.dataset.get(int(idx), rng=_sample_rng(seed, epoch, int(idx)))

        def batches(mapper):
            for chunk in chunks[skip:]:
                real = chunk[chunk >= 0]
                if len(real) == 0:
                    yield self._pad_batch(len(chunk))
                    continue
                samples = list(mapper(real))
                images = np.stack([s[0] for s in samples])
                labels = np.stack([s[1] for s in samples])
                if len(samples) < len(chunk):  # pad the ragged val tail
                    pad = len(chunk) - len(samples)
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
    to the consumer. On the CPU the tensors are the loader's arrays. With
    ``rows`` (a ``core/spatial.py`` layout, under spatial sharding) each
    batch keeps this rank's band of rows before it leaves the host. While
    ``torch.profiler`` records, each take from the queue (the end's
    included) is the port's span ``segtpu_torch.data.wait``
    (``tracing.py``): the time the consumer waited for the loader."""

    def __init__(self, loader, device, depth: int = 2, rows=None):
        import torch

        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.rows = rows

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import torch

        from segtpu_torch.tracing import span

        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        q: Queue = Queue(maxsize=self.depth)
        err: List[BaseException] = []
        stop = threading.Event()

        def produce():
            try:
                if cuda and self.device.index is not None:
                    torch.cuda.set_device(self.device)  # this thread's: the rank's
                for batch in self.loader:
                    if self.rows is not None:
                        from segtpu_torch.core.spatial import keep_rows

                        batch = [keep_rows(a, self.rows) for a in batch]
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
                with span("segtpu_torch.data.wait"):
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
