"""Batching data loaders with background prefetch threads, on the host
(port of unicorn_tpu/data/loader.py). Batches leave as numpy arrays in the
JAX package's layout; the trainer moves them to the card.

Randomness. Each loader owns its generators, seeded from `seed`: `_rng`
(random.Random(seed)) for the flips and sample indices, as JAX's loader
does, and `_py_rng` / `_np_rng` (random.Random(seed),
np.random.RandomState(seed)), which take the place of the process-global
`random` / `np.random` that JAX's datasets and transforms draw from. So a
loader seeded s draws what JAX's draws after `seed_everything(s)` with its
own seed s. `set_rank` reseeds all three.
"""
from __future__ import annotations

import queue
import random
import threading

import numpy as np


class _Prefetcher:
    """`workers` threads build batches with `_make_batch` into a queue of
    `max(prefetch, workers)`; iterating starts them. `set_rank` gives each
    rank of data parallelism a stream of its own (the reference's
    DistributedSampler role): without it every rank would draw the same
    images."""

    def _init_prefetch(self, prefetch: int, workers: int, seed: int):
        self.workers = max(1, int(workers))
        self._seed = seed
        self._rng = random.Random(seed)
        self._seed_generators(seed)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, self.workers))
        self._threads: list = []
        self._stop = threading.Event()

    def _seed_generators(self, seed: int):
        self._py_rng = random.Random(seed)
        self._np_rng = np.random.RandomState(seed % (2 ** 31))

    def set_rank(self, rank: int, world: int):
        base = self._seed + 7919 * rank
        self._seed_generators(base)
        self._rng = random.Random(base + 1)
        return self

    def _worker(self):
        # Build each batch once and retry the put with the same batch on
        # queue.Full: rebuilding on Full would discard batches whose
        # construction had side effects (sampler draws, task alternation).
        # A batch that fails to build goes into the queue as its exception,
        # which __next__ raises, and the thread ends.
        batch = None
        while not self._stop.is_set():
            if batch is None:
                try:
                    batch = self._make_batch()
                except Exception as e:
                    batch = e
            try:
                self._q.put(batch, timeout=1.0)
            except queue.Full:
                continue
            if isinstance(batch, Exception):
                return
            batch = None

    def start(self):
        if not self._threads:
            for _ in range(self.workers):
                t = threading.Thread(target=self._worker, daemon=True)
                t.start()
                self._threads.append(t)
        return self

    def stop(self):
        """Stop the threads: each ends after the batch it is building."""
        self._stop.set()

    def __iter__(self):
        self.start()
        return self

    def __next__(self):
        batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        return batch


class UniLoader(_Prefetcher):
    """Iterates (images (B, 2, H, W, 3) float32, targets (B, 2, M, 6),
    task_ids (B,) int32) from an OmniDatasetPlus through a two-frame
    transform.

    All samples of a batch share one task; `alter_every` flips the task
    every that many batches. workers > 1 runs that many threads (numpy
    releases the interpreter lock in its array work); sampling and the
    task flip stay under one lock, so every batch keeps one task, but the
    order of batches across workers is not fixed: keep workers=1 where
    batches must be reproducible."""

    def __init__(self, dataset, transform, batch_size: int, input_size,
                 alter_every: int = 1, prefetch: int = 2, seed: int = 0,
                 workers: int = 1):
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.input_size = tuple(input_size)
        self.alter_every = alter_every
        self._count = 0
        self._lock = threading.Lock()
        self._init_prefetch(prefetch, workers, seed)

    def _sample_batch(self):
        """Draw one batch's samples and flips under the lock, then load them
        outside it. Datasets without the sample_spec / load_spec split load
        under the lock."""
        split = hasattr(self.dataset, "sample_spec")
        with self._lock:
            if split:
                specs = [self.dataset.sample_spec(0, self._py_rng)
                         for _ in range(self.batch_size)]
            else:
                items = [self.dataset.pull_item(0)
                         for _ in range(self.batch_size)]
            flips = [self._rng.random() < 0.5 for _ in range(self.batch_size)]
            size = self.input_size
            self._count += 1
            if self.alter_every > 0 and self._count % self.alter_every == 0:
                self.dataset.alter_task()
        if split:
            items = [self.dataset.load_spec(s, self._py_rng) for s in specs]
        return items, flips, size

    def _transform(self, *args, **kwargs):
        return self.transform(*args, **kwargs, rng=self._py_rng,
                              np_rng=self._np_rng)

    def _make_batch(self):
        items, flips, size = self._sample_batch()
        imgs, tgts, tids = [], [], []
        for (frames, task), flip in zip(items, flips):
            pair = [self._transform(img, res, size, joint=True, flip=flip)
                    for img, res in frames]
            imgs.append(np.stack([p[0] for p in pair]))
            tgts.append(np.stack([p[1] for p in pair]))
            tids.append(task)
        return np.stack(imgs), np.stack(tgts), np.asarray(tids, np.int32)

    def set_input_size(self, size):
        """Multiscale training: batches sampled from now on letterbox to
        `size`."""
        self.input_size = tuple(size)


class UniMaskLoader(UniLoader):
    """Mask-stage batches: (images (B, 2, H, W, 3), targets (B, 2, M, 6),
    task_ids (B,), masks (B, 2, M, H / d, W / d)). Frames are (img, res,
    masks) through TrainTransformIns; in four-task training box-task frames
    are (img, res) through TrainTransform4Tasks, which returns masks None,
    and get zero masks so that the batch keeps its shape (the mask losses
    are gated on the task id)."""

    def _make_batch(self):
        items, flips, size = self._sample_batch()
        d = getattr(self.transform, "trans_inst", self.transform).d_rate
        imgs, tgts, tids, mks = [], [], [], []
        for (frames, task), flip in zip(items, flips):
            f_imgs, f_tgts, f_masks = [], [], []
            for data in frames:
                img, res, masks = data if len(data) == 3 else (*data, None)
                im_t, lab_t, m_t = self._transform(img, res, masks, size,
                                                   joint=True, flip=flip)
                if m_t is None:  # a box-task sample in a four-task batch
                    m_t = np.zeros((lab_t.shape[0], size[0] // d,
                                    size[1] // d), np.float32)
                f_imgs.append(im_t)
                f_tgts.append(lab_t)
                f_masks.append(m_t)
            imgs.append(np.stack(f_imgs))
            tgts.append(np.stack(f_tgts))
            mks.append(np.stack(f_masks))
            tids.append(task)
        return (np.stack(imgs), np.stack(tgts), np.asarray(tids, np.int32),
                np.stack(mks))


class InstLoader(_Prefetcher):
    """Instance-segmentation batches: (images (B, H, W, 3), labels (B, M,
    6), masks (B, M, H / d, W / d)) from a dataset exposing pull_item_omni
    (its first frame; its draws from `_py_rng`) through TrainTransformIns."""

    def __init__(self, dataset, transform, batch_size: int, input_size,
                 prefetch: int = 2, seed: int = 0, workers: int = 1):
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.input_size = tuple(input_size)
        self._lock = threading.Lock()
        self._init_prefetch(prefetch, workers, seed)

    def set_input_size(self, size):
        self.input_size = tuple(size)

    def _make_batch(self):
        with self._lock:
            idxs = [self._rng.randint(0, len(self.dataset) - 1)
                    for _ in range(self.batch_size)]
            size = self.input_size
        imgs, labs, mks = [], [], []
        for idx in idxs:
            img, res, masks = self.dataset.pull_item_omni(
                idx, 1, rng=self._py_rng)[0]
            im_t, lab_t, m_t = self.transform(img, res, masks, size,
                                              rng=self._py_rng,
                                              np_rng=self._np_rng)
            imgs.append(im_t)
            labs.append(lab_t)
            mks.append(m_t)
        return np.stack(imgs), np.stack(labs), np.stack(mks)


class DetLoader(_Prefetcher):
    """Detection batches: (images (B, H, W, 3) float32, labels (B, M, 5))
    from a dataset exposing `get_item(idx, rng=, np_rng=)` (MosaicDetection,
    COCODataset), in an epoch order shuffled by `_rng`. The images keep the
    dataset's size: there is no multiscale (`set_input_size`), as in the
    JAX package. `set_rank` also strides the epoch order `rank::world`.

    The batch's indices are taken under the lock, the items built outside
    it from the shared `_py_rng` / `_np_rng`, as InstLoader does: with one
    worker a loader seeded s gives the JAX loader's batches after
    `seed_everything(s)`; with more, the draws' order across threads is
    not fixed."""

    def __init__(self, dataset, batch_size: int, prefetch: int = 2,
                 seed: int = 0, shuffle: bool = True, workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._order = list(range(len(dataset)))
        self._pos = 0
        self._lock = threading.Lock()
        self._init_prefetch(prefetch, workers, seed)

    def set_rank(self, rank: int, world: int):
        super().set_rank(rank, world)
        self._order = list(range(len(self.dataset)))[rank::world]
        self._pos = 0
        return self

    def _next_index(self):
        if self._pos == 0 and self.shuffle:
            self._rng.shuffle(self._order)
        idx = self._order[self._pos]
        self._pos = (self._pos + 1) % len(self._order)
        return idx

    def _make_batch(self):
        with self._lock:
            idxs = [self._next_index() for _ in range(self.batch_size)]
        imgs, labels = [], []
        for idx in idxs:
            img, lab, _, _ = self.dataset.get_item(idx, rng=self._py_rng,
                                                   np_rng=self._np_rng)
            imgs.append(img)
            labels.append(lab)
        return np.stack(imgs), np.stack(labels)
