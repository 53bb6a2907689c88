"""Ray-shard dataset and infinite prefetching loader, after
`efficient_nerf_tpu.data.rays_dataset` (:25-153).

The student's training corpus is a directory of .npy shards, each [4096,
9+] rows of [rays_o, rays_d, rgb(, depth|surface)]; files named train_*.npy
are converted REAL data, every other file is teacher-made PSEUDO data. The
same `np.random.Generator` picks the same files and shard order as the JAX
package.

The loader assembles the next batches on background threads (with the
native reader, native.py, or numpy) while the card trains on the current
one, and yields numpy arrays; the caller moves them to the card with
`device.to_device` (pinned memory, a non-blocking copy). Unlike the JAX
loader, `use_native=True` raises when the native reader cannot be built or
loaded, and a worker's error is raised by the next `next()` rather than
leaving it waiting.

Spans (`utils.profiling.span`): data.loader_next around the consumer's
`next()`, data.shard_read around a worker's read of one batch. Both carry
the batch's sequence number into the span log, where the workers' reads
land (the profiler does not see the loader's threads).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils.profiling import span
from .native import NativeShardReader

__all__ = ["RayShardDataset", "ShardLoader", "infinite_indices"]


class RayShardDataset:
    """File-list resolution with pseudo/real mixing.

    pseudo_ratio: -1 -> every shard; otherwise pseudo shards are picked
    (with replacement) so that pseudo/(pseudo+original) ~= pseudo_ratio, as
    the reference samples. hold_ratio holds a fraction out entirely.
    """

    def __init__(self, datadir: str, dim_dir: int = 3, dim_rgb: int = 3,
                 pseudo_ratio: float = -1.0, hold_ratio: float = 0.0,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        names = [x for x in os.listdir(datadir) if x.endswith(".npy")]
        pseudo = [os.path.join(datadir, x) for x in names
                  if not x.startswith("train_")]
        original = [os.path.join(datadir, x) for x in names
                    if x.startswith("train_")]

        if not (0 <= pseudo_ratio <= 1 or pseudo_ratio == -1):
            raise ValueError("pseudo_ratio must be in [0,1] or -1")
        if pseudo_ratio == -1:
            files = pseudo + original
        else:
            num_pseudo = int(len(original) / (1.0 - pseudo_ratio)) - len(original)
            files = list(rng.choice(pseudo, num_pseudo)) + original

        if not 0 <= hold_ratio < 1:
            raise ValueError("hold_ratio must be in [0,1)")
        if hold_ratio > 0:
            keep = int(len(files) * (1 - hold_ratio))
            files = list(rng.choice(files, keep, replace=False))

        self.files: List[str] = [str(f) for f in files]
        self.n_pseudo = len(pseudo)
        self.n_original = len(original)
        self.dim_dir = dim_dir
        self.dim_rgb = dim_rgb

    def __len__(self) -> int:
        return len(self.files)

    def load(self, index: int) -> np.ndarray:
        return np.load(self.files[index])

    def split_columns(self, d: np.ndarray):
        dd, dr = self.dim_dir, self.dim_rgb
        return d[..., :3], d[..., 3:3 + dd], d[..., 3 + dd:3 + dd + dr]


def infinite_indices(n: int, rng: np.random.Generator) -> Iterator[int]:
    """Endless stream of shuffled indices (reference InfiniteSampler,
    main.py:759-783): reshuffled after each full pass."""
    while True:
        for i in rng.permutation(n):
            yield int(i)


class ShardLoader:
    """Infinite batches of shards, assembled off-thread.

    Yields (rays_o, rays_d, target): [shards_per_batch*4096, 3 / dim_dir /
    dim_rgb] float32 numpy arrays. close() stops the threads and frees the
    native reader.
    """

    def __init__(self, dataset: RayShardDataset, shards_per_batch: int,
                 rng: Optional[np.random.Generator] = None,
                 prefetch: int = 2, num_threads: int = 2,
                 use_native: bool = True):
        self.ds = dataset
        self.k = shards_per_batch
        self.rng = rng or np.random.default_rng()
        self._indices = infinite_indices(len(dataset), self.rng)
        self._native = None
        if use_native and len(dataset):
            probe = dataset.load(0)
            self._native = NativeShardReader(dataset.files, rows=probe.shape[0],
                                             cols=probe.shape[-1])
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._seq = 0       # the next batch's sequence number, under _lock
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, num_threads))]
        for t in self._threads:
            t.start()

    def _next_batch_indices(self) -> Tuple[int, List[int]]:
        """The next batch's sequence number and shard indices."""
        with self._lock:
            seq, self._seq = self._seq, self._seq + 1
            return seq, [next(self._indices) for _ in range(self.k)]

    def load_batch(self, idxs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The batch of these shard indices, as a worker assembles it."""
        if self._native is not None:
            d = self._native.load_batch(idxs)
        else:
            d = np.concatenate([self.ds.load(i) for i in idxs], 0).astype(np.float32)
        o, dirs, tgt = self.ds.split_columns(d)
        return (np.ascontiguousarray(o), np.ascontiguousarray(dirs),
                np.ascontiguousarray(tgt))

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _worker(self):
        while not self._stop.is_set():
            try:
                seq, idxs = self._next_batch_indices()
                with span("data.shard_read", seq):
                    batch = self.load_batch(idxs)
            except Exception as e:  # handed to the consumer, which raises it
                self._put(e)
                return
            self._put((seq, batch))

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        with span("data.loader_next") as s:
            item = self._q.get()
            if isinstance(item, Exception):
                raise RuntimeError("a shard loader worker failed") from item
            seq, batch = item
            if s is not None:
                s.seq = seq
        return batch

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:   # each sees the flag within a put's timeout
            t.join()
        if self._native is not None:
            self._native.close()
            self._native = None
