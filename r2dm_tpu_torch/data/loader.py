"""Batching loader on the host, preprocessing on the device.

The port of ``r2dm_tpu/data/loader.py`` (reference train.py:165-183,
201-214):
- ``DataLoader``: an endless shuffled stream of raw NHWC float32 batches
  {sample_id, xyz, reflectance, depth, mask}, the permutation of epoch e
  drawn from ``np.random.default_rng((seed, e))`` as in the JAX package,
  each process taking its slice of every global batch, and a background
  thread that builds the next batches while the device trains;
- ``preprocess_batch``: depth conversion -> channel concat -> [-1, 1] ->
  nearest-exact resize, torch ops on whatever device the batch is on.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..lidar import LiDARUtility
from ..utils import trace
from .datasets import RangeImageDataset


def nearest_exact_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) nearest-exact resize (torch's "nearest-exact": source
    index floor((i + 0.5) * in / out))."""
    B, H, W, C = x.shape
    out_h, out_w = size
    if (H, W) == (out_h, out_w):
        return x
    rows = torch.clamp(torch.floor((torch.arange(out_h, device=x.device) + 0.5) * H / out_h), 0, H - 1).long()
    cols = torch.clamp(torch.floor((torch.arange(out_w, device=x.device) + 0.5) * W / out_w), 0, W - 1).long()
    return x[:, rows][:, :, cols]


def preprocess_batch(
    lidar_utils: LiDARUtility,
    batch: dict,
    resolution: tuple[int, int],
    train_depth: bool = True,
    train_reflectance: bool = True,
) -> torch.Tensor:
    """Raw NHWC planes -> the normalised training tensor in [-1, 1]
    (reference preprocess, train.py:201-214)."""
    parts = []
    if train_depth:
        parts.append(lidar_utils.convert_depth(batch["depth"]))
    if train_reflectance:
        parts.append(batch["reflectance"])
    x = lidar_utils.normalize(torch.cat(parts, dim=-1))
    return nearest_exact_resize(x, tuple(resolution))


class DataLoader:
    """Shuffling, endlessly repeating batch iterator with thread prefetch.

    ``process_index``/``process_count`` shard rows across processes (the
    reference's accelerate ``split_batches=True``, train.py:52): every
    process sees the same global shuffle and takes its own slice of each
    global batch."""

    def __init__(
        self,
        dataset: RangeImageDataset,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
    ):
        if batch_size % process_count:
            raise ValueError(f"batch size {batch_size} is not a multiple of {process_count} processes")
        if len(dataset) < batch_size:
            raise ValueError(
                f"dataset has {len(dataset)} scans but the global batch size "
                f"is {batch_size}; the loader would never yield a batch"
            )
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.seed = seed
        self.shuffle = shuffle
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch

    def _index_stream(self) -> Iterator[np.ndarray]:
        epoch = 0
        n = len(self.dataset)
        while True:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            for i in range(0, n - self.global_batch + 1, self.global_batch):
                global_ids = order[i:i + self.global_batch]
                lo = self.process_index * self.local_batch
                yield global_ids[lo:lo + self.local_batch]
            epoch += 1

    def _make_batch(self, ids: np.ndarray) -> dict:
        planes = np.stack([self.dataset.planes(int(i)) for i in ids])  # (B, H, W, 6)
        return {
            "sample_id": ids.astype(np.int32),
            "xyz": planes[..., 0:3],
            "reflectance": planes[..., 3:4],
            "depth": planes[..., 4:5],
            "mask": planes[..., 5:6],
        }

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for ids in self._index_stream():
                    with trace.span("data.make_batch"):
                        batch = self._make_batch(ids)
                    if not put(batch):
                        return
            except Exception as exc:  # handed to the consumer, which raises it
                put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                if trace.on():
                    trace.count("data.gets")
                    trace.count("data.gets_empty", q.empty())
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
