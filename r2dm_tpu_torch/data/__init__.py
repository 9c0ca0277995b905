"""Data: the range-image projection, the datasets and the batching loader
(the port of ``r2dm_tpu/data``; KITTI-360 and KITTI Raw are not ported yet)."""

from .datasets import RangeImageDataset, SyntheticLiDAR, make_dataset
from .loader import DataLoader, preprocess_batch

__all__ = ["DataLoader", "RangeImageDataset", "SyntheticLiDAR", "make_dataset", "preprocess_batch"]
