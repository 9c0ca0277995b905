"""Data: the range-image projection (C++ core and numpy), the KITTI split
tables, the datasets and the batching loader (the port of ``r2dm_tpu/data``)."""

from .datasets import KITTI360, KITTIRaw, RangeImageDataset, SyntheticLiDAR, make_dataset
from .loader import DataLoader, nearest_exact_resize, preprocess_batch

__all__ = ["DataLoader", "KITTI360", "KITTIRaw", "RangeImageDataset", "SyntheticLiDAR", "make_dataset",
           "nearest_exact_resize", "preprocess_batch"]
