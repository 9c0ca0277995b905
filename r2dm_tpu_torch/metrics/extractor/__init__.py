"""Feature extractors and label post-processors: RangeNet++ (FRD features,
semantic labels), PointNet (FPD features), kNN and CRF-RNN.

The JAX package computes them in float32. On a card cuDNN may run float32
convolutions in TF32, and FRD/FPD move with the features, so the callers
run the extractors under :func:`strict_fp32`, which turns TF32 off for the
extraction only and restores the previous setting after.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_fp32():
    """No TF32 in cuDNN convolutions or in matmuls inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
