"""Hub-style entry points of the port: the surface of the repo's
``hubconf.py`` (reference hubconf.py:21-104), as plain callables.

    from r2dm_tpu_torch.hub import pretrained_r2dm
    ddpm, lidar_utils, cfg = pretrained_r2dm("r2dm-h-kitti360-300k", ckpt_path="weights.pth")
    x = ddpm.sample(batch_size=1, num_steps=256)          # (1, 2, 64, 1024)

Each returns the port's module on ``device`` (``cuda`` unless the caller
asks for the CPU).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

from .inference import pretrained_r2dm, setup_model  # noqa: F401
from .metrics.extractor.postprocess import CRFRNN, knn_filter
from .metrics.extractor.rangenet import rangenet21, rangenet53  # noqa: F401


def rangenet(weights_tar: Optional[str] = None, backbone: int = 53, **kwargs):
    """(RangeNet-53 or -21, its preprocess), the reference ``rangenet`` alias
    (hubconf.py:45-60)."""
    return (rangenet53 if backbone == 53 else rangenet21)(weights_tar, **kwargs)


def knn(num_classes: int, **kwargs):
    """The kNN post-processor with ``num_classes`` bound (reference
    hubconf.py:615-618)."""
    return partial(knn_filter, num_classes=num_classes, **kwargs)


def crf_rnn(num_classes: int, device="cuda", **kwargs) -> CRFRNN:
    """The CRF-RNN post-processor (reference hubconf.py:621-624)."""
    return CRFRNN(num_classes=num_classes, device=device, **kwargs)
