"""Ring (equirectangular-wrap) padding, NHWC.

The range image wraps horizontally (azimuth is periodic), so convolutions
pad W circularly and H with zeros (reference ``models/ops.py:32-49``, JAX
``r2dm_tpu/ops/pad.py``). This is the one place the port wraps W: under a
width axis (``width``, a ``World`` whose width group splits the columns) the
W margins come from the neighbouring ranks' columns
(``parallel/width.py::halo_exchange``), so every ring consumer computes on
its columns what one rank computes on the whole image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.width import pad_columns, sharded


def ring_pad(
    x: torch.Tensor,
    padding: int | tuple[int, int, int, int],
    ring: bool = True,
    width=None,
) -> torch.Tensor:
    """Pad (B, H, W, C): W circularly (zeros without ``ring``), H with zeros.

    ``padding`` is an int or (left, right, top, bottom), torch's F.pad order.
    ``width``: the ``World`` whose width group holds the other columns of
    the ring (None: x is the whole ring).
    """
    if isinstance(padding, int):
        left = right = top = bottom = padding
    else:
        left, right, top, bottom = padding
    if left or right:
        W = x.shape[2]
        if ring and sharded(width):
            x = pad_columns(x, left, right, width)
        elif ring:
            idx = torch.arange(-left, W + right, device=x.device) % W
            x = x.index_select(2, idx)
        else:
            x = F.pad(x, (0, 0, left, right))
    if top or bottom:
        x = F.pad(x, (0, 0, 0, 0, top, bottom))
    return x
