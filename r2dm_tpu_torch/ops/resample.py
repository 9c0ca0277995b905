"""FIR anti-aliased up/down-sampling of NHWC range images.

Same function as ``r2dm_tpu/ops/resample.py`` (reference ``Resample``,
``models/ops.py:52-146``): margin padding (circular on W when ``ring``),
zero-insertion upsampling, crop, depthwise FIR filter, stride-crop
downsampling.

Per axis (u = up, d = down, k = taps, m = margin) the reference crops the
zero-inserted, margin-padded signal to [m*u - p0, (H+m)*u + p1), applies a
valid k-tap filter and keeps every d-th sample. On the zero-inserted signal
of length (H+2m-1)*u + 1 that is a pad of
    lo = p0 - m*u,    hi = p1 + u - 1 - m*u
(negative = crop) before a stride-d filter; p0/p1 follow models/ops.py:98-109.
The two axes run as ONE depthwise conv with the outer-product kernel.
Under a width axis (``width``) the W margins come from the neighbouring
ranks' columns (``ring_pad``): the filter is shift-equivariant in W, so each
rank's output columns are those of the whole image's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .pad import ring_pad


def _axis_params(k: int, up: int, down: int) -> tuple[int, int]:
    """p0/p1 pad sizes per reference models/ops.py:98-109."""
    if up > 1:
        p0 = (k - up + 1) // 2 + up - 1
        p1 = (k - up) // 2
    else:
        p0 = (k - down + 1) // 2
        p1 = (k - down) // 2
    return p0, p1


def _dilate_pad(x: torch.Tensor, dim: int, up: int, lo: int, hi: int) -> torch.Tensor:
    """Zero-insert ``up - 1`` samples between neighbours along ``dim`` of an
    NCHW tensor, then pad (>= 0) or crop (< 0) ``lo``/``hi`` at the ends."""
    if up > 1:
        shape = list(x.shape)
        n = shape[dim]
        shape[dim] = (n - 1) * up + 1
        z = x.new_zeros(shape)
        index = [slice(None)] * x.dim()
        index[dim] = slice(None, None, up)
        z[tuple(index)] = x
        x = z
    n = x.shape[dim]
    x = x.narrow(dim, max(-lo, 0), n - max(-lo, 0) - max(-hi, 0))
    if lo > 0 or hi > 0:
        pad = [0, 0, 0, 0]
        at = 0 if dim == 3 else 2
        pad[at], pad[at + 1] = max(lo, 0), max(hi, 0)
        x = F.pad(x, pad)
    return x


def fir_kernel(
    up: int | tuple[int, int] = 1,
    window: tuple[float, ...] = (1.0, 3.0, 3.0, 1.0),
    normalize: bool = True,
    direction: str = "hw",
) -> torch.Tensor:
    """The (k_h, k_w) fp32 filter ``fir_resample`` applies: the outer product
    of the window over the resampled axes, scaled by sqrt(up_h * up_w) per
    application (models/ops.py:94)."""
    assert direction in ("h", "w", "hw")
    up = (up, up) if isinstance(up, int) else tuple(up)
    up_h = up[0] if "h" in direction else 1
    up_w = up[1] if "w" in direction else 1
    kernel = torch.tensor(window, dtype=torch.float32)
    if normalize:
        kernel = kernel / kernel.sum()
    kernel = kernel * (up_h * up_w) ** 0.5
    ones = torch.ones(1, dtype=torch.float32)
    return torch.outer(kernel if "h" in direction else ones, kernel if "w" in direction else ones)


def fir_resample(
    x: torch.Tensor,
    up: int | tuple[int, int] = 1,
    down: int | tuple[int, int] = 1,
    window: tuple[float, ...] = (1.0, 3.0, 3.0, 1.0),
    ring: bool = True,
    normalize: bool = True,
    direction: str = "hw",
    kernel: torch.Tensor | None = None,
    width=None,
) -> torch.Tensor:
    """Anti-aliased resample of (B, H, W, C) by ``up``/``down`` per axis.
    ``kernel`` is ``fir_kernel(up, window, normalize, direction)``, passed in
    where it already lies on x's device; ``width`` as in ``ring_pad``."""
    assert direction in ("h", "w", "hw")
    up = (up, up) if isinstance(up, int) else tuple(up)
    down = (down, down) if isinstance(down, int) else tuple(down)
    n_taps = len(window)
    k_h, up_h, down_h = (n_taps, up[0], down[0]) if "h" in direction else (1, 1, 1)
    k_w, up_w, down_w = (n_taps, up[1], down[1]) if "w" in direction else (1, 1, 1)
    if kernel is None:
        kernel = fir_kernel(up, window, normalize, direction)

    ph0, ph1 = _axis_params(k_h, up_h, down_h)
    pw0, pw1 = _axis_params(k_w, up_w, down_w)
    margin = max(ph0, ph1, pw0, pw1)
    x = ring_pad(x, (margin, margin, margin, margin), ring=ring, width=width)

    C = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    xc = _dilate_pad(xc, 2, up_h, ph0 - margin * up_h, ph1 + up_h - 1 - margin * up_h)
    xc = _dilate_pad(xc, 3, up_w, pw0 - margin * up_w, pw1 + up_w - 1 - margin * up_w)
    weight = kernel.to(device=x.device, dtype=x.dtype).expand(C, 1, k_h, k_w)
    y = F.conv2d(xc, weight, stride=(down_h, down_w), groups=C)
    return y.permute(0, 2, 3, 1).contiguous()


def upsample2x(x: torch.Tensor, kernel: torch.Tensor | None = None, width=None) -> torch.Tensor:
    """2x FIR upsample, both axes (reference Resample(up=2)); ``kernel`` is
    ``fir_kernel(up=2)``."""
    return fir_resample(x, up=2, kernel=kernel, width=width)


def downsample2x(x: torch.Tensor, kernel: torch.Tensor | None = None, width=None) -> torch.Tensor:
    """2x anti-aliased downsample, both axes (reference Resample(down=2));
    ``kernel`` is ``fir_kernel()``."""
    return fir_resample(x, down=2, kernel=kernel, width=width)
