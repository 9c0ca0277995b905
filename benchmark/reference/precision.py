"""The lower precision of the correctness check's control.

``q8(x, "fp8")`` rounds x to float8 e4m3 under one per-tensor scale (the
tensor's absolute maximum mapped to the format's largest finite value, 448)
and returns it in x's dtype; the gradient passes straight through. With
``quant=None`` it returns x as it is.
"""

from __future__ import annotations

from typing import Optional

import torch

E4M3_MAX = 448.0


def q8(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown control precision {quant!r}")
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x.detach())
