"""Label post-processors: RangeNet++ kNN refinement and CRF-RNN mean field,
in NCHW torch ops.

The port of ``r2dm_tpu/metrics/extractor/postprocess.py`` (reference
metrics/extractor/rangenet.py:185-263 kNN, :266-405 CRFRNN): neighbourhoods
are zero-padded ``F.unfold`` windows in row-major offset order, the distance
smoothing and the message passing are ``F.conv2d``, the majority vote a
one-hot sum.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(kernel_size: tuple[int, int], sigma: float) -> np.ndarray:
    kh, kw = kernel_size
    hh, ww = np.meshgrid(np.arange(kh) - kh // 2, np.arange(kw) - kw // 2, indexing="ij")
    k = np.exp(-(hh**2 + ww**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _unfold(x: torch.Tensor, kernel_size: tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, K, H, W): the zero-padded neighbourhood of
    each pixel, offsets in row-major order."""
    B, C, H, W = x.shape
    kh, kw = kernel_size
    cols = F.unfold(x, kernel_size, padding=(kh // 2, kw // 2))
    return cols.view(B, C, kh * kw, H, W)


def knn_filter(
    depth: torch.Tensor,
    label: torch.Tensor,
    num_classes: int,
    k: int = 3,
    kernel_size: tuple[int, int] = (3, 3),
    sigma: float = 1.0,
    cutoff: float = 1.0,
) -> torch.Tensor:
    """kNN label refinement (reference rangenet.py:197-263). depth (B, 1,
    H, W), invalid pixels < 0; label (B, H, W) int -> refined (B, H, W)."""
    kh, kw = kernel_size
    K = kh * kw
    neighbors = _unfold(depth, kernel_size)[:, 0]  # (B, K, H, W)
    neighbors = torch.where(neighbors < 0, torch.inf, neighbors)
    jump = (neighbors - depth).abs()
    # penalise far pixels: each slot smoothed with the inverse gaussian
    inv_g = torch.from_numpy(1.0 - _gaussian_kernel(kernel_size, sigma)).to(depth)
    dist = F.conv2d(jump, inv_g.expand(K, 1, kh, kw), padding=(kh // 2, kw // 2), groups=K)
    neg_top, ids = torch.topk(-dist, k, dim=1)  # the k smallest distances
    label_nb = _unfold(label[:, None].to(depth.dtype), kernel_size)[:, 0]
    label_topk = torch.gather(label_nb, 1, ids)
    if cutoff > 0:
        label_topk = torch.where(-neg_top > cutoff, float(num_classes), label_topk)
    # majority vote without the overflow bin (reference :258-261)
    votes = F.one_hot(label_topk.long(), num_classes + 1).sum(dim=1)  # (B, H, W, num_classes + 1)
    return votes[..., :num_classes].argmax(dim=-1)


class CRFRNN:
    """Mean-field CRF-RNN (reference rangenet.py:266-405), inference only:
    fixed smoothness kernels, the reference's initial per-class weights and
    the Potts compatibility. NCHW."""

    def __init__(
        self,
        num_classes: int,
        kernel_size: tuple[int, int] = (3, 5),
        init_weight_smoothness: float = 0.02,
        init_weight_appearance: float = 0.1,
        theta_gamma: float | Sequence[float] = 0.9,
        theta_alpha: float | Sequence[float] = 0.9,
        theta_beta: float | Sequence[float] = 0.015,
        num_iters: int = 3,
        device=None,
    ):
        C = num_classes
        self.num_classes = C
        self.kernel_size = kernel_size
        self.num_iters = num_iters

        def per_class(v):
            return np.full(C, v, np.float32) if np.isscalar(v) else np.asarray(v, np.float32)

        self.theta_beta = torch.from_numpy(per_class(theta_beta)).to(device)
        self.kernel_gamma = self._smoothness_kernel(per_class(theta_gamma)).to(device)
        self.kernel_alpha = self._smoothness_kernel(per_class(theta_alpha)).to(device)
        self.weight_appearance = torch.full((C,), init_weight_appearance, device=device)
        self.weight_smoothness = torch.full((C,), init_weight_smoothness, device=device)
        # Potts model: weight[o, i] = [i != o], a 1x1 conv
        self.compat = torch.from_numpy(1.0 - np.eye(C, dtype=np.float32))[:, :, None, None].to(device)

    def _smoothness_kernel(self, theta: np.ndarray) -> torch.Tensor:
        """A gaussian with its centre zeroed for each class, on the diagonal
        of an OIHW (C, C, kh, kw) kernel (reference :313-331)."""
        kh, kw = self.kernel_size
        hh, ww = np.meshgrid(np.arange(kh) - kh // 2, np.arange(kw) - kw // 2, indexing="ij")
        kernel = np.zeros((self.num_classes, self.num_classes, kh, kw), np.float32)
        for c in range(self.num_classes):
            g = np.exp(-(hh**2 + ww**2) / (2 * theta[c] ** 2))
            g[kh // 2, kw // 2] = 0.0
            kernel[c, c] = g
        return torch.from_numpy(kernel)

    def _conv_same(self, Q: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        return F.conv2d(Q, kernel, padding=(kh // 2, kw // 2))

    def _unfold_wo_center(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, C, K - 1, H, W) without the kernel centre."""
        u = _unfold(x, self.kernel_size)
        K = u.shape[2]
        return torch.cat([u[:, :, : K // 2], u[:, :, K // 2 + 1:]], dim=2)

    def __call__(self, unary: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """unary (B, C, H, W), xyz (B, 3, H, W), mask (B, H, W) or (B, 1, H,
        W) -> refined logits (B, C, H, W)."""
        if mask.dim() == 3:
            mask = mask[:, None]
        # appearance kernel from xyz distances (reference :353-359)
        pdist = (self._unfold_wo_center(xyz) - xyz[:, :, None]).square().sum(dim=1, keepdim=True)
        kernel_beta = torch.exp(-pdist / (2.0 * self.theta_beta.square())[None, :, None, None, None])
        ws = self.weight_smoothness[None, :, None, None]
        wa = self.weight_appearance[None, :, None, None]
        Q = unary
        for _ in range(self.num_iters):
            Q = torch.softmax(Q, dim=1)
            k_smooth = self._conv_same(Q, self.kernel_gamma)
            exp_appearance = (self._unfold_wo_center(Q * mask) * kernel_beta).sum(dim=2) * mask
            k_appear = exp_appearance * self._conv_same(Q, self.kernel_alpha)
            Q = unary - F.conv2d(ws * k_smooth + wa * k_appear, self.compat)
        return Q
