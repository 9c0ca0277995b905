"""Feature-distribution metrics: Fréchet distance + kernel MMD, numpy on
the host.

The port of ``r2dm_tpu/metrics/distribution.py`` (reference
``metrics/distribution.py:5-27``). ``compute_squared_mmd`` is a copy and
takes an optional seed (the reference consumes global np.random state).

``compute_frechet_distance`` needs only the trace of sqrtm(S1 S2), where the
JAX package takes scipy's ``sqrtm`` of the product (the FID convention).
For covariances S1, S2 that trace is the sum of the square roots of the
eigenvalues of S1^(1/2) S2 S1^(1/2), a symmetric PSD matrix, so two
``eigh`` calls give it. On the host CPU of an NVIDIA H100 machine scipy's
``sqrtm`` of the 4096^2 FRD product took 303-330 s (PERF.md); the eigen
form takes about 11 s there, agrees with ``sqrtm`` to 1e-14 relative where
the covariances have full rank, and stays finite where a set smaller than
the feature width makes them singular, where ``sqrtm`` can return NaN.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def compute_frechet_distance(feats1: np.ndarray, feats2: np.ndarray) -> float:
    """FID-style 2-Wasserstein^2 between Gaussian fits (reference :5-13):
    |mu1 - mu2|^2 + tr(S1 + S2) - 2 tr sqrtm(S1 S2)."""
    mu1, sigma1 = np.mean(feats1, axis=0), np.cov(feats1, rowvar=False)
    mu2, sigma2 = np.mean(feats2, axis=0), np.cov(feats2, rowvar=False)
    m = np.square(mu1 - mu2).sum()
    w, v = np.linalg.eigh(sigma1)
    root1 = (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T
    lam = np.linalg.eigvalsh(root1 @ sigma2 @ root1)
    tr_sqrt = np.sqrt(np.clip(lam, 0.0, None)).sum()
    return float(m + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)


def compute_squared_mmd(
    feats1: np.ndarray,
    feats2: np.ndarray,
    num_subsets: int = 100,
    max_subset_size: int = 1000,
    seed: Optional[int] = None,
) -> float:
    """Polynomial-kernel ((x.y/n + 1)^3) MMD^2 over random subsets
    (reference :16-27)."""
    rng = np.random.default_rng(seed) if seed is not None else np.random
    n = feats1.shape[1]
    m = min(min(feats1.shape[0], feats2.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = feats2[rng.choice(feats2.shape[0], m, replace=False)]
        y = feats1[rng.choice(feats1.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)
