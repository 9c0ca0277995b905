"""Card-only tests of the evaluation path: the extractors' features on the
card against the CPU's (strict fp32), the BEV counts on the card exact, and
``evaluate``'s chunked extraction equal to one batch.

They skip without a CUDA device. This file imports no JAX, so on a machine
with the card and without JAX it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_port_eval_cuda.py``.
"""

import argparse

import numpy as np
import pytest
import torch

from r2dm_tpu_torch import evaluate
from r2dm_tpu_torch.metrics import bev
from r2dm_tpu_torch.metrics.extractor import pointnet as pn
from r2dm_tpu_torch.metrics.extractor import rangenet as rn
from r2dm_tpu_torch.metrics.extractor import strict_fp32

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")


def _inputs(b: int, H: int = 16, W: int = 256):
    """(B, 5, H, W) [depth, x, y, z, reflectance] scans and their (B, 1, H,
    W) masks from a seed."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.0, 70.0, (b, 1, H, W)).astype(np.float32)
    az = np.linspace(-np.pi, np.pi, W, dtype=np.float32)[None, None, None]
    el = np.linspace(0.05, -0.4, H, dtype=np.float32)[None, None, :, None]
    xyz = np.concatenate([depth * np.cos(el) * np.cos(az), depth * np.cos(el) * np.sin(az), depth * np.sin(el)], 1)
    mask = evaluate.gated(depth)
    imgs = np.concatenate([depth, xyz, rng.uniform(0, 1, (b, 1, H, W)).astype(np.float32)], 1) * mask
    return imgs.astype(np.float32), mask


def _random(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


def test_features_on_the_card_match_the_cpu():
    """Relative L2 <= 1e-4 of RangeNet-21 lidargen features and PointNet
    features in strict fp32 (TF32 would move them by about 1e-3)."""
    _card()
    imgs, mask = _inputs(2)
    x, m = torch.from_numpy(imgs), torch.from_numpy(mask)
    clouds = (x[:, 1:4] * m).reshape(2, 3, -1) / evaluate.DATASET_MAX_DEPTH
    rnet, pnet = _random(rn.RangeNet(backbone=21), 0), _random(pn.PointNet1(), 1)
    with torch.inference_mode():
        cpu = rnet(rn.preprocess(x, m), "lidargen"), pnet(clouds)
    rnet.cuda(), pnet.cuda()
    with torch.inference_mode(), strict_fp32():
        card = rnet(rn.preprocess(x.cuda(), m.cuda()), "lidargen").cpu(), pnet(clouds.cuda()).cpu()
    for a, b in zip(card, cpu):
        assert float((a - b).norm() / b.norm()) <= 1e-4


def test_bev_counts_on_the_card_are_exact():
    _card()
    rng = np.random.default_rng(2)
    clouds = torch.from_numpy((rng.standard_normal((4, 20000, 3)) * 40).astype(np.float32))
    assert torch.equal(bev.point_cloud_to_histogram(clouds.cuda()).cpu(), bev.point_cloud_to_histogram(clouds))


def test_chunked_extraction_equals_one_batch(monkeypatch):
    """evaluate's extraction in chunks of 2 images against one batch of 6:
    relative 1e-5 (cuDNN may pick another algorithm at another batch)."""
    _card()
    imgs, mask = _inputs(6)
    extract = evaluate.build_extractors(
        argparse.Namespace(rangenet_tar=None, pointnet_ckpt=None, allow_random_extractors=True), "cuda")
    one = extract(imgs, mask)
    monkeypatch.setattr(evaluate, "MAX_EXTRACT_PIXELS", 2 * imgs.shape[2] * imgs.shape[3])
    chunked = extract(imgs, mask)
    for a, b in zip(chunked, one):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()))
