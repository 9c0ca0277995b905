"""PointNet feature extractor (FPD features).

The port of ``r2dm_tpu/metrics/extractor/pointnet.py`` (reference
``metrics/extractor/pointnet.py:7-98``): the STN3d input transform, the
PointNet trunk, and the 1808-d feature, the concat of (global 1024, fc1 512,
fc2 256, logits 16). Modules carry the SpareNet names (``feat.stn.conv1``
(64, 3, 1), ..., ``bn1``..``bn5``, ``fc1``..``fc3``), so a
``cls_model_39.pth`` loads with ``load_state_dict``. BatchNorms are frozen
(inference statistics) and applied in place, so a per-point layer keeps one
(B, 1024, N) map alive, not two.

Input layout: (B, 3, N) points, as the reference takes them (the JAX package
takes (B, N, 3)).
"""

from __future__ import annotations

import torch
from torch import nn

from .rangenet import FrozenBatchNorm


class STN3d(nn.Module):
    """Input-transform net -> (B, 3, 3) (reference pointnet.py:7-34)."""

    def __init__(self):
        super().__init__()
        self.conv1, self.conv2, self.conv3 = nn.Conv1d(3, 64, 1), nn.Conv1d(64, 128, 1), nn.Conv1d(128, 1024, 1)
        self.fc1, self.fc2, self.fc3 = nn.Linear(1024, 512), nn.Linear(512, 256), nn.Linear(256, 9)
        self.bn1, self.bn2, self.bn3 = FrozenBatchNorm(64), FrozenBatchNorm(128), FrozenBatchNorm(1024)
        self.bn4, self.bn5 = FrozenBatchNorm(512), FrozenBatchNorm(256)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu_(self.bn1(self.conv1(x)))
        h = torch.relu_(self.bn2(self.conv2(h)))
        h = torch.relu_(self.bn3(self.conv3(h))).amax(dim=2)  # (B, 1024)
        h = torch.relu_(self.bn4(self.fc1(h)))
        h = torch.relu_(self.bn5(self.fc2(h)))
        h = self.fc3(h)
        return h.reshape(-1, 3, 3) + torch.eye(3, dtype=h.dtype, device=h.device)


class PointNetFeat(nn.Module):
    """The global-feature trunk (reference pointnet.py:37-63)."""

    def __init__(self):
        super().__init__()
        self.stn = STN3d()
        self.conv1, self.conv2, self.conv3 = nn.Conv1d(3, 64, 1), nn.Conv1d(64, 128, 1), nn.Conv1d(128, 1024, 1)
        self.bn1, self.bn2, self.bn3 = FrozenBatchNorm(64), FrozenBatchNorm(128), FrozenBatchNorm(1024)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trans = self.stn(x)
        x = torch.bmm(trans.transpose(1, 2), x)  # each point p -> p @ trans
        h = torch.relu_(self.bn1(self.conv1(x)))
        h = torch.relu_(self.bn2(self.conv2(h)))
        return self.bn3(self.conv3(h)).amax(dim=2)  # (B, 1024)


class PointNet1(nn.Module):
    """The classifier; forward returns the 1024 + 512 + 256 + k feature
    (reference pointnet.py:66-80)."""

    def __init__(self, k: int = 16):
        super().__init__()
        self.feat = PointNetFeat()
        self.fc1, self.fc2, self.fc3 = nn.Linear(1024, 512), nn.Linear(512, 256), nn.Linear(256, k)
        self.bn1, self.bn2 = FrozenBatchNorm(512), FrozenBatchNorm(256)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.feat(x)
        x2 = torch.relu_(self.bn1(self.fc1(x1)))
        x3 = torch.relu_(self.bn2(self.fc2(x2)))
        x4 = self.fc3(x3)
        return torch.cat([x1, x2, x3, x4], dim=1)


def pretrained_pointnet(ckpt_path: str, device="cuda") -> PointNet1:
    """PointNet1 (k = 16) with a local copy of the reference's pretrained
    ShapeNet classifier, SpareNet's ``cls_model_39.pth`` (reference
    pointnet.py:83-98); BatchNorm's ``num_batches_tracked`` is dropped."""
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = {k: v.float() for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    model = PointNet1(k=16)
    model.load_state_dict(sd)
    return model.to(device).eval()
