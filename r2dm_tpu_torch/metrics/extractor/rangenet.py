"""RangeNet++ (Darknet-21/53) segmenter and FRD feature extractor, NCHW.

The port of ``r2dm_tpu/metrics/extractor/rangenet.py`` (reference
``metrics/extractor/rangenet.py:28-177``): a 5-level Darknet encoder with
W-only stride-2 convs, a transposed-conv decoder with skip adds, and the
"lidargen" features that define FRD, the decoder's feature map flattened in
NCHW order and subsampled at 4096 fixed indices. Every BatchNorm is frozen
(inference statistics). Modules carry the reference torch names
(``0.weight``, ``1.running_mean``, ``conv.0.weight``,
``residual_blocks.{j}.residual.{0,1}.{0,1}.*``) under ``stem``,
``enc1..5``, ``dec5..1`` and ``head``.

Weights: the official bonnetal ``darknet53.tar.gz`` (reference
rangenet.py:532-545) read by :func:`load_rangenet_tar` from a local file.
Its ``arch_cfg.yaml`` is read by a small reader of the keys it needs, so
PyYAML is not required.
"""

from __future__ import annotations

import io
import os
import random
import tarfile
from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...utils.weights import bonnetal_from_rangenet_state_dict, rangenet_state_dict_from_bonnetal

NUM_RESBLOCKS = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}
NUM_FEATURES = 4096  # lidargen feature width (reference rangenet.py:150-155)
# SemanticKITTI input statistics, channel order (range, x, y, z, remission)
IMG_MEANS = (12.12, 10.88, 0.23, -1.04, 0.21)
IMG_STDS = (12.32, 11.47, 6.91, 0.86, 0.16)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics over dim 1 of (B, C, ...): (x - mean)
    / sqrt(var + eps) * weight + bias, applied in place (its input is always
    the fresh output of the layer before it)."""

    eps = 1e-5  # torch.nn.BatchNorm's, as the JAX package's

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        view = (-1,) + (1,) * (x.dim() - 2)
        return x.mul_(scale.view(view)).add_(shift.view(view))


def conv_bn_lrelu(cin: int, cout: int, kernel=(3, 3), stride=(1, 1), padding=(1, 1)) -> nn.Sequential:
    """conv -> BN -> LeakyReLU(0.1) (reference rangenet.py:31-48)."""
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, stride, padding, bias=False), FrozenBatchNorm(cout),
                         nn.LeakyReLU(0.1, inplace=True))


class Residual(nn.Module):
    """h + conv3x3(conv1x1(h)) (reference rangenet.py:51-60)."""

    def __init__(self, mid: int, out: int):
        super().__init__()
        self.residual = nn.Sequential(conv_bn_lrelu(out, mid, (1, 1), (1, 1), (0, 0)), conv_bn_lrelu(mid, out))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h + self.residual(h)


class Block(nn.Module):
    """A down (stride 2 in W), up (ConvTranspose2d k=(1,4), s=(1,2),
    p=(0,1): W doubles) or same conv, then a stack of residuals (reference
    rangenet.py:63-104)."""

    def __init__(self, in_ch: int, out_ch: int, num_blocks: int, mode: str = "same"):
        super().__init__()
        if mode == "up":
            self.conv = nn.Sequential(nn.ConvTranspose2d(in_ch, out_ch, (1, 4), (1, 2), (0, 1)),
                                      FrozenBatchNorm(out_ch), nn.LeakyReLU(0.1, inplace=True))
        elif mode == "down":
            self.conv = conv_bn_lrelu(in_ch, out_ch, (3, 3), (1, 2), (1, 1))
        else:
            self.conv = conv_bn_lrelu(in_ch, out_ch)
        self.residual_blocks = nn.Sequential(*[Residual(in_ch, out_ch) for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.residual_blocks(self.conv(x))


class RangeNet(nn.Module):
    """forward(img NCHW, feature=None | 'lidargen' | 'decoder') -> logits
    (B, num_classes, H, W), the 4096 lidargen features (B, 4096) or the
    decoder's map (B, 32, H, W) (reference rangenet.py:107-177)."""

    def __init__(self, in_channels: int = 5, num_classes: int = 20, backbone: int = 53):
        super().__init__()
        n = NUM_RESBLOCKS[backbone]
        ch = [32 << i for i in range(6)]
        self.backbone = backbone
        self.stem = conv_bn_lrelu(in_channels, 32)
        for i in range(5):
            setattr(self, f"enc{i + 1}", Block(ch[i], ch[i + 1], n[i], "down"))
        for i in range(5, 0, -1):
            setattr(self, f"dec{i}", Block(ch[i], ch[i - 1], 1, "up"))
        self.head = nn.Conv2d(32, num_classes, 3, padding=1)

    def forward(self, img: torch.Tensor, feature: Optional[str] = None) -> torch.Tensor:
        skips = [self.stem(img)]
        for i in range(1, 6):
            skips.append(getattr(self, f"enc{i}")(skips[-1]))
        h = skips.pop()
        for i in range(5, 0, -1):
            h = getattr(self, f"dec{i}")(h) + skips.pop()
        if feature == "lidargen":
            return flatten_and_subsample(h)
        if feature == "decoder":
            return h
        if feature is not None:
            raise ValueError(f"unknown feature {feature!r}")
        return self.head(h)


def subsample_indices(C: int, H: int, W: int) -> np.ndarray:
    """The fixed 4096 feature indices in NCHW flat order (reference
    rangenet.py:150-155: ``random.seed(0); random.sample(range(C*H*W),
    4096)``), drawn from a private ``random.Random(0)``: the same indices,
    and the global ``random`` state is left alone."""
    return np.asarray(random.Random(0).sample(range(C * H * W), NUM_FEATURES), dtype=np.int64)


def flatten_and_subsample(fmaps: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4096) lidargen features, in NCHW flat order
    whatever the memory format."""
    B, C, H, W = fmaps.shape
    idx = torch.from_numpy(subsample_indices(C, H, W)).to(fmaps.device)
    return fmaps.reshape(B, C * H * W)[:, idx]


def preprocess(
    img: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    mean: Sequence[float] = IMG_MEANS,
    std: Sequence[float] = IMG_STDS,
) -> torch.Tensor:
    """Standardise and mask (B, C, H, W) inputs, channel order (range, x, y,
    z, remission) (reference rangenet.py:511-529); the mask defaults to
    range > 0."""
    if img.shape[1] != len(mean):
        raise ValueError(f"{img.shape[1]} input channels for {len(mean)} means")
    if mask is None:
        mask = (img[:, 0:1] > 0).to(img.dtype)
    mean_t = torch.tensor(mean, dtype=img.dtype, device=img.device)[:, None, None]
    std_t = torch.tensor(std, dtype=img.dtype, device=img.device)[:, None, None]
    return (img - mean_t) / std_t * mask


def forward_flops(model: RangeNet, H: int, W: int) -> int:
    """FLOPs of one forward of one (C, H, W) image, from the module shapes
    (every conv and transposed conv; a multiply-add counts 2), counted on
    the meta device."""
    flops = 0

    def count(module, args, out):
        nonlocal flops
        w = module.weight
        if isinstance(module, nn.ConvTranspose2d):  # each input pixel meets every tap
            flops += 2 * args[0][0].numel() * w.shape[1] * w.shape[2] * w.shape[3]
        else:
            flops += 2 * out[0].numel() * w[0].numel()

    meta = RangeNet(model.stem[0].in_channels, model.head.out_channels, model.backbone).to("meta")
    hooks = [m.register_forward_hook(count) for m in meta.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            meta(torch.empty((1, model.stem[0].in_channels, H, W), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return flops


# -------------------------------------------------------- bonnetal weights
def read_arch_cfg(text: str) -> dict:
    """The block-style YAML subset of a bonnetal ``arch_cfg.yaml``: nested
    mappings by indentation, ``- item`` lists, ``[a, b]`` flow lists, and
    plain, quoted, boolean, integer and float scalars, with ``#`` comments.
    Enough for ``backbone.input_depth``, ``backbone.extra.layers`` and
    ``dataset.sensor.img_means``/``img_stds``."""

    def scalar(v: str):
        v = v.strip()
        if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
            return v[1:-1]
        if v.startswith("[") and v.endswith("]"):
            return [scalar(x) for x in v[1:-1].split(",") if x.strip()]
        low = v.lower()
        if low in ("true", "yes", "on"):
            return True
        if low in ("false", "no", "off"):
            return False
        if low in ("null", "~", ""):
            return None
        for kind in (int, float):
            try:
                return kind(v)
            except ValueError:
                pass
        return v

    def strip_comment(line: str) -> str:
        quote = None
        for i, c in enumerate(line):
            if c in "'\"":
                quote = None if quote == c else (c if quote is None else quote)
            elif c == "#" and quote is None and (i == 0 or line[i - 1] in " \t"):
                return line[:i]
        return line

    lines = []
    for raw in text.splitlines():
        line = strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))

    def parse(i: int, indent: int):
        """The block at ``indent`` starting at line i -> (value, next i)."""
        if lines[i][1].startswith("- ") or lines[i][1] == "-":
            items = []
            while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("-"):
                items.append(scalar(lines[i][1][1:]))
                i += 1
            return items, i
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            key, sep, rest = lines[i][1].partition(":")
            if not sep:
                raise ValueError(f"arch_cfg.yaml: cannot read {lines[i][1]!r}")
            i += 1
            if rest.strip():
                out[key.strip()] = scalar(rest)
            elif i < len(lines) and (lines[i][0] > indent or lines[i][1].startswith("-")):
                out[key.strip()], i = parse(i, lines[i][0])
            else:
                out[key.strip()] = None
        return out, i

    if not lines:
        return {}
    cfg, end = parse(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"arch_cfg.yaml: cannot read {lines[end][1]!r}")
    return cfg


def load_rangenet_tar(path: str):
    """Read an official bonnetal tar.gz (reference rangenet.py:449-508):
    ``{arch}/backbone``, ``segmentation_decoder``, ``segmentation_head``
    (torch state dicts) and ``arch_cfg.yaml``. Returns (port state dict,
    {in_channels, num_classes, backbone}, (mean, std))."""
    arch = os.path.basename(path).replace(".tar.gz", "")
    sd: dict[str, torch.Tensor] = {}
    with tarfile.open(path, "r:gz") as tar:
        for part in ("backbone", "segmentation_decoder", "segmentation_head"):
            data = tar.extractfile(f"{arch}/{part}").read()
            for name, tensor in torch.load(io.BytesIO(data), map_location="cpu", weights_only=True).items():
                if name in sd:
                    raise ValueError(f"{path}: {name} appears twice")
                sd[name] = tensor
        arch_cfg = read_arch_cfg(tar.extractfile(f"{arch}/arch_cfg.yaml").read().decode())
    inputs = arch_cfg["backbone"]["input_depth"]
    in_ch = sum({"xyz": 3, "range": 1, "remission": 1, "mask": 1}[k] for k, on in inputs.items() if on)
    cfg = dict(in_channels=in_ch, num_classes=int(sd["1.bias"].shape[0]),
               backbone=int(arch_cfg["backbone"]["extra"]["layers"]))
    sensor = arch_cfg["dataset"]["sensor"]
    return rangenet_state_dict_from_bonnetal(sd), cfg, (sensor["img_means"][:in_ch], sensor["img_stds"][:in_ch])


def save_rangenet_tar(path: str, model: RangeNet) -> None:
    """Write ``model`` as a bonnetal tar.gz that :func:`load_rangenet_tar`
    (and the JAX package's) reads: ``<arch>/backbone`` (stem, encoder),
    ``segmentation_decoder``, ``segmentation_head`` under the bonnetal names,
    and an ``arch_cfg.yaml`` with the keys the readers use (the
    SemanticKITTI input statistics)."""
    arch = os.path.basename(path).replace(".tar.gz", "")
    bonn = bonnetal_from_rangenet_state_dict(model.state_dict())
    parts = {"backbone": {}, "segmentation_decoder": {}, "segmentation_head": {}}
    for k, v in bonn.items():
        part = ("segmentation_head" if k.startswith("1.") else
                "segmentation_decoder" if k.startswith("dec") else "backbone")
        parts[part][k] = v.contiguous()
    in_ch = model.stem[0].in_channels
    if in_ch != 5:
        raise ValueError("the bonnetal layout written here has the 5 inputs range, xyz, remission")
    lists = "\n".join(f"    {name}:\n" + "".join(f"      - {float(v)!r}\n" for v in vals)
                      for name, vals in (("img_means", IMG_MEANS), ("img_stds", IMG_STDS)))
    cfg_text = (f"backbone:\n  name: \"darknet\"\n  input_depth:\n    range: True\n    xyz: True\n"
                f"    remission: True\n  extra:\n    layers: {model.backbone}\n"
                f"dataset:\n  sensor:\n    name: \"HDL64\"\n{lists}")
    with tarfile.open(path, "w:gz", compresslevel=1) as tar:
        for name, obj in [*parts.items(), ("arch_cfg.yaml", None)]:
            if obj is None:
                data = cfg_text.encode()
            else:
                buf = io.BytesIO()
                torch.save(obj, buf)
                data = buf.getvalue()
            info = tarfile.TarInfo(f"{arch}/{name}")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def _build(weights_tar: Optional[str], backbone: int, device):
    if weights_tar is None:
        return RangeNet(backbone=backbone).to(device).eval(), partial(preprocess)
    sd, cfg, (mean, std) = load_rangenet_tar(weights_tar)
    if cfg["backbone"] != backbone:
        raise ValueError(f"{weights_tar} holds darknet{cfg['backbone']}, not darknet{backbone}")
    model = RangeNet(**cfg)
    model.load_state_dict(sd)
    return model.to(device).eval(), partial(preprocess, mean=mean, std=std)


def rangenet53(weights_tar: Optional[str] = None, device="cuda"):
    """(RangeNet-53, its preprocess) from a local official tar, or random
    weights without one (reference rangenet53(), rangenet.py:590-612)."""
    return _build(weights_tar, 53, device)


def rangenet21(weights_tar: Optional[str] = None, device="cuda"):
    return _build(weights_tar, 21, device)


# ----------------------------------------------------- SemanticKITTI labels
ID2LABEL = {
    0: "unlabeled", 1: "car", 2: "bicycle", 3: "motorcycle", 4: "truck",
    5: "other-vehicle", 6: "person", 7: "bicyclist", 8: "motorcyclist",
    9: "road", 10: "parking", 11: "sidewalk", 12: "other-ground",
    13: "building", 14: "fence", 15: "vegetation", 16: "trunk",
    17: "terrain", 18: "pole", 19: "traffic-sign",
}

# (20, 3) uint8 RGB colour of each label: the SemanticKITTI BGR palette
# flipped to RGB (reference rangenet.py:654-686)
SEMANTICKITTI_RGB = np.array([
    (0, 0, 0), (100, 150, 245), (100, 230, 245), (30, 60, 150), (80, 30, 180),
    (0, 0, 255), (255, 30, 30), (255, 40, 200), (150, 30, 90), (255, 0, 255),
    (255, 150, 255), (75, 0, 75), (175, 0, 75), (255, 200, 0), (255, 120, 50),
    (0, 175, 0), (135, 60, 0), (150, 240, 80), (255, 240, 150), (255, 0, 0),
], dtype=np.uint8)
