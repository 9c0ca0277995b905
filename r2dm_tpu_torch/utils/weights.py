"""Weights in and out of the port's ``EfficientUNet``.

The port's parameters carry the reference torch ``state_dict`` names, so a
reference checkpoint needs only its wrapper prefixes stripped and the
constants it registers as buffers dropped (FIR kernels, residual ``scale``,
coordinate-encoding tables, ``_dummy``, discrete beta tables), which the port
recomputes. ``state_dict_from_jax`` carries a flax ``{'params', 'buffers'}``
tree of numpy arrays over: HWIO -> OIHW, (I, O) -> (O, I), the packed qkv,
and ``coords`` (H, W, 2) -> (1, 2, H, W).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

DROP = re.compile(
    r"(\.scale$|^_dummy$|^beta$|^alpha_bar$|^alpha_bar_prev$|^snr$"
    r"|downsample\.1\.kernel$|upsample\.0\.kernel$|\.initted$|\.step$"
    r"|coords_encoding\.(freqs|phase)$)"
)


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).cpu()
    return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))


def reference_unet_state_dict(weights: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A reference checkpoint's flat ``weights``/``ema_weights`` -> the
    port's ``state_dict``: EMA wrappers keep ``ema_model.`` and drop
    ``online_model.``/``initted``/``step``; ``model.`` is stripped and the
    recomputed constants dropped (r2dm_tpu/inference.py:777-798)."""
    sd = {}
    for key, v in weights.items():
        if key.startswith(("online_model.", "initted", "step")):
            continue
        k = key[len("ema_model."):] if key.startswith("ema_model.") else key
        k = k[len("model."):] if k.startswith("model.") else k
        if DROP.search(k):
            continue
        sd[k] = _tensor(v)
    return sd


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax EfficientUNet ``{'params', 'buffers'}`` tree of numpy arrays ->
    the port's ``state_dict`` (r2dm_tpu/utils/torch_import.py:281-365)."""
    sd: dict[str, torch.Tensor] = {}

    def put(key: str, v, transform=None) -> None:
        # bfloat16 leaves of a msgpack checkpoint arrive as torch tensors
        v = v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, dtype=np.float32)
        sd[key] = _tensor(transform(v) if transform else v)

    def conv(v):
        return np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW

    def lin(v):
        return np.transpose(v, (1, 0))  # (I, O) -> (O, I)

    def walk(p: tuple[str, ...], node) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(p + (k,), v)
            return
        v = node
        wb = {"kernel": "weight", "bias": "bias", "scale": "weight"}.get(p[-1])
        kernel = p[-1] == "kernel"
        if p[0] == "time_embedding" and len(p) == 3:
            idx = {"dense1": "1", "dense2": "3"}[p[1]]
            put(f"time_embedding.{idx}.{wb}", v, lin if kernel else None)
        elif p[0] in ("in_conv", "out_conv") and p[1] == "conv":
            put(f"{p[0]}.{wb}", v, conv if kernel else None)
        elif len(p) >= 2 and re.fullmatch(r"[du]_block\d", p[0]):
            block = p[0]
            if p[1] == "down_conv":
                put(f"{block}.downsample.0.{wb}", v, conv if kernel else None)
            elif p[1] == "up_conv":
                put(f"{block}.upsample.1.{wb}", v, conv if kernel else None)
            elif re.fullmatch(r"res\d+", p[1]):
                base = f"{block}.residual_blocks.{p[1][3:]}"
                if p[2] in ("conv1", "conv2", "skip"):
                    put(f"{base}.{p[2]}.{wb}", v, conv if kernel else None)
                elif p[2] == "norm2" and p[3] == "proj":
                    put(f"{base}.norm2.proj.1.{wb}", v, lin if kernel else None)
                elif p[2] in ("norm1", "norm2"):
                    put(f"{base}.{p[2]}.{wb}", v)
                else:
                    raise KeyError(f"unhandled flax path: {'/'.join(p)}")
            elif p[1] == "attn" and p[2] == "norm":
                put(f"{block}.self_attn_block.norm.{wb}", v)
            elif p[1] == "attn" and p[2] == "attn":
                attn = f"{block}.self_attn_block.attn"
                if p[3] == "qkv_kernel":
                    put(f"{attn}.in_proj_weight", v, lin)
                elif p[3] == "qkv_bias":
                    put(f"{attn}.in_proj_bias", v)
                elif p[3] == "out_proj":
                    put(f"{attn}.out_proj.{wb}", v, lin if kernel else None)
                else:
                    raise KeyError(f"unhandled flax path: {'/'.join(p)}")
            else:
                raise KeyError(f"unhandled flax path: {'/'.join(p)}")
        else:
            raise KeyError(f"unhandled flax path: {'/'.join(p)}")

    walk((), variables.get("params", variables))
    coords = variables.get("buffers", {}).get("coords")
    if coords is not None:
        put("coords", coords, lambda v: np.transpose(v, (2, 0, 1))[None])
    return sd
