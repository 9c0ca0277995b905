"""Weights in and out of the port's ``EfficientUNet``.

The port's parameters carry the reference torch ``state_dict`` names, so a
reference checkpoint needs only its wrapper prefixes stripped and the
constants it registers as buffers dropped (FIR kernels, residual ``scale``,
coordinate-encoding tables, ``_dummy``, discrete beta tables), which the port
recomputes. ``state_dict_from_jax`` carries a flax ``{'params', 'buffers'}``
tree of numpy arrays over: HWIO -> OIHW, (I, O) -> (O, I), the packed qkv,
and ``coords`` (H, W, 2) -> (1, 2, H, W); ``jax_from_state_dict`` is its
inverse, for the checkpoint writer.
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


def _flax_path(key: str) -> tuple[tuple[str, ...], str]:
    """The port's parameter name -> (flax path, transform: "conv", "lin" or
    ""), the inverse of ``state_dict_from_jax``'s walk."""
    *mod, leaf = key.split(".")
    wb = {"weight": "kernel", "bias": "bias"}.get(leaf)
    if wb is None and leaf not in ("in_proj_weight", "in_proj_bias"):
        raise KeyError(f"unhandled parameter: {key}")
    if mod[0] == "time_embedding":
        return ("time_embedding", {"1": "dense1", "3": "dense2"}[mod[1]], wb), "lin" if wb == "kernel" else ""
    if mod[0] in ("in_conv", "out_conv"):
        return (mod[0], "conv", wb), "conv" if wb == "kernel" else ""
    block = mod[0]
    if not re.fullmatch(r"[du]_block\d", block):
        raise KeyError(f"unhandled parameter: {key}")
    conv = "conv" if wb == "kernel" else ""
    if mod[1:] == ["downsample", "0"]:
        return (block, "down_conv", "conv", wb), conv
    if mod[1:] == ["upsample", "1"]:
        return (block, "up_conv", "conv", wb), conv
    if mod[1] == "residual_blocks":
        res = f"res{mod[2]}"
        if mod[3] in ("conv1", "conv2", "skip"):
            return (block, res, mod[3], "conv", wb), conv
        if mod[3:] == ["norm2", "proj", "1"]:
            return (block, res, "norm2", "proj", wb), "lin" if wb == "kernel" else ""
        if mod[3] in ("norm1", "norm2") and len(mod) == 4:
            return (block, res, mod[3], {"weight": "scale", "bias": "bias"}[leaf]), ""
    if mod[1] == "self_attn_block":
        if mod[2] == "norm":
            return (block, "attn", "norm", {"weight": "scale", "bias": "bias"}[leaf]), ""
        if mod[2:] == ["attn"]:
            if leaf == "in_proj_weight":
                return (block, "attn", "attn", "qkv_kernel"), "lin"
            return (block, "attn", "attn", "qkv_bias"), ""
        if mod[2:] == ["attn", "out_proj"]:
            return (block, "attn", "attn", "out_proj", wb), "lin" if wb == "kernel" else ""
    raise KeyError(f"unhandled parameter: {key}")


def jax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's ``state_dict`` (or any name -> tensor map over its
    parameters, such as AdamW's moments) -> a flax EfficientUNet
    ``{'params', 'buffers': {'coords'}}`` tree of fp32 numpy arrays: OIHW ->
    HWIO, (O, I) -> (I, O), ``coords`` (1, 2, H, W) -> (H, W, 2); the
    inverse of ``state_dict_from_jax``."""
    params: dict = {}
    buffers: dict = {}
    for key, v in sd.items():
        a = v.detach().to(torch.float32).cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
        if key == "coords":
            buffers["coords"] = np.ascontiguousarray(np.transpose(a[0], (1, 2, 0)))
            continue
        path, transform = _flax_path(key)
        if transform == "conv":
            a = np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
        elif transform == "lin":
            a = a.T
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    out = {"params": params}
    if buffers:
        out["buffers"] = buffers
    return out
