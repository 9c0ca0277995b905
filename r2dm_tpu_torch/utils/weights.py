"""Weights in and out of the port's denoisers (``EfficientUNet``,
``LiDARGenRefineNet``), and into its evaluation networks.

The port's parameters carry the reference torch ``state_dict`` names, so a
reference checkpoint of either network needs only its wrapper prefixes
stripped and the constants it registers as buffers dropped (FIR kernels,
residual ``scale``, coordinate-encoding tables, ``_dummy``, discrete beta
tables), which the port recomputes (``reference_state_dict``).
``state_dict_from_jax`` carries a flax EfficientUNet ``{'params',
'buffers'}`` tree of numpy arrays over: HWIO -> OIHW, (I, O) -> (O, I), the
packed qkv, and ``coords`` (H, W, 2) -> (1, 2, H, W); ``jax_from_state_dict``
is its inverse, for the checkpoint writer. ``refinenet_state_dict_from_jax``
and ``refinenet_jax_from_state_dict`` are the same pair for the RefineNet
(``convert_refinenet_state_dict`` / ``export_refinenet_state_dict`` of
r2dm_tpu/utils/torch_import.py); ``from_jax``/``to_jax`` pick the pair by
architecture. The extractors' converters map a bonnetal RangeNet state dict
(both ways) and the JAX package's flax RangeNet and PointNet trees to the
port's reference torch names.
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


def reference_state_dict(weights: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A reference checkpoint's flat ``weights``/``ema_weights`` (of either
    network) -> the port's ``state_dict``: EMA wrappers keep ``ema_model.``
    and drop ``online_model.``/``initted``/``step``; ``model.`` is stripped
    and the recomputed constants dropped (r2dm_tpu/inference.py:777-798)."""
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


# ---------------------------------------------------------------- RefineNet
# The only block whose conv2 and skip are Sequential(conv, AvgPool2d) on the
# reference side (key suffix ".0"): the pool fires iff dilation == 1 and the
# block downsamples, which in the fixed LiDARGen net is d_block2's first
# (torch_import.py:380-385).
_REFINENET_POOLED = ("d_block2", "0")


def _refinenet_norm(prefix: tuple, rest: list) -> tuple[tuple, str]:
    if rest == ["alpha"]:
        return prefix + ("alpha",), "alpha"
    if rest == ["post_affine", "weight"]:
        return prefix + ("scale",), "affine"
    if rest == ["post_affine", "bias"]:
        return prefix + ("bias",), ""
    raise KeyError(f"unhandled RefineNet norm parameter: {'.'.join(rest)}")


def _refinenet_flax_path(key: str) -> tuple[tuple, str]:
    """The port's RefineNet parameter name -> (flax path, transform: "conv",
    "alpha", "affine" or "")."""
    parts = key.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}.get(parts[-1])
    conv = "conv" if leaf == "kernel" else ""
    if parts[0] == "in_conv" and len(parts) == 2:
        return ("in_conv", leaf), conv
    if parts[:2] == ["out_conv", "2"]:
        return ("out_conv", leaf), conv
    if parts[:2] == ["out_conv", "0"]:
        return _refinenet_norm(("out_norm",), parts[2:])
    if re.fullmatch(r"d_block\d", parts[0]):
        block, sub = f"{parts[0]}_{parts[1]}", parts[2]
        if sub in ("norm1", "norm2"):
            return _refinenet_norm((block, sub), parts[3:])
        if sub in ("conv1", "conv2", "skip"):
            return (block, sub, "conv", leaf), conv
    if re.fullmatch(r"u_block\d", parts[0]):
        top, sub = parts[0], parts[1]
        if sub == "adaptive_convs" and parts[3] == "0":  # .units.j.{2k+1}.weight
            j, k = parts[5], (int(parts[6]) - 1) // 2
            return (top, f"adapt{parts[2]}_rcu", f"unit{j}_stage{k}", "conv", "kernel"), "conv"
        if sub == "adaptive_convs" and parts[3] == "1":
            return (top, f"adapt{parts[2]}_proj", "conv", leaf), conv
        if sub == "crp":
            return (top, "crp", f"conv{parts[3]}", "conv", "kernel"), "conv"
        if sub == "output_conv":
            return (top, "output_rcu", f"unit{parts[3]}_stage{(int(parts[4]) - 1) // 2}", "conv", "kernel"), "conv"
    raise KeyError(f"unhandled RefineNet parameter: {key}")


def _refinenet_port_key(path: tuple) -> str:
    """A flax RefineNet leaf path -> the port's parameter name (the inverse
    of ``_refinenet_flax_path``)."""
    top, leaf = path[0], path[-1]
    wb = {"kernel": "weight", "bias": "bias"}.get(leaf)
    norm = {"alpha": "alpha", "scale": "post_affine.weight", "bias": "post_affine.bias"}
    if top == "in_conv":
        return f"in_conv.{wb}"
    if top == "out_conv":
        return f"out_conv.2.{wb}"
    if top == "out_norm":
        return f"out_conv.0.{norm[leaf]}"
    m = re.fullmatch(r"(d_block\d)_(\d)", top)
    if m:
        sub = path[1]
        if sub in ("norm1", "norm2"):
            return f"{m[1]}.{m[2]}.{sub}.{norm[leaf]}"
        pooled = sub != "conv1" and (m[1], m[2]) == _REFINENET_POOLED
        return f"{m[1]}.{m[2]}.{sub}{'.0' if pooled else ''}.{wb}"
    if re.fullmatch(r"u_block\d", top):
        sub = path[1]
        unit = re.fullmatch(r"unit(\d+)_stage(\d+)", path[2]) if len(path) > 2 else None
        m = re.fullmatch(r"adapt(\d+)_(rcu|proj)", sub)
        if m and m[2] == "rcu":
            return f"{top}.adaptive_convs.{m[1]}.0.units.{unit[1]}.{2 * int(unit[2]) + 1}.weight"
        if m:
            return f"{top}.adaptive_convs.{m[1]}.1.{wb}"
        if sub == "crp":
            return f"{top}.crp.convs.{path[2][4:]}.1.weight"
        if sub == "output_rcu":
            return f"{top}.output_conv.units.{unit[1]}.{2 * int(unit[2]) + 1}.weight"
    raise KeyError(f"unhandled flax path: {'/'.join(path)}")


def _leaves(node, path=()):
    if isinstance(node, Mapping):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, node


def _to_port(a: np.ndarray, transform: str) -> np.ndarray:
    if transform == "conv":
        return np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
    if transform == "alpha":
        return a.reshape(1, -1, 1, 1)
    if transform == "affine":
        return a.reshape(-1, 1, 1, 1)
    return a


def refinenet_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax LiDARGenRefineNet ``{'params', 'buffers'}`` tree -> the port's
    ``state_dict`` (the names of export_refinenet_state_dict,
    torch_import.py:368-460, without ``model.``)."""
    sd: dict[str, torch.Tensor] = {}
    for path, v in _leaves(variables.get("params", variables)):
        a = v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, dtype=np.float32)
        key = _refinenet_port_key(path)
        sd[key] = _tensor(_to_port(a, _refinenet_flax_path(key)[1]))
    coords = variables.get("buffers", {}).get("coords")
    if coords is not None:
        c = coords.float().numpy() if isinstance(coords, torch.Tensor) else np.asarray(coords, np.float32)
        sd["coords"] = _tensor(np.transpose(c, (2, 0, 1))[None])
    return sd


def refinenet_jax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's RefineNet ``state_dict`` (or any name -> tensor map over
    its parameters) -> a flax ``{'params', 'buffers': {'coords'}}`` tree of
    fp32 numpy arrays; the inverse of ``refinenet_state_dict_from_jax``."""
    params: dict = {}
    buffers: dict = {}
    for key, v in sd.items():
        a = v.detach().to(torch.float32).cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
        if key == "coords":
            buffers["coords"] = np.ascontiguousarray(np.transpose(a[0], (1, 2, 0)))
            continue
        path, transform = _refinenet_flax_path(key)
        if transform == "conv":
            a = np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
        elif transform:
            a = a.reshape(-1)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    out = {"params": params}
    if buffers:
        out["buffers"] = buffers
    return out


def from_jax(variables: Mapping[str, Any], architecture: str = "efficient_unet") -> dict[str, torch.Tensor]:
    """A flax tree -> the port's ``state_dict``, for ``architecture``."""
    return refinenet_state_dict_from_jax(variables) if architecture == "refinenet" else state_dict_from_jax(variables)


def to_jax(sd: Mapping[str, torch.Tensor], architecture: str = "efficient_unet") -> dict:
    """The port's ``state_dict`` -> a flax tree, for ``architecture``."""
    return refinenet_jax_from_state_dict(sd) if architecture == "refinenet" else jax_from_state_dict(sd)


# ------------------------------------------------------- RangeNet, PointNet
_BN_FROM_FLAX = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _bonnetal_port_key(key: str):
    """A bonnetal RangeNet parameter name -> the port's, None for
    ``num_batches_tracked`` (the rules of r2dm_tpu's
    ``translate_bonnetal_key``): ``1.*`` -> ``head``, ``conv1``/``bn1`` ->
    ``stem.0``/``stem.1``, ``X.conv``/``X.upconv`` -> ``X.conv.0``, ``X.bn``
    -> ``X.conv.1``, ``X.residual[_M].convK``/``bnK`` ->
    ``X.residual_blocks.M.residual.{K-1}.{0|1}``."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf == "num_batches_tracked":
        return None
    if parts[0] == "1" and len(parts) == 2:
        return f"head.{leaf}"
    if parts[0] in ("conv1", "bn1") and len(parts) == 2:
        return f"stem.{0 if parts[0] == 'conv1' else 1}.{leaf}"
    block, sub = parts[0], parts[1]
    if re.fullmatch(r"(enc|dec)[1-5]", block):
        if sub in ("conv", "upconv") and len(parts) == 3:
            return f"{block}.conv.0.{leaf}"
        if sub == "bn" and len(parts) == 3:
            return f"{block}.conv.1.{leaf}"
        m = re.fullmatch(r"residual(?:_(\d+))?", sub)
        layer = re.fullmatch(r"(conv|bn)([12])", parts[2]) if m and len(parts) == 4 else None
        if layer:
            return (f"{block}.residual_blocks.{int(m.group(1) or 0)}.residual."
                    f"{int(layer.group(2)) - 1}.{0 if layer.group(1) == 'conv' else 1}.{leaf}")
    raise KeyError(f"unrecognized bonnetal key: {key}")


def rangenet_state_dict_from_bonnetal(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """An official bonnetal RangeNet state dict (backbone, decoder and head
    merged) -> the port's ``RangeNet`` state dict; the layouts agree, only
    the names change."""
    out = {}
    for key, v in sd.items():
        k = _bonnetal_port_key(key)
        if k is not None:
            out[k] = _tensor(v)
    return out


def bonnetal_from_rangenet_state_dict(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The inverse of ``rangenet_state_dict_from_bonnetal``: the port's
    names -> bonnetal's (encoder residuals ``residual_M``, decoder residuals
    ``residual``, the decoder's transposed conv ``upconv``)."""
    out = {}
    for key, v in sd.items():
        parts = key.split(".")
        leaf = parts[-1]
        if parts[0] == "head":
            name = f"1.{leaf}"
        elif parts[0] == "stem":
            name = f"{'conv1' if parts[1] == '0' else 'bn1'}.{leaf}"
        elif parts[1] == "conv":
            conv = "upconv" if parts[0].startswith("dec") else "conv"
            name = f"{parts[0]}.{conv if parts[2] == '0' else 'bn'}.{leaf}"
        elif parts[1] == "residual_blocks":
            res = "residual" if parts[0].startswith("dec") else f"residual_{parts[2]}"
            kind = "conv" if parts[5] == "0" else "bn"
            name = f"{parts[0]}.{res}.{kind}{int(parts[4]) + 1}.{leaf}"
        else:
            raise KeyError(f"unhandled RangeNet parameter: {key}")
        out[name] = v
    return out


def rangenet_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax ``RangeNet`` params tree (r2dm_tpu/metrics/extractor/
    rangenet.py) -> the port's state dict: conv HWIO -> OIHW, the decoder's
    transposed-conv kernel (kh, kw, in, out) -> (in, out, kh, kw) (flax
    stores it torch-like and flips it only when applied), BN scale/bias/
    mean/var -> weight/bias/running_mean/running_var."""
    sd: dict[str, torch.Tensor] = {}

    def convbn(prefix: str, node: Mapping[str, Any]) -> None:
        if "conv" in node:  # ConvBNLReLU: {conv: {kernel}, bn}
            sd[f"{prefix}.0.weight"] = _tensor(np.transpose(np.asarray(node["conv"]["kernel"]), (3, 2, 0, 1)))
            if "bias" in node["conv"]:
                sd[f"{prefix}.0.bias"] = _tensor(node["conv"]["bias"])
        else:  # ConvTransposeBNLReLU: {kernel, bias, bn}
            sd[f"{prefix}.0.weight"] = _tensor(np.transpose(np.asarray(node["kernel"]), (2, 3, 0, 1)))
            sd[f"{prefix}.0.bias"] = _tensor(node["bias"])
        for leaf, v in node["bn"].items():
            sd[f"{prefix}.1.{_BN_FROM_FLAX[leaf]}"] = _tensor(v)

    params = params.get("params", params)
    for name, node in params.items():
        if name == "head":
            sd["head.weight"] = _tensor(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
            sd["head.bias"] = _tensor(node["bias"])
        elif name == "stem":
            convbn("stem", node)
        else:
            convbn(f"{name}.conv", node["conv"])
            for res, sub in node.items():
                if res.startswith("res"):
                    for k in (1, 2):
                        convbn(f"{name}.residual_blocks.{res[3:]}.residual.{k - 1}", sub[f"conv{k}"])
    return sd


def pointnet_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax ``PointNet1`` params tree (r2dm_tpu/metrics/extractor/
    pointnet.py) -> the port's state dict under the SpareNet names: Dense
    kernels (I, O) -> Conv1d (O, I, 1) for ``conv*``, Linear (O, I) for
    ``fc*``; each ``<layer>_bn`` -> the scope's ``bnN``."""
    bn_index = {"stn": ("conv1", "conv2", "conv3", "fc1", "fc2"), "feat": ("conv1", "conv2", "conv3"),
                "": ("fc1", "fc2")}
    sd: dict[str, torch.Tensor] = {}

    def scope(prefix: str, kind: str, node: Mapping[str, Any]) -> None:
        for name, sub in node.items():
            if name in ("stn", "feat"):
                continue
            if name.endswith("_bn"):
                n = bn_index[kind].index(name[:-3]) + 1
                for leaf, v in sub.items():
                    sd[f"{prefix}bn{n}.{_BN_FROM_FLAX[leaf]}"] = _tensor(v)
            else:
                w = np.asarray(sub["kernel"]).T
                sd[f"{prefix}{name}.weight"] = _tensor(w[..., None] if name.startswith("conv") else w)
                sd[f"{prefix}{name}.bias"] = _tensor(sub["bias"])

    params = params.get("params", params)
    scope("", "", params)
    scope("feat.", "feat", params["feat"])
    scope("feat.stn.", "stn", params["feat"]["stn"])
    return sd
