"""One-command validation of a released reference checkpoint, on the port.

    python -m r2dm_tpu_torch.validate_pretrained /path/to/r2dm-h-kitti360-300k.pth
    python -m r2dm_tpu_torch.validate_pretrained CKPT --skip_reference --device cpu --json

The counterpart of the JAX package's ``tools/validate_pretrained.py``: the
same four stages, flags, ``[PASS]``/``[FAIL]``/``[SKIP]`` lines, ``--json``
report (``{"ok", "stages": {name: {"ok", "detail"}}}``, one line) and exit
codes (0 when every stage passes, else 1; a failed import stops the chain):

  1. import     - ``setup_model`` of the port (a reference ``.pth`` or a
                  msgpack checkpoint) on ``--device``, in bf16 on the card
                  (the type of its kernels, as every CLI of the port) and
                  fp32 on the CPU: its parameter count and resolution;
  2. ref-parity - the original torch network, built from the reference
                  code (``--reference_dir``, default ``$R2DM_REFERENCE_DIR``)
                  and the checkpoint as the reference's utils/inference.py
                  builds it, against the port's network on the same seeded
                  input, both on the CPU in fp32: max|diff| within ``--atol``
                  (absolute, or relative to the reference's largest value);
  3. sample     - a short DDPM chain on ``--device``: finite, within
                  [-1.2, 1.2], not degenerate, and the README surface
                  denormalize -> revert_depth -> to_xyz (reference
                  README.md:22-34);
  4. metrics    - with ``--rangenet_tar`` / ``--pointnet_ckpt`` (the official
                  extractor weights), each file's parameter count through
                  the port's loaders; then the ``sample_and_save`` and
                  ``evaluate`` commands of the 10k-sample FRD/FPD protocol.

The reference code is the original PyTorch repository, not the JAX
package; it is read, never changed. Without it and without
``--skip_reference`` the ref-parity stage fails, as in the JAX tool. The
port's ``evaluate`` takes the real set's root as ``--data_root``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np
import torch

from .inference import setup_model

REFERENCE_DIR_ENV = "R2DM_REFERENCE_DIR"


def _stub_reference_deps() -> None:
    """A stub for numba, which only the reference's data and render paths
    use (numba.jit as the identity); the port never imports numba."""
    if "numba" not in sys.modules:
        numba = types.ModuleType("numba")
        numba.jit = lambda *a, **k: (lambda f: f)
        sys.modules["numba"] = numba


def load_reference_model(ckpt_path: str, reference_dir: str):
    """The reference EfficientUNet built from the checkpoint's config and
    loaded with its EMA weights (reference utils/inference.py:16-114), on
    the CPU in fp32: (model, missing keys, unexpected keys)."""
    if not os.path.isdir(reference_dir):
        raise FileNotFoundError(f"no reference code at {reference_dir}")
    _stub_reference_deps()
    if reference_dir not in sys.path:
        sys.path.insert(0, reference_dir)
    from models.efficient_unet import EfficientUNet as RefUNet

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    cfg = ckpt["cfg"]
    model_cfg = cfg["model"] if isinstance(cfg, dict) else cfg.model.__dict__
    data_cfg = cfg["data"] if isinstance(cfg, dict) else cfg.data.__dict__

    def g(d, k, default=None):
        return d.get(k, default) if isinstance(d, dict) else getattr(d, k, default)

    model = RefUNet(
        in_channels=int(g(data_cfg, "train_depth", True)) + int(g(data_cfg, "train_reflectance", True)),
        resolution=tuple(g(data_cfg, "resolution")),
        base_channels=g(model_cfg, "base_channels"),
        temb_channels=g(model_cfg, "temb_channels"),
        channel_multiplier=tuple(g(model_cfg, "channel_multiplier")),
        num_residual_blocks=tuple(g(model_cfg, "num_residual_blocks")),
        gn_num_groups=g(model_cfg, "gn_num_groups"),
        gn_eps=g(model_cfg, "gn_eps"),
        attn_num_heads=g(model_cfg, "attn_num_heads"),
        coords_encoding=g(model_cfg, "coords_encoding"),
        ring=True,
    )
    weights = ckpt.get("ema_weights") or ckpt.get("weights")
    sd = {}
    for k, v in weights.items():
        if k.startswith("ema_model."):
            sd[k[len("ema_model."):]] = v
        elif not k.startswith(("online_model.", "initted", "step")):
            sd[k] = v
    sd = {(k[6:] if k.startswith("model.") else k): torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    return model.eval(), missing, unexpected


def stage_import(path: str, device):
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else None
    ddpm, lidar_utils, cfg = setup_model(path, ema=True, dtype=dtype, device=device)
    return ddpm, lidar_utils, cfg, f"{ddpm.num_parameters:,} params, resolution {tuple(cfg.data.resolution)}"


def stage_ref_parity(ckpt_path: str, atol: float, reference_dir):
    if not reference_dir:
        raise FileNotFoundError(f"no reference code: pass --reference_dir or set ${REFERENCE_DIR_ENV} "
                                "(or --skip_reference)")
    model, missing, unexpected = load_reference_model(ckpt_path, reference_dir)
    if unexpected:
        raise AssertionError(f"reference rejects {len(unexpected)} keys: {unexpected[:5]}")
    ddpm, _, cfg = setup_model(ckpt_path, ema=True, device="cpu")  # fp32, the kernels' plain versions
    H, W = tuple(cfg.data.resolution)
    C = ddpm.sampling_shape[-1]
    x = np.random.default_rng(1234).standard_normal((2, C, H, W)).astype(np.float32)
    cond = np.asarray([4.0, -3.0], np.float32)  # logSNR range endpoints-ish
    ours = ddpm.model
    with torch.inference_mode():
        y_ref = model(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
        y = ours(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1))), torch.from_numpy(cond))
    y = y.permute(0, 3, 1, 2).numpy()
    err = float(np.max(np.abs(y - y_ref)))
    scale = float(np.max(np.abs(y_ref)) + 1e-12)
    if not (err <= atol or err / scale <= atol):
        raise AssertionError(f"activation mismatch: max|Δ|={err:.3e} (ref scale {scale:.3e}, atol {atol})")
    return f"max|Δ|={err:.3e} over ref scale {scale:.3e}"


def stage_sample(ddpm, lidar_utils, steps: int, batch: int):
    with torch.inference_mode():
        x = ddpm.sample(batch_size=batch, num_steps=steps, seeds=list(range(batch)))
        # README surface: denormalize -> revert_depth -> to_xyz
        depth = lidar_utils.revert_depth(lidar_utils.denormalize(x[:, [0]]))
        r = torch.linalg.norm(lidar_utils.to_xyz(depth), dim=1).float().cpu().numpy()
    x = x.float().cpu().numpy()
    for bad, why in ((not np.isfinite(x).all(), "non-finite samples"),
                     (not (-1.2 <= x.min() and x.max() <= 1.2), f"range [{x.min()}, {x.max()}]"),
                     (not x.std() > 0.05, f"degenerate samples (std={x.std():.4f})"),
                     (not np.isfinite(r).all(), "non-finite to_xyz ranges")):
        if bad:  # checks that hold under python -O too
            raise AssertionError(why)
    return (f"{batch}x{steps}-step sample ok: range [{x.min():.2f}, {x.max():.2f}], "
            f"std {x.std():.3f}; to_xyz max range {r.max():.1f} m")


def stage_metrics(args):
    msgs = []
    if args.rangenet_tar:
        from .metrics.extractor import rangenet as rn

        sd, _, _ = rn.load_rangenet_tar(args.rangenet_tar)
        msgs.append(f"rangenet tar loads: {sum(t.numel() for t in sd.values()):,} params")
    if args.pointnet_ckpt:
        from .metrics.extractor import pointnet as pn

        model = pn.pretrained_pointnet(args.pointnet_ckpt, device="cpu")
        msgs.append(f"pointnet ckpt loads: {sum(t.numel() for t in model.state_dict().values()):,} params")
    proto = (
        f"python -m r2dm_tpu_torch.sample_and_save --ckpt {args.ckpt} --output_dir samples/ "
        f"--num_samples 10000 --batch_size 64 --num_steps 256\n"
        f"  python -m r2dm_tpu_torch.evaluate --ckpt {args.ckpt} --sample_dir samples/ "
        f"--data_root {args.real_dir or '<KITTI-360 root>'}"
        + (f" --rangenet_tar {args.rangenet_tar}" if args.rangenet_tar else "")
        + (f" --pointnet_ckpt {args.pointnet_ckpt}" if args.pointnet_ckpt else "")
    )
    head = "; ".join(msgs) + ("\n  " if msgs else "")
    return head + "full 10k FRD/FPD protocol:\n  " + proto


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt", help="reference .pth (or a msgpack checkpoint)")
    p.add_argument("--skip_reference", action="store_true", help="skip stage 2 (no reference code)")
    p.add_argument("--reference_dir", default=os.environ.get(REFERENCE_DIR_ENV),
                   help=f"the original PyTorch repository's checkout (default ${REFERENCE_DIR_ENV})")
    p.add_argument("--atol", type=float, default=2e-3, help="activation-parity tolerance (abs OR rel to ref max)")
    p.add_argument("--sample_steps", type=int, default=8)
    p.add_argument("--sample_batch", type=int, default=2)
    p.add_argument("--rangenet_tar", default=None)
    p.add_argument("--pointnet_ckpt", default=None)
    p.add_argument("--real_dir", default=None, help="KITTI-360 root for FRD/FPD")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: the import and sample stages")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    results = {}

    def run(name, fn, *a, **k):
        try:
            msg = fn(*a, **k)
            results[name] = {"ok": True, "detail": str(msg)}
            print(f"[PASS] {name}: {msg}")
        except Exception as e:  # noqa: BLE001 - report, don't crash the chain
            results[name] = {"ok": False, "detail": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {name}: {type(e).__name__}: {e}")

    loaded = {}

    def _import():
        ddpm, lidar_utils, _, msg = stage_import(args.ckpt, args.device)
        loaded.update(ddpm=ddpm, lidar_utils=lidar_utils)
        return msg

    run("import", _import)
    if not loaded:
        if args.json:  # same schema as the success path
            print(json.dumps({"ok": False, "stages": results}))
        else:
            print("aborted: import failed")
        return 1

    if args.skip_reference:
        results["ref-parity"] = {"ok": True, "detail": "skipped (--skip_reference)"}
        print("[SKIP] ref-parity (--skip_reference)")
    else:
        run("ref-parity", stage_ref_parity, args.ckpt, args.atol, args.reference_dir)

    run("sample", stage_sample, loaded["ddpm"], loaded["lidar_utils"], args.sample_steps, args.sample_batch)
    run("metrics", stage_metrics, args)

    ok = all(r["ok"] for r in results.values())
    if args.json:
        print(json.dumps({"ok": ok, "stages": results}))
    else:
        print(f"\n{'ALL STAGES PASS' if ok else 'SOME STAGES FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
