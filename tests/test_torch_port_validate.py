"""``python -m r2dm_tpu_torch.validate_pretrained`` against the JAX package's
``tools/validate_pretrained.py``, on the CPU: a synthetic reference-layout
``.pth`` written from the port's own EfficientUNet (reference key names, so
no reference code is needed) passes every stage with ``--skip_reference``;
the import detail and the extractor parameter counts are the JAX tool's; a
missing checkpoint gives the JAX tool's failure report and exit code; the
ref-parity stage against the reference code where it is present, as the
JAX package's own test runs it.
"""

import argparse
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from r2dm_tpu.metrics.extractor import rangenet as jax_rn
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch import validate_pretrained
from r2dm_tpu_torch.inference import build_model
from r2dm_tpu_torch.metrics.extractor import pointnet as pn
from r2dm_tpu_torch.metrics.extractor import rangenet as rn

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _jax_tool():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import validate_pretrained as tool
    finally:
        sys.path.pop(0)
    return tool


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(the synthetic .pth, a bonnetal darknet21.tar.gz, a SpareNet
    cls_model_39.pth), random weights from numpy and torch seeds: the
    network at tests/test_validate_pretrained.py's config, N(0, 0.05^2) so
    no zero-initialised conv hides an import fault."""
    d = tmp_path_factory.mktemp("validate")
    cfg = port_config.Config(
        data=port_config.DataConfig(resolution=(16, 64)),
        model=port_config.ModelConfig(base_channels=16, gn_num_groups=4, attn_num_heads=4,
                                      num_residual_blocks=(1, 1, 1, 1)))
    net = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    sd = {k: (torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.05).astype(np.float32))
              if k != "coords" else v) for k, v in net.state_dict().items()}
    weights = {f"model.{k}": v for k, v in sd.items()}
    ckpt = d / "synthetic-r2dm.pth"
    torch.save({"cfg": port_config.asdict(cfg), "weights": weights, "ema_weights": weights, "global_step": 1}, ckpt)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        rangenet, pointnet = rn.RangeNet(backbone=21), pn.PointNet1(k=16)
    tar = d / "darknet21.tar.gz"
    rn.save_rangenet_tar(str(tar), rangenet)
    pth = d / "cls_model_39.pth"
    torch.save(pointnet.state_dict(), pth)
    return str(ckpt), str(tar), str(pth)


def _report(capsys, argv):
    """(exit code, the --json report, every line printed)."""
    rc = validate_pretrained.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1]) if "--json" in argv else None, lines


def test_every_stage_passes_on_a_synthetic_checkpoint(files, capsys):
    """--skip_reference --device cpu --json: rc 0, the four stages of the
    JAX tool, each ok; the import detail and the extractors' parameter
    counts (state dicts with the BN statistics) are the JAX tool's own on
    the same files; the protocol names the port's CLIs."""
    ckpt, tar, pth = files
    rc, report, _ = _report(capsys, [ckpt, "--skip_reference", "--device", "cpu", "--json", "--sample_steps", "4",
                                     "--rangenet_tar", tar, "--pointnet_ckpt", pth])
    assert rc == 0 and report["ok"], report
    assert list(report["stages"]) == ["import", "ref-parity", "sample", "metrics"]
    assert all(s["ok"] for s in report["stages"].values()), report
    assert report["stages"]["ref-parity"]["detail"] == "skipped (--skip_reference)"
    tool = _jax_tool()
    assert report["stages"]["import"]["detail"] == tool.stage_import(ckpt, dtype=None)[3]
    # the JAX tool's pointnet line; its rangenet line counts the leaves of
    # what load_rangenet_tar returns, a (variables, cfg, stats) tuple, and
    # raises on the cfg's ints (ROADMAP.md section 3): the count is that of
    # the variables, as the tool means it
    pointnet_line = tool.stage_metrics(argparse.Namespace(ckpt=ckpt, rangenet_tar=None, pointnet_ckpt=pth,
                                                          real_dir=None), None).split("\n")[0]
    variables = jax_rn.load_rangenet_tar(tar)[0]
    rangenet_line = f"rangenet tar loads: {sum(int(np.prod(p.shape)) for p in jax.tree.leaves(variables)):,} params"
    assert report["stages"]["metrics"]["detail"].split("\n")[0] == f"{rangenet_line}; {pointnet_line}"
    assert "python -m r2dm_tpu_torch.sample_and_save" in report["stages"]["metrics"]["detail"]
    assert "python -m r2dm_tpu_torch.evaluate" in report["stages"]["metrics"]["detail"]
    assert report["stages"]["sample"]["detail"].startswith("2x4-step sample ok")


def test_the_text_report_marks_each_stage(files, capsys):
    """Without --json: a [PASS]/[SKIP] line a stage and the JAX tool's
    closing line."""
    rc, _, lines = _report(capsys, [files[0], "--skip_reference", "--device", "cpu", "--sample_steps", "2"])
    assert rc == 0
    assert [ln.split(" ")[0] for ln in lines if ln.startswith("[")] == ["[PASS]", "[SKIP]", "[PASS]", "[PASS]"]
    assert lines[-1] == "ALL STAGES PASS"


def test_a_missing_reference_fails_ref_parity(files, capsys, monkeypatch):
    """Without --skip_reference and without reference code the ref-parity
    stage fails and the exit code is 1, as in the JAX tool; the other
    stages still run."""
    monkeypatch.delenv(validate_pretrained.REFERENCE_DIR_ENV, raising=False)
    rc, report, _ = _report(capsys, [files[0], "--device", "cpu", "--json", "--sample_steps", "2"])
    assert rc == 1 and not report["ok"]
    assert not report["stages"]["ref-parity"]["ok"]
    assert report["stages"]["ref-parity"]["detail"].startswith("FileNotFoundError: no reference code")
    assert report["stages"]["sample"]["ok"] and report["stages"]["metrics"]["ok"]


def test_a_missing_checkpoint_gives_the_jax_tools_failure(tmp_path, capsys):
    """A checkpoint that does not exist: rc 1 and the JAX tool's one-stage
    failure report ({"ok": false, "stages": {"import": {"ok": false, ...}}})
    with the same exception type."""
    missing = str(tmp_path / "nope.pth")
    rc, report, _ = _report(capsys, [missing, "--json", "--device", "cpu"])
    jax_rc = _jax_tool().main([missing, "--json"])
    jax_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rc, report["ok"], list(report["stages"])) == (jax_rc, jax_report["ok"], list(jax_report["stages"])) \
        == (1, False, ["import"])
    assert report["stages"]["import"]["ok"] is False
    assert report["stages"]["import"]["detail"].split(":")[0] == jax_report["stages"]["import"]["detail"].split(":")[0]


def test_ref_parity_against_the_reference_code(files, capsys):
    """The ref-parity stage against the original torch network, where the
    reference code is present (the JAX tool's REF, as its own test)."""
    ref = _jax_tool().REF
    if not Path(ref).exists():
        pytest.skip("reference not mounted")
    rc, report, _ = _report(capsys, [files[0], "--reference_dir", ref, "--device", "cpu", "--json",
                                     "--sample_steps", "2"])
    assert rc == 0 and report["stages"]["ref-parity"]["ok"], report


STAND_IN = '''
import torch

from r2dm_tpu_torch.models.efficient_unet import EfficientUNet as _Port


class EfficientUNet(torch.nn.Module):
    """The port's network behind the reference's constructor and NCHW call
    (``ring`` taken and dropped); its outputs offset by OFFSET."""

    OFFSET = {offset}

    def __init__(self, ring=True, **kw):
        super().__init__()
        self.net = _Port(**kw)

    def load_state_dict(self, sd, strict=True):
        return self.net.load_state_dict(sd, strict=strict)

    def forward(self, x, t):
        return self.net(x.permute(0, 2, 3, 1), t).permute(0, 3, 1, 2) + self.OFFSET
'''


@pytest.mark.parametrize("offset,ok", [(0.0, True), (1e-2, False)])
def test_ref_parity_builds_and_compares_a_reference_network(files, tmp_path, capsys, monkeypatch, offset, ok):
    """The ref-parity stage on a stand-in reference package (models/
    efficient_unet.py under --reference_dir: the port's network behind the
    reference's constructor and NCHW call): it builds the network from the
    checkpoint's config and EMA weights and passes; an offset of 1e-2 on
    every output fails it at the default atol 2e-3."""
    ref = tmp_path / "reference"
    (ref / "models").mkdir(parents=True)
    (ref / "models" / "__init__.py").write_text("")
    (ref / "models" / "efficient_unet.py").write_text(STAND_IN.format(offset=offset))
    monkeypatch.delitem(sys.modules, "models", raising=False)
    monkeypatch.delitem(sys.modules, "models.efficient_unet", raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    rc, report, _ = _report(capsys, [files[0], "--reference_dir", str(ref), "--device", "cpu", "--json",
                                     "--sample_steps", "2"])
    assert report["stages"]["ref-parity"]["ok"] is ok and (rc == 0) is ok, report
    detail = report["stages"]["ref-parity"]["detail"]
    assert detail.startswith("max|Δ|=0.000e+00") if ok else "activation mismatch" in detail
