"""The port's unfolding-angle tools against the JAX package's, on the CPU:
``python -m r2dm_tpu_torch.make_unfolding_angles`` on the fake KITTI-360
tree of ``tests/test_unfolding_e2e.py`` and ``python -m
r2dm_tpu_torch.import_unfolding_angles`` on a (1, 2, H, W) ``.pth`` (the
committed KITTI-360 table as the reference stores it) write the JAX tools'
tables to 1e-6; the import refuses what the JAX tool refuses; both refuse
to run without an output directory; ``model_coords`` reads the table.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_unfolding_e2e import kitti360_like_root  # noqa: F401 (a fixture)

from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch import import_unfolding_angles, make_unfolding_angles
from r2dm_tpu_torch.inference import model_coords

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TABLE = REPO / "r2dm_tpu" / "data" / "angles" / "kitti_360_unfolding_angles.npz"


def _jax_tool(name):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _table(directory, dataset="kitti_360"):
    return np.load(Path(directory) / f"{dataset}_unfolding_angles.npz")["angles"]


def test_make_unfolding_angles_writes_the_jax_tools_table(kitti360_like_root, tmp_path, monkeypatch):  # noqa: F811
    """From 4 of the 8 fake scans at width 256: the JAX tool's (64, 256, 2)
    table to 1e-6, and model_coords of an unfolding config reads it from
    $R2DM_ANGLES_DIR."""
    args = dict(dataset="kitti_360", data_root=str(kitti360_like_root), width=256, num_scans=4)
    _jax_tool("make_unfolding_angles").main(argparse.Namespace(out_dir=str(tmp_path / "jax"), **args))
    ours = tmp_path / "port"
    assert make_unfolding_angles.main(make_unfolding_angles.parse_args(
        ["--dataset", "kitti_360", "--data_root", str(kitti360_like_root), "--width", "256", "--num_scans", "4",
         "--out_dir", str(ours)])) == 0
    got, want = _table(ours), _table(tmp_path / "jax")
    assert got.shape == (64, 256, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    monkeypatch.setenv("R2DM_ANGLES_DIR", str(ours))
    cfg = port_config.Config(data=port_config.DataConfig(dataset="kitti_360", projection="unfolding-256",
                                                         resolution=(16, 128)))
    assert model_coords(cfg).shape == (16, 128, 2)


def test_import_unfolding_angles_writes_the_jax_tools_table(tmp_path, monkeypatch):
    """The committed KITTI-360 table stored as the reference stores it, a
    (1, 2, 64, 2048) float32 tensor in a .pth: the JAX tool's npz to 1e-6,
    written where $R2DM_ANGLES_DIR says."""
    pth = tmp_path / "unfolding_angles.pth"
    torch.save(torch.from_numpy(np.ascontiguousarray(np.load(TABLE)["angles"].transpose(2, 0, 1)[None])), pth)
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    np.savez_compressed(jax_dir / "kitti_360_unfolding_angles.npz",
                        angles=_jax_tool("import_unfolding_angles").convert(str(pth)))
    monkeypatch.setenv("R2DM_ANGLES_DIR", str(tmp_path / "port"))
    assert import_unfolding_angles.main(import_unfolding_angles.parse_args(
        ["--pth", str(pth), "--dataset", "kitti_360"])) == 0
    np.testing.assert_allclose(_table(tmp_path / "port"), _table(jax_dir), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["shape", "elevation", "rows", "azimuth"])
def test_import_refuses_what_the_jax_tool_refuses(tmp_path, case):
    """A tensor of another shape, elevations out of the HDL-64E range, rows
    in the wrong order, an azimuth beyond pi: the JAX tool's ValueError."""
    a = np.load(TABLE)["angles"].transpose(2, 0, 1)[None].copy()
    if case == "shape":
        a = a[0]
    elif case == "elevation":
        a[0, 0] += 1.0
    elif case == "rows":
        a[0, 0] = a[0, 0, ::-1]
    else:
        a[0, 1, 0, 5] = 4.0
    pth = tmp_path / "bad.pth"
    torch.save(torch.from_numpy(np.ascontiguousarray(a)), pth)
    with pytest.raises(ValueError) as jax_err:
        _jax_tool("import_unfolding_angles").convert(str(pth))
    with pytest.raises(ValueError) as err:
        import_unfolding_angles.convert(str(pth))
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("tool,argv", [
    (make_unfolding_angles, ["--dataset", "kitti_360", "--data_root", "unused"]),
    (import_unfolding_angles, ["--pth", str(TABLE), "--dataset", "kitti_raw"]),
])
def test_without_an_output_dir_the_tools_refuse(tool, argv, monkeypatch):
    """No --out_dir and no $R2DM_ANGLES_DIR: exit with the reason; the JAX
    package's r2dm_tpu/data/angles/ is only read."""
    monkeypatch.delenv("R2DM_ANGLES_DIR", raising=False)
    before = sorted(TABLE.parent.iterdir())
    with pytest.raises(SystemExit, match="R2DM_ANGLES_DIR"):
        tool.main(tool.parse_args(argv))
    assert sorted(TABLE.parent.iterdir()) == before
