"""The port (r2dm_tpu_torch) and chip_smoke.py stand alone: they import no
JAX, flax, optax, pydantic, msgpack, PyYAML, matplotlib (the card's machine
has neither of the last two) or anything of the JAX package r2dm_tpu, and
importing them builds no kernel."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "r2dm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pydantic", "msgpack", "yaml", "matplotlib", "r2dm_tpu")


def test_import_leaves_jax_and_the_jax_package_out():
    """In a fresh interpreter (tests/conftest.py imports jax here), import
    the package and every submodule, then look at sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import r2dm_tpu_torch\n"
        "for m in pkgutil.walk_packages(r2dm_tpu_torch.__path__, 'r2dm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in %r)\n"
        "print(len(list(pkgutil.walk_packages(r2dm_tpu_torch.__path__))), bad)\n"
        "assert not bad, bad\n"
        "assert {'r2dm_tpu_torch.ops.quant', 'r2dm_tpu_torch.models.refinenet', 'r2dm_tpu_torch.ops.fused_resample',"
        " 'r2dm_tpu_torch.hub', 'r2dm_tpu_torch.export_torch_ckpt'} <= set(sys.modules)\n"
        "from r2dm_tpu_torch.ops import build\n"
        "assert not build._libs and not build.build_logs  # nothing built\n" % (FORBIDDEN,)
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_static_scan_finds_no_forbidden_import():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "w8a8_variants.py",
                                          REPO / "fused_resample_variants.py"]
    assert len(files) > 10
    assert {PKG / "ops" / "quant.py", PKG / "models" / "refinenet.py", PKG / "ops" / "fused_resample.py",
            PKG / "hub.py", PKG / "export_torch_ckpt.py"} <= set(files)
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, f"{path.relative_to(REPO)} imports {name}"


def test_every_kernel_source_is_built_and_has_a_plain_c_interface():
    """``ops/build.py::SOURCES`` names every ``csrc/*.cu`` (the int8 lane's
    ``w8a8_ringconv.cu`` too), and none includes PyTorch's headers: each
    builds with nvcc alone in seconds and binds through ctypes."""
    from r2dm_tpu_torch.ops import build

    sources = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))
    assert sources == sorted(build.SOURCES) and "w8a8_ringconv" in sources
    for name in sources:
        text = (PKG / "csrc" / f"{name}.cu").read_text()
        assert "torch/" not in text and 'extern "C"' in text, name
