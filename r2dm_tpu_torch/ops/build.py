"""Build and load the hand-written CUDA kernels (nvcc -> shared library -> ctypes).

Each ``r2dm_tpu_torch/csrc/<name>.cu`` compiles on its own into
``r2dm_tpu_torch/_build/lib<name>-<hash>.so`` for ``sm_90a`` with a plain C
interface, at first use and never at import. The hash covers the source and
the flags, so an edited source builds anew. ``build_all`` starts one nvcc per
source at once and waits for all of them. ``load_host`` does the same with
g++ for host code, ``csrc/<name>.cc`` (the projection core).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)
SOURCES = ("gn_silu", "act_ringconv", "w8a8_ringconv")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or None
    when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    target.with_suffix(".log").write_text(out)
    os.replace(tmp, target)


def build_log(name: str) -> str:
    """nvcc's output for ``name`` (ptxas: registers, spills, shared memory),
    kept beside the library, so a library an earlier process built reports
    it too."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=SOURCES) -> None:
    """Compile every kernel source in parallel (one nvcc each)."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        errors = []
        for n, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_target(name)))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _host_target(name: str) -> Path:
    src = (CSRC / f"{name}.cc").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``csrc/<name>.cc``, built with g++ on first use;
    raises when it cannot be built."""
    key = f"host:{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        target = _host_target(name)
        if not target.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: csrc/{name}.cc is built with a C++ compiler")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([gxx, *GXX_FLAGS, str(CSRC / f"{name}.cc"), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for csrc/{name}.cc:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        _libs[key] = ctypes.CDLL(str(target))
        return _libs[key]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code (cudaGetLastError
    right after the launch: a refused launch never runs, and a later
    synchronize would not report it)."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
