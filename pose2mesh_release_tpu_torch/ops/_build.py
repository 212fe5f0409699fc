"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` compiles with `nvcc` for sm_90a into its own shared
library with a plain C interface, loaded through ctypes.  The libraries go
to `build/` at the root of the checkout, named by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one is reused.  All
sources compile in parallel, once, at the first kernel launch (or when
`build_all` is called).  Nothing is downloaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "build_all", "load_library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_paths: Dict[str, Path] = {}
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every csrc/*.cu not yet built, all nvcc processes at once.
    Returns {source stem: library path}; ptxas reports land in build_log."""
    if _paths:
        return dict(_paths)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src)
        if out.exists():
            _paths[src.stem] = out
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[src.stem] = (proc, tmp, out)
    failed = []
    for stem, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        build_log[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        _paths[stem] = out
    if failed:
        _paths.clear()
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return dict(_paths)


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded shared library built from csrc/<stem>.cu."""
    if stem not in _libs:
        _libs[stem] = ctypes.CDLL(str(build_all()[stem]))
    return _libs[stem]
