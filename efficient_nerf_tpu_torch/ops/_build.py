"""Builds the package's CUDA sources with nvcc on first use and loads them
with ctypes.

Each `csrc/<name>.cu` becomes `build/kernels/lib<name>-<hash>.so` at the
root of the checkout (a directory that .gitignore lists), compiled for
`sm_90a` with a plain C interface: no PyTorch headers, so a build takes
seconds. The hash covers the source, every header in csrc/ and the flags, so
an edited source is rebuilt and a stale library is never loaded. A build
error raises with nvcc's output. Only the package's own sources are built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "build_all", "build_log",
           "load_kernels", "library_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("r2l_forward", "r2l_int8", "r2l_train", "r2l_wgrad", "trig",
           "nerf_forward", "sample_pdf", "nerf_int8", "nerf_frame")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

Signature = Tuple[object, Sequence[object]]  # (restype, argtypes)
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, final) or None when
    the library for this exact source is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Build every source that is not built yet, one nvcc for each, all
    started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    try:
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    finally:
        for s in started.values():  # on an error, stop what still runs
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (with ptxas's register and shared-memory report) for
    the current build of `name`, or '' if it was built by another process."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_kernels(name: str, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed, with
    restype and argtypes declared for every function in `signatures`."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = list(argtypes)
        _loaded[name] = lib
    return lib
