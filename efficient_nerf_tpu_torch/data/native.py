"""ctypes binding to the C++ shard reader (runtime/shard_reader.cpp).

At first use the reader is compiled with g++ into
`build/runtime/libens_runtime-<hash>.so` at the root of the checkout (a
directory that .gitignore lists); the hash covers the source and the flags,
so an edited source is rebuilt and a stale library is never loaded. The
binding writes nothing into runtime/. A failed build or load raises with
g++'s or the loader's message: there is no silent fallback here, and the
caller's `use_native=False` (ShardLoader) is the one switch for the numpy
path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["RUNTIME_SRC", "BUILD_DIR", "library_path", "build_library",
           "load_library", "NativeShardReader"]

_ROOT = Path(__file__).resolve().parent.parent.parent
RUNTIME_SRC = _ROOT / "runtime" / "shard_reader.cpp"
BUILD_DIR = _ROOT / "build" / "runtime"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def library_path(src: Optional[Path] = None, build_dir: Optional[Path] = None) -> Path:
    """Where the library for this exact source and these flags lives (by
    default runtime/shard_reader.cpp, built into build/runtime/)."""
    src = Path(RUNTIME_SRC if src is None else src)
    if not src.is_file():
        raise RuntimeError(f"the native shard reader's source {src} is missing")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return Path(BUILD_DIR if build_dir is None else build_dir) / \
        f"libens_runtime-{h.hexdigest()[:16]}.so"


def build_library(src: Optional[Path] = None, build_dir: Optional[Path] = None) -> Path:
    """Compile `src` unless its library is built; returns the library's
    path. Raises RuntimeError with g++'s output when the build fails."""
    out = library_path(src, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    src = RUNTIME_SRC if src is None else src
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"could not run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load_library(src: Optional[Path] = None,
                 build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded shard reader, built first if needed, with every function's
    restype and argtypes declared."""
    with _lock:
        path = build_library(src, build_dir)
        lib = _loaded.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.ens_reader_create.restype = ctypes.c_void_p
            lib.ens_reader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.ens_reader_destroy.restype = None
            lib.ens_reader_destroy.argtypes = [ctypes.c_void_p]
            lib.ens_reader_num_shards.restype = ctypes.c_int
            lib.ens_reader_num_shards.argtypes = [ctypes.c_void_p]
            lib.ens_reader_load_batch.restype = ctypes.c_int
            lib.ens_reader_load_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            _loaded[path] = lib
        return lib


class NativeShardReader:
    """Parallel batch assembly of fixed-shape float32 .npy shards.

    load_batch(indices) returns one contiguous [k*rows, cols] float32 array
    filled by the C++ thread pool (n_threads 0: one a hardware thread).
    """

    def __init__(self, paths: Sequence[str], rows: int = 4096, cols: int = 9,
                 n_threads: int = 0):
        self._lib = load_library()
        self.rows, self.cols = rows, cols
        self._paths: List[str] = list(paths)
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = self._lib.ens_reader_create(arr, len(paths), rows, cols,
                                                   n_threads)
        if not self._handle:
            raise RuntimeError("ens_reader_create failed")

    def __len__(self) -> int:
        return len(self._paths)

    def load_batch(self, indices: Sequence[int],
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        if not self._handle:
            raise RuntimeError("the reader is closed")
        k = len(indices)
        if out is None:
            out = np.empty((k * self.rows, self.cols), np.float32)
        if out.shape != (k * self.rows, self.cols) or out.dtype != np.float32 \
                or not out.flags.c_contiguous:
            raise ValueError(f"out must be a C-contiguous float32 "
                             f"[{k * self.rows}, {self.cols}] array")
        idx = (ctypes.c_int * k)(*indices)
        rc = self._lib.ens_reader_load_batch(
            self._handle, idx, k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"native shard read failed (code {rc})")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ens_reader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        self.close()
