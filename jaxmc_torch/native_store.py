r"""ctypes binding for the native host fingerprint store
(jaxmc_torch/native/fps_store.cc, built into
jaxmc_torch/kernels/_build/native/).

Builds the shared library on first use with g++ (pybind11 is not in the
image; the C ABI + ctypes keeps the binding dependency-free). Falls back
cleanly when no toolchain exists: callers must check is_available().
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "native", "fps_store.cc")
_SO = os.path.join(_PKG, "kernels", "_build", "native", "libjaxmc_fps.so")
_lock = threading.Lock()
_lib = None
_build_err: Optional[str] = None


def _load():
    global _lib, _build_err
    with _lock:
        if _lib is not None or _build_err is not None:
            return _lib
        try:
            if not os.path.exists(_SO) or \
                    os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                os.makedirs(os.path.dirname(_SO), exist_ok=True)
                # build beside the target and rename: processes that
                # build at once never load a half-written library
                tmp = f"{_SO}.tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     "-pthread", _SRC, "-o", tmp],
                    check=True, capture_output=True, text=True)
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            lib.jaxmc_fps_create.restype = ctypes.c_void_p
            lib.jaxmc_fps_create_ex.restype = ctypes.c_void_p
            lib.jaxmc_fps_create_ex.argtypes = [ctypes.c_char_p,
                                                ctypes.c_uint64]
            lib.jaxmc_fps_destroy.argtypes = [ctypes.c_void_p]
            lib.jaxmc_fps_count.argtypes = [ctypes.c_void_p]
            lib.jaxmc_fps_count.restype = ctypes.c_uint64
            lib.jaxmc_fps_insert.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
                ctypes.c_uint64,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ]
            lib.jaxmc_fps_insert.restype = ctypes.c_uint64
            lib.jaxmc_fps_contains.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
                ctypes.c_uint64,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ]
            lib.jaxmc_fps_export.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            ]
            lib.jaxmc_fps_import.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
                ctypes.c_uint64,
            ]
            lib.jaxmc_fps_import.restype = ctypes.c_uint64
            _lib = lib
        except subprocess.CalledProcessError as ex:
            _build_err = f"{ex}; stderr: {ex.stderr}"
        except OSError as ex:
            _build_err = str(ex)
        return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_err


class FingerprintStore:
    """128-bit fingerprint set in native memory: LSM-tiered sorted runs
    in mmap regions with background compaction
    (jaxmc_torch/native/fps_store.cc).

    spill_dir (default: env JAXMC_FPS_SPILL_DIR) switches large runs to
    file-backed mmap so seen-sets beyond RAM page out to disk instead of
    OOM-killing the search — the MCraft_3s-scale prerequisite (SURVEY.md
    §7.5; VERDICT r4 #8). spill_threshold_bytes (env
    JAXMC_FPS_SPILL_MB, in MB) is the per-run size that triggers
    file backing."""

    def __init__(self, spill_dir: Optional[str] = None,
                 spill_threshold_bytes: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native store unavailable: {_build_err}")
        self._lib = lib
        if spill_dir is None:
            spill_dir = os.environ.get("JAXMC_FPS_SPILL_DIR", "")
        if not spill_threshold_bytes:
            mb = os.environ.get("JAXMC_FPS_SPILL_MB")
            spill_threshold_bytes = int(mb) << 20 if mb else 0
        self._h = lib.jaxmc_fps_create_ex(
            spill_dir.encode() if spill_dir else None,
            ctypes.c_uint64(spill_threshold_bytes))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.jaxmc_fps_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.jaxmc_fps_count(self._h))

    def insert(self, fps: np.ndarray) -> np.ndarray:
        """fps: [N, 4] int32 fingerprints (the keys' fingerprint128
        words). Returns a bool mask of the rows that were new (first
        in-batch occurrence of a previously-unseen fingerprint); those
        rows are now members."""
        fps = np.ascontiguousarray(fps, dtype=np.int32)
        u = fps.view(np.uint32).astype(np.uint64)
        hi = np.ascontiguousarray((u[:, 0] << np.uint64(32)) | u[:, 1])
        lo = np.ascontiguousarray((u[:, 2] << np.uint64(32)) | u[:, 3])
        out = np.zeros(len(fps), dtype=np.uint8)
        rc = self._lib.jaxmc_fps_insert(self._h, hi, lo,
                                        np.uint64(len(fps)), out)
        if rc == 0xFFFFFFFFFFFFFFFF:
            raise MemoryError(
                "native fingerprint store could not allocate a run "
                "(set JAXMC_FPS_SPILL_DIR to a disk path for seen-sets "
                "beyond RAM)")
        return out.astype(bool)

    def contains(self, fps: np.ndarray) -> np.ndarray:
        """Membership probe: bool mask, True for EVERY row whose
        fingerprint is already in the store. Nothing is inserted —
        the device-POR ample check reads this before insert()."""
        fps = np.ascontiguousarray(fps, dtype=np.int32)
        u = fps.view(np.uint32).astype(np.uint64)
        hi = np.ascontiguousarray((u[:, 0] << np.uint64(32)) | u[:, 1])
        lo = np.ascontiguousarray((u[:, 2] << np.uint64(32)) | u[:, 3])
        out = np.zeros(len(fps), dtype=np.uint8)
        self._lib.jaxmc_fps_contains(self._h, hi, lo,
                                     np.uint64(len(fps)), out)
        return out.astype(bool)

    def dump(self) -> np.ndarray:
        """Serialize the store: sorted [N, 2] uint64 (hi, lo) rows —
        the checkpoint surface (SURVEY.md §5 checkpoint/resume)."""
        n = len(self)
        hi = np.zeros(n, dtype=np.uint64)
        lo = np.zeros(n, dtype=np.uint64)
        self._lib.jaxmc_fps_export(self._h, hi, lo)
        return np.stack([hi, lo], axis=1)

    def load(self, arr: np.ndarray) -> None:
        """Replace the contents with a dump() array (sorted, unique)."""
        arr = np.ascontiguousarray(arr, dtype=np.uint64)
        hi = np.ascontiguousarray(arr[:, 0])
        lo = np.ascontiguousarray(arr[:, 1])
        ok = self._lib.jaxmc_fps_import(self._h, hi, lo,
                                        np.uint64(len(arr)))
        if not ok:
            raise ValueError("fingerprint import rejected: rows are not "
                             "sorted-unique (corrupt checkpoint?)")
