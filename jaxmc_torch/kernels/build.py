"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface, under `kernels/_build/<hash>/`, where
the hash covers the sources and the flags: a changed source rebuilds,
an unchanged one loads.  The libraries load with ctypes.  The build
runs at first use (never at import); all sources build in parallel,
one nvcc each.  A missing nvcc or a failed build raises.

    python -m jaxmc_torch.kernels.build     # build all, print ptxas lines
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_ROOT = os.path.join(HERE, "_build")
SOURCES = ("unpack", "keys", "probe", "merge", "canon", "por", "hstep",
           "resident", "batch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# argtypes of every C entry point: pointers and the stream as c_void_p
ARGTYPES = {
    "jmc_unpack_rows": [_P] * 8 + [_I64, _I, _I, _P],
    "jmc_keys_of": [_P] * 14 + [_I64, _I, _I, _I, _I, _I, _P],
    "jmc_seen_probe": [_P] * 4 + [_I64, _I64, _I, _P],
    "jmc_merge_flags": [_P] * 5 + [_I64, _I64, _I, _P],
    "jmc_merge_compact": [_P] * 6 + [_I64, _I64, _P],
    "jmc_merge_scatter": [_P] * 7 + [_I64, _I64, _I64, _I, _P],
    "jmc_canon_threads": [_I64],
    "jmc_canon_rows": [_P] * 3 + [_I, _P, _P, _I64, _I, _P],
    "jmc_por_max_arms": [],
    "jmc_por_mask": [_P] * 6 + [_I, _I64, _I, _P],
    "jmc_hstep_threads": [],
    "jmc_hstep_count": [_P] * 8 + [_I, _I, _I, _P],
    "jmc_hstep_scan": [_P] * 7 + [_I, _I, _P],
    "jmc_hstep_scatter": [_P] * 11 + [_I, _I, _I, _I, _P],
    "jmc_res_threads": [],
    "jmc_res_compact_count": [_P] * 7 + [_I, _I, _I, _P],
    "jmc_res_compact_scan": [_P] * 6 + [_I, _P],
    "jmc_res_compact_scatter": [_P] * 4 + [_I, _I, _I, _I, _P],
    "jmc_res_fold_copy": [_P] * 5 + [_I, _I64, _I, _I, _P],
    "jmc_res_fold_scalar": [_P] * 6 + [_I64, _I, _I, _I64, _I, _I, _I, _P],
    "jmc_batch_threads": [],
    "jmc_batch_count": [_P] * 9 + [_I, _I, _I, _P],
    "jmc_batch_scan": [_P] * 8 + [_I, _I, _I, _P],
    "jmc_batch_scatter": [_P] * 12 + [_I, _I, _I, _I, _P],
}
# return types other than the cudaError_t (an int) of a launch
RESTYPE = {"jmc_canon_threads": _I64}
ENTRY = {"unpack": ["jmc_unpack_rows"], "keys": ["jmc_keys_of"],
         "probe": ["jmc_seen_probe"],
         "merge": ["jmc_merge_flags", "jmc_merge_compact",
                   "jmc_merge_scatter"],
         "canon": ["jmc_canon_threads", "jmc_canon_rows"],
         "por": ["jmc_por_max_arms", "jmc_por_mask"],
         "hstep": ["jmc_hstep_threads", "jmc_hstep_count", "jmc_hstep_scan",
                   "jmc_hstep_scatter"],
         "resident": ["jmc_res_threads", "jmc_res_compact_count",
                      "jmc_res_compact_scan", "jmc_res_compact_scatter",
                      "jmc_res_fold_copy", "jmc_res_fold_scalar"],
         "batch": ["jmc_batch_threads", "jmc_batch_count", "jmc_batch_scan",
                   "jmc_batch_scatter"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas resource lines per source, from the build that made the library
PTXAS: Dict[str, List[str]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernels cannot "
                       "be built")


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, _digest())


def _ptxas_lines(text: str) -> List[str]:
    return [ln.strip() for ln in text.splitlines()
            if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln
                                       or "spill" in ln)]


def build_all() -> Dict[str, str]:
    """Compile every source not yet built for this digest, one nvcc
    process each, all started together.  Returns {source: .so path}."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    paths = {n: os.path.join(out_dir, f"lib{n}.so") for n in SOURCES}
    todo = [n for n in SOURCES if not os.path.exists(paths[n])]
    if not todo:
        for n in SOURCES:
            log = paths[n] + ".log"
            if n not in PTXAS and os.path.exists(log):
                with open(log) as fh:
                    PTXAS[n] = _ptxas_lines(fh.read())
        return paths
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = os.path.join(out_dir, f"lib{n}.tmp{os.getpid()}.so")
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp,
                                     os.path.join(CSRC, n + ".cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        text, _ = p.communicate()
        with open(paths[n] + ".log", "w") as fh:
            fh.write(text)
        if p.returncode != 0:
            errors.append(f"{n}.cu: nvcc exit {p.returncode}\n{text}")
            continue
        os.replace(tmp, paths[n])
        PTXAS[n] = _ptxas_lines(text)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" +
                           "\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            lib = ctypes.CDLL(paths[name])
            for fn in ENTRY[name]:
                f = getattr(lib, fn)
                f.argtypes = ARGTYPES[fn]
                f.restype = RESTYPE.get(fn, ctypes.c_int)
            _libs[name] = lib
    return lib


def load_all() -> Dict[str, List[str]]:
    """Build and load every kernel library; {source: ptxas lines}."""
    for n in SOURCES:
        library(n)
    return {n: PTXAS.get(n, []) for n in SOURCES}


if __name__ == "__main__":
    for src, lines in load_all().items():
        for ln in lines:
            print(f"{src}.cu: {ln}")
