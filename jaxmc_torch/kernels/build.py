"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface, under `kernels/_build/<hash>/`, where
the hash covers the sources and the flags: a changed source rebuilds,
an unchanged one loads.  The libraries load with ctypes.  The build
runs at first use (never at import); all sources build in parallel,
one nvcc each.  A missing nvcc or a failed build raises.

    python -m jaxmc_torch.kernels.build     # build all, print ptxas lines

The generated transition kernels (K15-K17, compile/cgen.py) build the
same way, one source per engine, at engine construction:
`build_generated` compiles into kernels/_build/gen/<sha256 of the
source and flags>/, so a model already built loads its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_ROOT = os.path.join(HERE, "_build")
SOURCES = ("unpack", "keys", "probe", "merge", "canon", "por", "hstep",
           "resident", "batch", "fullsort", "oracle", "mesh", "sort")
# headers the sources include (in the digest: a changed header rebuilds)
HEADERS = ("lookback.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# argtypes of every C entry point: pointers and the stream as c_void_p
ARGTYPES = {
    "jmc_unpack_rows": [_P] * 8 + [_I64, _I, _I, _P],
    "jmc_keys_of": [_P] * 15 + [_I64] + [_I] * 9 + [_P],
    "jmc_seen_probe": [_P] * 4 + [_I64, _I64, _I, _I, _P],
    "jmc_merge_sorted": [_P] * 10 + [_I64] * 3 + [_I] * 4 + [_P],
    "jmc_canon_rows": [_P] * 3 + [_I] * 4 + [_P, _I64, _I, _P],
    "jmc_por_max_arms": [],
    "jmc_por_mask": [_P] * 6 + [_I, _I64, _I, _P],
    "jmc_hstep_tile": [],
    "jmc_hstep_workspace_bytes": [_I],
    "jmc_hstep_epilogue": [_P] * 16 + [_I] * 8 + [_P],
    "jmc_res_tile": [],
    "jmc_res_workspace_bytes": [_I],
    "jmc_res_compact": [_P] * 6 + [_I] * 7 + [_P],
    "jmc_res_fold_copy": [_P] * 5 + [_I, _I64, _I, _I, _P],
    "jmc_res_fold_scalar": [_P] * 6 + [_I64, _I, _I, _I64, _I, _I, _I, _P],
    "jmc_batch_threads": [],
    "jmc_batch_count": [_P] * 9 + [_I, _I, _I, _P],
    "jmc_batch_scan": [_P] * 8 + [_I, _I, _I, _P],
    "jmc_batch_scatter": [_P] * 12 + [_I, _I, _I, _I, _P],
    "jmc_fullsort_max_k": [],
    "jmc_fullsort_tile_rows": [_I],
    "jmc_fullsort_workspace_bytes": [_I],
    "jmc_fullsort_dedup": [_P] * 7 + [_I64, _I, _I64, _I64, _I, _I, _I, _P],
    "jmc_oracle_probe": [_P] * 6 + [_I, _I, _P],
    "jmc_mesh_threads": [],
    "jmc_mesh_route_fill": [_P] * 3 + [_I64, _I, _I, _P],
    "jmc_mesh_route_count": [_P] * 3 + [_I64, _I, _I, _I, _I, _I, _P],
    "jmc_mesh_route_scan": [_P] * 3 + [_I, _I, _P],
    "jmc_mesh_route_scatter": [_P] * 9 + [_I64, _I, _I, _I, _I64, _I64, _I,
                                          _I64, _I, _I, _I, _P],
    "jmc_mesh_route_gather": [_P] * 3 + [_I64, _I, _I, _I, _I, _I, _P],
    "jmc_mesh_scalars": [_P] * 2 + [_I, _I, _I, _I, _P],
    "jmc_sort_workspace_words": [_I64, _I],
    "jmc_sort_keys": [_P] * 7 + [_I64, _I, _I, _I, _I64, _I64, _I, _P],
}
# return types other than the cudaError_t (an int) of a launch
RESTYPE = {"jmc_hstep_workspace_bytes": _I64,
           "jmc_res_workspace_bytes": _I64,
           "jmc_fullsort_workspace_bytes": _I64,
           "jmc_sort_workspace_words": _I64}
ENTRY = {"unpack": ["jmc_unpack_rows"], "keys": ["jmc_keys_of"],
         "probe": ["jmc_seen_probe"],
         "merge": ["jmc_merge_sorted"],
         "canon": ["jmc_canon_rows"],
         "por": ["jmc_por_max_arms", "jmc_por_mask"],
         "hstep": ["jmc_hstep_tile", "jmc_hstep_workspace_bytes",
                   "jmc_hstep_epilogue"],
         "resident": ["jmc_res_tile", "jmc_res_workspace_bytes",
                      "jmc_res_compact", "jmc_res_fold_copy",
                      "jmc_res_fold_scalar"],
         "batch": ["jmc_batch_threads", "jmc_batch_count", "jmc_batch_scan",
                   "jmc_batch_scatter"],
         "fullsort": ["jmc_fullsort_max_k", "jmc_fullsort_tile_rows",
                      "jmc_fullsort_workspace_bytes", "jmc_fullsort_dedup"],
         "oracle": ["jmc_oracle_probe"],
         "mesh": ["jmc_mesh_threads", "jmc_mesh_route_fill",
                  "jmc_mesh_route_count", "jmc_mesh_route_scan", "jmc_mesh_route_scatter",
                  "jmc_mesh_route_gather", "jmc_mesh_scalars"],
         "sort": ["jmc_sort_workspace_words", "jmc_sort_keys"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc builds run by this process (one per source compiled): the
# profiler charges a build made inside a dispatch to that site's
# `recompiles` (obs/prof.py)
BUILDS = 0
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
    for name in [n + ".cu" for n in SOURCES] + list(HEADERS):
        with open(os.path.join(CSRC, name), "rb") as fh:
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
    global BUILDS
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
    BUILDS += len(todo)
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


# ---------------------------------------------------------------------------
# the generated transition kernels (compile/cgen.py: K15-K17)
# ---------------------------------------------------------------------------

GEN_ROOT = os.path.join(BUILD_ROOT, "gen")
GEN_ARGTYPES = {
    "jmc_gen_expand": [_P, _P, _I64, _P, _I, _I64, _I, _P, _P, _P, _P,
                       _P],
    "jmc_gen_pred": [_I, _P, _P, _I64, _I64, _P, _P],
    "jmc_gen_value": [_P, _P, _I64, _I64, _P, _P],
}
_gen_libs: Dict[str, ctypes.CDLL] = {}
# per generated source (by digest): the nvcc wall of the build this
# process made (None: the library was already built), its ptxas lines
# (registers, stack, spills per kernel) and its build directory
GEN_INFO: Dict[str, dict] = {}


def gen_digest(source: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode() + b"\0" + source.encode())
    return h.hexdigest()[:16]


def _gen_ptxas(text: str) -> List[str]:
    return [ln.strip() for ln in text.splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln]


def _error_lines(text: str) -> List[int]:
    """Source line numbers of nvcc's `gen.cu(123): error` lines."""
    return [int(m.group(1)) for m in
            re.finditer(r"gen\.cu\((\d+)\): error", text)]


def build_generated(source: str, labels_at=None) -> ctypes.CDLL:
    """Compile one generated source (one engine's units) with nvcc for
    sm_90a into kernels/_build/gen/<sha256 of source and flags>/ and
    load it: an unchanged source loads the library already built.
    Counted in BUILDS, its ptxas lines in PTXAS["gen/<digest>"].  A
    missing nvcc or a failed build raises, naming the units nvcc's
    errors point at (`labels_at(lines)`)."""
    global BUILDS
    dig = gen_digest(source)
    name = f"gen/{dig}"
    lib = _gen_libs.get(dig)
    if lib is not None:
        return lib
    with _lock:
        lib = _gen_libs.get(dig)
        if lib is not None:
            return lib
        out_dir = os.path.join(GEN_ROOT, dig)
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, "libgen.so")
        src = os.path.join(out_dir, "gen.cu")
        wall = None
        if not os.path.exists(so):
            try:
                nvcc = nvcc_path()
            except RuntimeError as ex:
                raise RuntimeError(f"generated kernels {name}: {ex}") \
                    from None
            tmp_src = f"{src}.tmp{os.getpid()}"
            with open(tmp_src, "w") as fh:
                fh.write(source)
            os.replace(tmp_src, src)
            tmp = os.path.join(out_dir, f"libgen.tmp{os.getpid()}.so")
            BUILDS += 1
            t0 = time.time()
            p = subprocess.run([nvcc] + NVCC_FLAGS + ["-o", tmp, src],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            wall = time.time() - t0
            with open(so + ".log", "w") as fh:
                fh.write(p.stdout)
            if p.returncode != 0:
                units = labels_at(_error_lines(p.stdout)) if labels_at \
                    else []
                raise RuntimeError(
                    f"generated kernels {name}: nvcc exit {p.returncode} "
                    f"in {', '.join(units) or 'the kernels'}\n"
                    + p.stdout[-4000:])
            os.replace(tmp, so)
        with open(so + ".log") as fh:
            PTXAS[name] = _gen_ptxas(fh.read())
        GEN_INFO[dig] = dict(nvcc_s=wall, ptxas=PTXAS[name], dir=out_dir)
        lib = ctypes.CDLL(so)
        for fn, at in GEN_ARGTYPES.items():
            f = getattr(lib, fn)
            f.argtypes = at
            f.restype = ctypes.c_int
        _gen_libs[dig] = lib
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
