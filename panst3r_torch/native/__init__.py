"""Host C++ extensions, built at first use with the host compiler and
loaded with ctypes (counterpart of panst3r_tpu/native/__init__.py).

``lap.cpp`` is the exact linear-assignment solver (shortest augmenting
path with dual potentials).  It is compiled with ``g++`` into the
git-ignored ``panst3r_torch/_build/`` under a name that carries a hash of
the source, so an edited source is rebuilt; ``lap_jv`` returns None when
no compiler is there, and ``ops/lap.py::exact_lap`` then takes scipy's
solver.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parent / "_build"
_lap_lib: Optional[ctypes.CDLL] = None
_lap_failed = False


def _compile(src: Path, stem: str) -> ctypes.CDLL:
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}-{tag}.so"
    if not out.exists():
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, "-O3", "-shared", "-fPIC", str(src), "-o",
                        str(tmp)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)        # atomic: concurrent builds agree
    return ctypes.CDLL(str(out))


def _build_lap() -> Optional[ctypes.CDLL]:
    global _lap_lib, _lap_failed
    if _lap_lib is not None or _lap_failed:
        return _lap_lib
    try:
        lib = _compile(_SRC_DIR / "lap.cpp", "lap")
        lib.solve_lap.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.solve_lap.restype = ctypes.c_int
        _lap_lib = lib
    except Exception:
        _lap_failed = True
    return _lap_lib


def lap_jv(cost: np.ndarray) -> Optional[tuple]:
    """Exact min-cost assignment of the dense (R, C) ``cost``: (row_ind,
    col_ind) int64 over min(R, C) pairs, row_ind ascending (scipy's
    ``linear_sum_assignment`` surface), or None when the library cannot be
    built.  NaN costs raise; an infeasible problem (inf) raises."""
    lib = _build_lap()
    if lib is None:
        return None
    cost = np.ascontiguousarray(cost, np.float64)
    if np.isnan(cost).any():
        raise ValueError("matrix contains invalid numeric entries")
    R, C = cost.shape
    transpose = R > C
    if transpose:
        cost = np.ascontiguousarray(cost.T)
    nr, nc = cost.shape
    out = np.empty(nr, np.int64)
    rc = lib.solve_lap(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(nr), ctypes.c_int64(nc),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise ValueError("cost matrix is infeasible")
    if transpose:
        rows, cols = out, np.arange(nr, dtype=np.int64)
        order = np.argsort(rows)
        return rows[order], cols[order]
    return np.arange(nr, dtype=np.int64), out
