"""Host C++ extensions, built at first use with the host compiler and
loaded with ctypes (counterpart of panst3r_tpu/native/__init__.py).

``lap.cpp`` is the exact linear-assignment solver (shortest augmenting
path with dual potentials); ``rasterizer.cpp`` the software z-buffer that
renders depth and instance labels from a labelled mesh for the ScanNet++
preprocessing (``tools/preprocess_scannetpp.py``).  Both are host code,
as in the JAX package.  Each is compiled with ``g++`` into the
git-ignored ``panst3r_torch/_build/`` under a name that carries a hash of
the source, so an edited source is rebuilt.  Without a compiler
``lap_jv`` returns None (``ops/lap.py::exact_lap`` then takes scipy's
solver) and ``rasterize_mesh`` runs ``_rasterize_numpy``.
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
_raster_lib: Optional[ctypes.CDLL] = None
_raster_failed = False


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


def _build_rasterizer() -> Optional[ctypes.CDLL]:
    global _raster_lib, _raster_failed
    if _raster_lib is not None or _raster_failed:
        return _raster_lib
    try:
        lib = _compile(_SRC_DIR / "rasterizer.cpp", "rasterizer")
        lib.rasterize_mesh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        lib.rasterize_mesh.restype = None
        _raster_lib = lib
    except Exception:
        _raster_failed = True
    return _raster_lib


def _rasterize_numpy(verts, faces, face_labels, K, H, W):
    """The rasterizer in numpy, face by face (slow; for a machine with no
    compiler): the same pixel centres, barycentrics, 1/z interpolation and
    depth test as ``rasterizer.cpp``."""
    depth = np.zeros((H, W), np.float32)
    label = np.zeros((H, W), np.int32)
    fx, cx, fy, cy = K[0, 0], K[0, 2], K[1, 1], K[1, 2]
    tri = verts[faces]                                   # (F, 3, 3)
    ok = (tri[..., 2] > 1e-6).all(-1)
    for f in np.nonzero(ok)[0]:
        v = tri[f]
        x = fx * v[:, 0] / v[:, 2] + cx
        y = fy * v[:, 1] / v[:, 2] + cy
        xmin, xmax = int(np.floor(x.min())), int(np.ceil(x.max()))
        ymin, ymax = int(np.floor(y.min())), int(np.ceil(y.max()))
        xmin, xmax = max(xmin, 0), min(xmax, W - 1)
        ymin, ymax = max(ymin, 0), min(ymax, H - 1)
        if xmin > xmax or ymin > ymax:
            continue
        area = (x[1] - x[0]) * (y[2] - y[0]) - (x[2] - x[0]) * (y[1] - y[0])
        if abs(area) < 1e-12:
            continue
        px, py = np.meshgrid(np.arange(xmin, xmax + 1) + 0.5,
                             np.arange(ymin, ymax + 1) + 0.5)
        w0 = ((x[1] - px) * (y[2] - py) - (x[2] - px) * (y[1] - py)) / area
        w1 = ((x[2] - px) * (y[0] - py) - (x[0] - px) * (y[2] - py)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        iz = w0 / v[0, 2] + w1 / v[1, 2] + w2 / v[2, 2]
        zb = np.where(inside, 1.0 / np.maximum(iz, 1e-12), np.inf)
        sub_d = depth[ymin:ymax + 1, xmin:xmax + 1]
        sub_l = label[ymin:ymax + 1, xmin:xmax + 1]
        closer = inside & ((sub_d == 0) | (zb < sub_d))
        sub_d[closer] = zb[closer].astype(np.float32)
        sub_l[closer] = face_labels[f]
    return depth, label


def rasterize_mesh(verts: np.ndarray, faces: np.ndarray,
                   face_labels: np.ndarray, K: np.ndarray,
                   H: int, W: int) -> tuple[np.ndarray, np.ndarray]:
    """Depth (m) and instance-label maps (H, W) of a camera-space mesh:
    verts (N, 3) float32 (OpenCV: +z forward), faces (F, 3) int32,
    face_labels (F,) int32 (0 = background), K (3, 3) intrinsics.  0
    where no face covers a pixel.  Runs ``rasterizer.cpp`` (no culling,
    no anti-aliasing, perspective-correct depth), or ``_rasterize_numpy``
    where no compiler is there."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    face_labels = np.ascontiguousarray(face_labels, np.int32)
    Kf = np.ascontiguousarray(K, np.float32)
    lib = _build_rasterizer()
    if lib is None:
        return _rasterize_numpy(verts, faces, face_labels, Kf, H, W)
    depth = np.zeros(H * W, np.float32)
    label = np.zeros(H * W, np.int32)
    lib.rasterize_mesh(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(verts)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(faces)),
        face_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        Kf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int32(H), ctypes.c_int32(W),
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        label.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return depth.reshape(H, W), label.reshape(H, W)
