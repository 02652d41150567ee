"""Build the CUDA kernels of ``panst3r_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``panst3r_torch/_build/`` (ignored by git) under a name
that carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  ``build()`` starts one ``nvcc``
per source, all at once, and waits for them together.

Nothing here is imported by a module at import time: the wrappers call
``load`` inside the function that launches a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("tower_self_sm90", "tower_cross_sm90",
                  "tower_cross_int8_sm90", "masked_attn_sm90",
                  "flash_fwd_bf16_sm90", "flash_fwd_sm90",
                  "flash_bwd_bf16_sm90", "flash_bwd_sm90",
                  "packed_flash_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every missing library among ``names`` in parallel.
    Returns {name: nvcc's messages} (register and shared-memory use from
    ``-Xptxas -v``) for the sources built in this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        (BUILD_DIR / f"{name}.log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.p3_error_string.argtypes = [ctypes.c_int]
        lib.p3_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(name: str, fn: str, argtypes: list):
    """(library, its C entry ``fn`` with ``argtypes`` set, returning int)."""
    lib = load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib, f


def check_tensor(t, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels index raw pointers with these strides."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a launch's error code, or on a launch whose FLOPs no
    wrapper declared to an open counter (``ops/flops.py``)."""
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err}: {lib.p3_error_string(err).decode()}")
    from panst3r_torch.ops import flops

    flops.check_declared(what)


def ptr(t) -> ctypes.c_void_p | None:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
