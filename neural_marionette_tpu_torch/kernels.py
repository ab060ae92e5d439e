"""Build and load the hand-written CUDA kernels of ``csrc/`` and the host
data library.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on first use into its own
shared library with a plain C interface, loaded through ``ctypes``; the
host libraries ``csrc/nm_host.cpp`` and ``csrc/nm_webp.cpp``
(``data/native.py``) are compiled the same way by ``g++``. The libraries land in ``_build/`` beside this file
(git-ignored), under a name that carries a hash of the source and the
flags, so an edited source is rebuilt and a stale one is never loaded. All
sources build in parallel, one compiler process each.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("voxelize", "chamfer", "conv3d", "groupnorm")
HOST_SOURCES = ("nm_host", "nm_webp")   # csrc/<name>.cpp, built by g++

# No --use_fast_math: the voxelizer depends on true IEEE division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points of each library: argument types (every one returns int)
_SIGNATURES = {
    "voxelize": {
        "nm_voxelize": [_P, _P, _I, ctypes.c_longlong, _I, _I,
                        ctypes.c_float, _I, _P],
    },
    "chamfer": {
        "nm_chamfer_tile_voxels": [],
        "nm_chamfer_max_k": [],
        "nm_chamfer_fwd": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P],
        "nm_chamfer_bwd": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _P],
    },
    "conv3d": {
        "nm_conv3d_chunk": [],
        "nm_conv3d_brick_z": [_I],
        "nm_conv3d_brick_x": [_I],
        "nm_conv3d": [_P, _P, _P, _P, _I, _P] + [_I] * 7 + [_L] * 10
                     + [_I, _I, _I, _P],
    },
    "groupnorm": {
        "nm_groupnorm_act": [_P, _I, _P, _P, _P, _P, _P] + [_I] * 5
                            + [_L] * 10 + [_I, _P],
    },
    # the host libraries' signatures live in data/native.py
    "nm_host": {},
    "nm_webp": {},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source file of ``name`` and its compiler's flags."""
    if name in HOST_SOURCES:
        return CSRC / f"{name}.cpp", GXX_FLAGS
    return CSRC / f"{name}.cu", NVCC_FLAGS


def _compiler(name: str) -> str:
    if name not in HOST_SOURCES:
        return _nvcc()
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host data library cannot be "
                           "built")
    return found


def _lib_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES + HOST_SOURCES) -> dict[str, dict]:
    """Compile every missing library of ``names`` in parallel.

    Returns ``{name: {"seconds": wall time of its compiler, "log": the
    compiler's output (nvcc's -Xptxas -v register and shared-memory
    lines)}}`` for the sources compiled by this call. Raises if any
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        src, flags = _source(name)
        compiler = _compiler(name)
        fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *flags, "-o", tmp, str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    results, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: {Path(proc.args[0]).name} exited "
                          f"{proc.returncode}\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build((name,))
    lib = ctypes.CDLL(str(path))
    if name not in HOST_SOURCES:
        lib.nm_error_string.argtypes = [ctypes.c_int]
        lib.nm_error_string.restype = ctypes.c_char_p
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.nm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
