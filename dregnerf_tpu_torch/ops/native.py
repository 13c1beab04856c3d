"""Build and load the port's CUDA kernels (`dregnerf_tpu_torch/csrc/*.cu`).

Each source compiles with nvcc for sm_90a into a shared library with a
plain C interface, loaded with ctypes. Libraries go to
`dregnerf_tpu_torch/_build/`, named by a hash of the source and the flags,
so a stale build is never loaded. Nothing here runs at import time; a
missing nvcc raises (there is no fallback on CUDA tensors).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# argtypes/restype of each library's C entry points
_SIGNATURES = {
    "scatter_add": {
        "scatter_add_f32": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of dregnerf_tpu_torch are built at first use")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish_build(job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {so.name}:\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def build_all(names=None) -> float:
    """Compile every kernel source (one nvcc each, all started together);
    returns the seconds it took."""
    t0 = time.perf_counter()
    names = sorted(_SIGNATURES) if names is None else names
    jobs = [job for job in map(_start_build, names) if job is not None]
    errors = []
    for job in jobs:  # wait for every nvcc, even after one fails
        try:
            _finish_build(job)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The compiled library `name` (built on first use), with its C
    signatures declared."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
