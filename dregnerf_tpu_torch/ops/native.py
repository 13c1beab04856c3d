"""Build and load the port's native libraries (`dregnerf_tpu_torch/csrc/`).

Each CUDA source (`*.cu`) compiles with nvcc for sm_90a, the host C++
source of the classical registration baseline (`fgr.cpp`) with the
system g++ (no `-march=native`: the library runs on whatever host loads
it), into a shared library with a plain C interface, loaded with ctypes.
Libraries go to `dregnerf_tpu_torch/_build/`, named by a hash of the
source and the flags, so a stale build is never loaded. Nothing here runs
at import time; a missing compiler or a failed build raises (there is no
fallback).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

# argtypes/restype of each library's C entry points; each kernel's takes the
# stream last and returns its first CUDA error
_PTR, _ROWS = ctypes.c_void_p, ctypes.c_longlong
# (idx, src, n_rows, row_count, alt_idx, alt_src, alt_rows, take_alt, out, width, table_rows)
_SCATTER = ([_PTR, _PTR, _ROWS, _PTR, _PTR, _PTR, _ROWS, _PTR, _PTR, ctypes.c_int, _ROWS, _PTR],
            ctypes.c_int)
# (table, idx, out, n_rows, width, table_rows)
_GATHER = ([_PTR, _PTR, _PTR, _ROWS, ctypes.c_int, _ROWS, _PTR], ctypes.c_int)
# (x, table or dout, out or grad, n, n_levels, log2_table_size, host scales,
# host resolutions, host dense flags)
_HASH = ([_PTR, _PTR, _PTR, _ROWS, ctypes.c_int, ctypes.c_int, _PTR, _PTR, _PTR, _PTR],
         ctypes.c_int)
_DOUBLES, _INT, _DOUBLE = ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "scatter_add": {"scatter_add_f32": _SCATTER},
    "scatter_add_bf16": {"scatter_add_bf16": _SCATTER},
    "gather_rows": {"gather_rows_f32": _GATHER},
    "hash_grid": {"hash_grid_fwd_f32": _HASH, "hash_grid_bwd_f32": _HASH},
    # host C++ (fgr.cpp); each returns 0 or a negative failure code
    "fgr": {
        # (src, n_src, tgt, n_tgt, voxel, out 4x4)
        "fgr_register": ([_DOUBLES, _INT, _DOUBLES, _INT, _DOUBLE, _DOUBLES], _INT),
        # (src, n_src, tgt, n_tgt, voxel, max_iters, out 4x4)
        "ransac_register": ([_DOUBLES, _INT, _DOUBLES, _INT, _DOUBLE, _INT, _DOUBLES], _INT),
        # (xyz, n, voxel, out n x 33) -> the downsampled point count
        "fpfh_features": ([_DOUBLES, _INT, _DOUBLE, ctypes.POINTER(ctypes.c_float)], _INT),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


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


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the classical registration baseline "
                           "(csrc/fgr.cpp) is built at first use")
    return gxx


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source of library `name` and its compiler's flags."""
    cu = CSRC / f"{name}.cu"
    return (cu, NVCC_FLAGS) if cu.exists() else (CSRC / f"{name}.cpp", CXX_FLAGS)


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    src, flags = _source(name)
    compiler = find_nvcc() if src.suffix == ".cu" else find_gxx()
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish_build(job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(proc.args[0]).name} failed for {so.name}:\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def build_all(names=None) -> float:
    """Compile every source (one compiler each, all started together);
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


def entry_point(name: str, entry: str) -> ctypes._CFuncPtr:
    """C entry point `entry` of library `name`, resolved once."""
    fn = _entries.get((name, entry))
    if fn is None:
        fn = _entries[(name, entry)] = getattr(load_library(name), entry)
    return fn


def launch(name: str, entry: str, device: torch.device, *args, aligned=()) -> None:
    """Call C entry point `entry` of library `name` on the current stream of
    `device`. Each of `args` is a tensor (passed as its data pointer), None
    (a null pointer) or a number; `aligned` holds (tensor, bytes) pairs
    that the kernel reads in vectors of that size. Raises if a tensor is
    misaligned or the launch was refused."""
    for tensor, nbytes in aligned:
        if tensor.data_ptr() % nbytes:
            raise ValueError(f"{entry}: a {tuple(tensor.shape)} {tensor.dtype} tensor is not "
                             f"aligned to {nbytes} bytes")
    fn = entry_point(name, entry)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # which takes longer on the host than the launch itself
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*ptrs, stream)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(index):
            err = fn(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
