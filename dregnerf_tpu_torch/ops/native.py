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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# argtypes/restype of each library's C entry points; each takes the stream
# last and returns its first CUDA error
_PTR, _ROWS = ctypes.c_void_p, ctypes.c_longlong
# (idx, src, n_rows, row_count, alt_idx, alt_src, alt_rows, take_alt, out, width, table_rows)
_SCATTER = ([_PTR, _PTR, _ROWS, _PTR, _PTR, _PTR, _ROWS, _PTR, _PTR, ctypes.c_int, _ROWS, _PTR],
            ctypes.c_int)
# (table, idx, out, n_rows, width, table_rows)
_GATHER = ([_PTR, _PTR, _PTR, _ROWS, ctypes.c_int, _ROWS, _PTR], ctypes.c_int)
_SIGNATURES = {
    "scatter_add": {"scatter_add_f32": _SCATTER},
    "scatter_add_bf16": {"scatter_add_bf16": _SCATTER},
    "gather_rows": {"gather_rows_f32": _GATHER},
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


def _entry(name: str, entry: str) -> ctypes._CFuncPtr:
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
    fn = _entry(name, entry)
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
