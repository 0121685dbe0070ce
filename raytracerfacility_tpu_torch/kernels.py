"""Build, load and count the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface and are compiled by
``nvcc`` at first use into ``build/rtf_torch/`` at the repository root
(route (b): no PyTorch headers, a few seconds to build), then loaded with
``ctypes``. The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt. Nothing here runs at import time,
so the CPU-only tests can import every module.

Flags: ``-fmad=false`` keeps ``a*b+c`` as a rounded multiply and a rounded
add, as the plain PyTorch versions and the JAX reference compute it (an
FMA changes the rounding of the intersection's det, u, v and t and flips
grazing accepts); no ``--use_fast_math``, so division and ``sqrtf`` stay
IEEE and ``sinf``/``cosf`` stay the accurate library versions.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("path_common.cuh", "path.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "rtf_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# threads per block of both kernels (csrc/path.cu reads the same number)
THREADS = 128

LAUNCHES = {"seg_segment_kernel": 0, "fused_path_kernel": 0}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def blocks_for(n: int) -> int:
    return (n + THREADS - 1) // THREADS


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"librtf_torch_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels unless the library for these sources exists.
    Returns {"path", "seconds", "log"}; ``log`` holds nvcc's register and
    spill report. Raises if nvcc fails."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / "path.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rtf_seg_segment.restype = ci
        lib.rtf_seg_segment.argtypes = [vp] * 8 + [ci] * 7 + [vp]
        lib.rtf_fused_path.restype = ci
        lib.rtf_fused_path.argtypes = [vp] * 9 + [ci] * 5 + [vp]
        lib.rtf_error_string.restype = ctypes.c_char_p
        lib.rtf_error_string.argtypes = [ci]
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library().rtf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
