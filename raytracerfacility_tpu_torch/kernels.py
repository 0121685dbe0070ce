"""Build, load and count the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. Each ``.cu`` file is
compiled by its own ``nvcc`` at first use into a shared library in
``build/rtf_torch/`` at the repository root (route (b): no PyTorch
headers, a few seconds each), all of them started together, then loaded
with ``ctypes``. A library's file name carries a hash of the flags and of
every file under ``csrc/`` (names and bytes), so an edited source or
header is rebuilt. Nothing here runs at import
time, so the CPU-only tests can import every module.

Flags: ``-fmad=false`` keeps ``a*b+c`` as a rounded multiply and a rounded
add, as the plain PyTorch versions and the JAX reference compute it (an
FMA changes the rounding of the intersection's det, u, v and t and flips
grazing accepts); no ``--use_fast_math``, so division and ``sqrtf`` stay
IEEE and the double ``sin``/``cos`` stay the accurate library versions.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel (``miss_radiance_kernel`` counts both of its
modes, ``miss_radiance_kernel<cubemap>`` the cubemap's alone).
``MISSED_RAYS`` holds, for each device, the running count of the rays the
miss hook found missed (``ops/environment.py::missed_rays``): a tensor on
that device, so the count costs the timed path no host read.
``CURVE_HITS`` holds, for each device, the running count of the closest
hits on curve rows that the wavefront engine shaded
(``models/pathtracer.py::curve_hits``), kept the same way.
``reset_launches`` clears all three.
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
# library name -> source file
SOURCES = {"path": "path.cu", "brute": "brute.cu", "inst": "inst.cu",
           "bvh": "bvh.cu", "perm": "perm.cu", "env": "env.cu", "btf": "btf.cu",
           "rng": "rng.cu", "probe": "probe.cu"}
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "rtf_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# threads per block of every ray kernel (csrc/path_common.cuh kThreads)
THREADS = 128

LAUNCHES = {"seg_segment_kernel": 0, "seg_segment_kernel<miss>": 0,
            "fused_path_kernel": 0,
            "fused_sls_kernel": 0, "brute_trace_kernel<false>": 0,
            "brute_trace_kernel<true>": 0, "inst_trace_kernel": 0,
            "bvh_trace_kernel<false>": 0, "bvh_trace_kernel<true>": 0,
            "block_perm_kernel": 0, "miss_compact_kernel": 0,
            "miss_radiance_kernel": 0, "miss_radiance_kernel<cubemap>": 0,
            "btf_decode_kernel": 0,
            "tea_init_kernel": 0, "reorder_key_kernel": 0,
            "reorder_gather_kernel": 0, "probe_ray_kernel": 0}

# device -> (2,) int64 tensor on it: the missed rays whose light the hook
# did not and did write out (ops/environment.py::missed_rays)
MISSED_RAYS: dict = {}
# device -> () int64 tensor on it: closest hits on curve rows
# (models/pathtracer.py::curve_hits)
CURVE_HITS: dict = {}

_libs: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for tally in (*MISSED_RAYS.values(), *CURVE_HITS.values()):
        tally.zero_()


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


def library_path(name: str) -> pathlib.Path:
    """The library file of ``name``: its name hashes the flags and every
    file under ``csrc/``, so a header that no hash named cannot go stale."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in _CSRC.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"librtf_{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every library whose file does not exist yet, one ``nvcc``
    per source, all started together. Returns {"seconds", "log", "paths"};
    ``log`` holds nvcc's register and spill report. Raises if any nvcc
    fails."""
    todo = {name: library_path(name) for name in SOURCES
            if not library_path(name).exists()}
    paths = {name: str(library_path(name)) for name in SOURCES}
    if not todo:
        return {"seconds": 0.0, "log": "", "paths": paths}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    logs, failed = [], []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate(timeout=600)
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "log": "".join(logs),
            "paths": paths}


_ARGTYPES = {
    "path": {"rtf_seg_segment": (11, 7), "rtf_fused_path": (11, 5),
             "rtf_fused_sls": (11, 4)},
    "brute": {"rtf_brute_trace": (14, 5)},
    "inst": {"rtf_inst_trace": (21, 5)},
    "bvh": {"rtf_bvh_trace": (13, 4)},
    "perm": {"rtf_block_perm": (7, 3), "rtf_reorder_key": (5, 2),
             "rtf_reorder_gather": (9, 5)},
    "env": {"rtf_miss_compact": (4, 1), "rtf_miss_radiance": (7, 9)},
    "btf": {"rtf_btf_decode": (13, 2)},
    "rng": {"rtf_tea_init": (3, 2)},
    "probe": {"rtf_probe_rays": (10, 5)},
}


def library(name: str = "path") -> ctypes.CDLL:
    """The loaded kernel library ``name`` (every library is built on first
    use)."""
    if name not in _libs:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn, (pointers, ints) in _ARGTYPES[name].items():
            getattr(lib, fn).restype = ci
            getattr(lib, fn).argtypes = [vp] * pointers + [ci] * ints + [vp]
        lib.rtf_error_string.restype = ctypes.c_char_p
        lib.rtf_error_string.argtypes = [ci]
        _libs[name] = lib
    return _libs[name]


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library().rtf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
