"""Native host parser (C++ through ctypes, built on first use).

Port of the part of ``raytracerfacility_tpu/native`` that the port uses:
the BTF text-database number parser (``parse_numeric_file``, ref
CompressedBTF.cpp:7-56). ``g++`` compiles ``src/rtf_native.cpp`` into
``build/rtf_native/`` at the repository root (git-ignored), under an
exclusive ``fcntl.flock`` on a lock file there: two processes that built
at once would otherwise load a half-written library ("file too short").
The library's file name carries a hash of its source, so an edited source
is rebuilt. Without a compiler the numpy fallback parses the same files.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "src" / "rtf_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "rtf_native"

_lib = None
_tried = False


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librtf_native_{digest}.so"


def build() -> str | None:
    """Compile the shared library unless it exists. Returns its path, or
    None when ``g++`` is missing or fails."""
    path = library_path()
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not path.exists():
                    tmp = path.with_suffix(f".{os.getpid()}.tmp")
                    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared",
                                    str(_SRC), "-o", str(tmp)],
                                   check=True, capture_output=True, timeout=120)
                    os.replace(tmp, path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    except (OSError, subprocess.SubprocessError):
        return None
    return str(path)


def get_lib():
    """The loaded library (built if needed), or None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rtf_parse_doubles.restype = ctypes.c_longlong
    lib.rtf_parse_doubles.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_longlong]
    lib.rtf_parse_header.restype = ctypes.c_int
    lib.rtf_parse_header.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_longlong),
                                     ctypes.POINTER(ctypes.c_longlong)]
    _lib = lib
    return _lib


def parse_numeric_file_numpy(path: str, dtype=np.float32):
    """The numpy fallback of :func:`parse_numeric_file`."""
    with open(path) as f:
        tokens = f.read().split()
    rows, cols = int(tokens[0]), int(tokens[1])
    return rows, cols, np.asarray(tokens[4:4 + rows * cols], dtype=dtype)


def parse_numeric_file(path: str, dtype=np.float32):
    """Parse a BTF array file ("rows cols min max" then rows * cols
    values): returns (rows, cols, flat values)."""
    lib = get_lib()
    if lib is None:
        return parse_numeric_file_numpy(path, dtype)
    rows = ctypes.c_longlong()
    cols = ctypes.c_longlong()
    if lib.rtf_parse_header(path.encode(), ctypes.byref(rows), ctypes.byref(cols)):
        raise IOError(f"cannot read header of {path}")
    n = rows.value * cols.value
    buf = np.empty(n + 4, np.float64)
    got = lib.rtf_parse_doubles(path.encode(), buf.ctypes.data_as(ctypes.c_void_p),
                                n + 4)
    if got < n + 4:
        raise IOError(f"{path}: expected {n + 4} values, parsed {got}")
    values = buf[4:4 + n]
    if np.issubdtype(np.dtype(dtype), np.integer):
        values = np.rint(values).astype(dtype)
    else:
        values = values.astype(dtype)
    return rows.value, cols.value, values
