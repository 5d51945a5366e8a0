"""ctypes bindings for the native host library (csrc/hpccg_host.cpp).

Builds libhpccg_host.so on demand with g++ (cached next to the source) and
exposes the host-bound fast paths: file tokenization, ELL stencil assembly,
and HPC-row serialization. Every entry point has a pure-Python/NumPy fallback
in the callers, so the framework works even without a compiler; the native
path is the production data-loading tier (the role of the reference's C++
host code: read_HPC_row.cpp, generate_matrix.cpp).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SO = os.path.join(_SRC, "build", "libhpccg_host.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _compile(src_path: str) -> None:
    # no -march=native: the checkout (and any .so built in it) may move to a
    # host with another CPU, where native instructions would fault
    subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", src_path, "-o", _SO],
        check=True, capture_output=True, timeout=120,
    )


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    src_path = os.path.join(_SRC, "hpccg_host.cpp")
    if not os.path.exists(src_path):
        _build_failed = True
        return None
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(src_path):
        try:
            _compile(src_path)
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
    try:
        return _bind(ctypes.CDLL(_SO))
    except (OSError, AttributeError):
        # a stale or foreign prebuilt .so (e.g. extracted with preserved
        # mtimes, or missing newer symbols): force one rebuild, then give up
        # cleanly
        try:
            os.remove(_SO)
            _compile(src_path)
            return _bind(ctypes.CDLL(_SO))
        except (OSError, AttributeError, subprocess.SubprocessError):
            _build_failed = True
            return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.hpccg_tokenize_file.restype = ctypes.c_int64
    lib.hpccg_tokenize_file.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    lib.hpccg_tokenize_range.restype = ctypes.c_int64
    lib.hpccg_tokenize_range.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    lib.hpccg_tokenize_range_at.restype = ctypes.c_int64
    lib.hpccg_tokenize_range_at.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hpccg_scan_block.restype = ctypes.c_int32
    lib.hpccg_scan_block.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hpccg_generate_ell.restype = ctypes.c_int64
    lib.hpccg_generate_ell.argtypes = [
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.hpccg_rcm.restype = ctypes.c_int32
    lib.hpccg_rcm.argtypes = [
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hpccg_write_hpc_row.restype = ctypes.c_int32
    lib.hpccg_write_hpc_row.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                _lib = _build()
    return _lib


def available() -> bool:
    return _get() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def tokenize_file(path: str) -> Optional[np.ndarray]:
    """All numeric tokens of a text file as float64, or None if unavailable."""
    lib = _get()
    if lib is None:
        return None
    n = lib.hpccg_tokenize_file(path.encode(), None, 0)
    if n < 0:
        raise IOError(f"cannot read {path}")
    out = np.empty(n, np.float64)
    got = lib.hpccg_tokenize_file(path.encode(), _ptr(out, ctypes.c_double), n)
    return out[:got]


def tokenize_range(path: str, skip: int, count: int) -> Optional[np.ndarray]:
    """Tokens [skip, skip+count) of a text file as float64, streamed through
    a fixed 1 MiB window (bounded memory regardless of file size), or None
    if the native library is unavailable. Shorter-than-count results mean
    the file ended."""
    lib = _get()
    if lib is None:
        return None
    out = np.empty(max(count, 0), np.float64)
    got = lib.hpccg_tokenize_range(
        path.encode(), skip, _ptr(out, ctypes.c_double), count
    )
    if got < 0:
        raise IOError(f"cannot stream {path} (rc={got})")
    return out[:got]


def tokenize_range_at(path: str, start_byte: int, skip: int, count: int):
    """Chained-cursor range tokenizer: parse from an absolute byte offset,
    skip ``skip`` tokens, return (tokens[:got], end_byte) where end_byte is
    the offset just past the last consumed token — pass it back as the next
    call's start_byte for one-forward-pass section streaming. Returns None
    if the native library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    out = np.empty(max(count, 0), np.float64)
    end = ctypes.c_int64(start_byte)
    got = lib.hpccg_tokenize_range_at(
        path.encode(), start_byte, skip, _ptr(out, ctypes.c_double), count,
        ctypes.byref(end),
    )
    if got < 0:
        raise IOError(f"cannot stream {path} (rc={got})")
    return out[:got], int(end.value)


def scan_block(path: str, start_row: int, block_rows: int):
    """Streaming scan of an HPC-row file's header + counts: returns
    (total_nrow, total_nnz, prefix_nnz, block_nnz, block_max_count,
    global_max_count, block_counts[int64]) touching O(1 MiB) memory, or
    None if the native library is unavailable. Raises on IO errors /
    malformed headers."""
    lib = _get()
    if lib is None:
        return None
    hdr = np.zeros(6, np.int64)
    counts = np.zeros(max(block_rows, 1), np.int64)
    rc = lib.hpccg_scan_block(
        path.encode(), start_row, block_rows,
        _ptr(hdr, ctypes.c_int64), _ptr(counts, ctypes.c_int64),
    )
    if rc == -1:
        raise IOError(f"cannot read {path}")
    if rc != 0:
        raise ValueError(f"{path}: malformed HPC-row header/counts (rc={rc})")
    return (
        int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[3]), int(hdr[4]),
        int(hdr[5]), counts[:block_rows],
    )


def generate_ell_host(nx, ny, nz, rank=0, size=1, seven_pt=False):
    """Native ELL stencil assembly. Returns (vals, cols, valid, b, nnz) numpy
    arrays in the padded-ELL layout, or None if the library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    n = nx * ny * nz
    width = 7 if seven_pt else 27
    vals = np.zeros((n, width), np.float64)
    cols = np.zeros((n, width), np.int32)
    valid = np.zeros((n, width), np.uint8)
    b = np.zeros(n, np.float64)
    nnz = lib.hpccg_generate_ell(
        nx,
        ny,
        nz,
        rank,
        size,
        int(seven_pt),
        _ptr(vals, ctypes.c_double),
        _ptr(cols, ctypes.c_int32),
        _ptr(valid, ctypes.c_uint8),
        _ptr(b, ctypes.c_double),
    )
    return vals, cols, valid.astype(bool), b, int(nnz)


def write_hpc_row_native(path, vals, cols, valid, x, b, xexact) -> bool:
    """Native HPC-row writer. Returns False if the library is unavailable."""
    lib = _get()
    if lib is None:
        return False
    vals = np.ascontiguousarray(vals, np.float64)
    cols = np.ascontiguousarray(cols, np.int32)
    valid = np.ascontiguousarray(valid, np.uint8)
    x = np.ascontiguousarray(x, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    xexact = np.ascontiguousarray(xexact, np.float64)
    rc = lib.hpccg_write_hpc_row(
        path.encode(),
        vals.shape[0],
        vals.shape[1],
        _ptr(vals, ctypes.c_double),
        _ptr(cols, ctypes.c_int32),
        _ptr(valid, ctypes.c_uint8),
        _ptr(x, ctypes.c_double),
        _ptr(b, ctypes.c_double),
        _ptr(xexact, ctypes.c_double),
    )
    return rc == 0


def rcm(n: int, rows: np.ndarray, cols: np.ndarray) -> Optional[np.ndarray]:
    """Native reverse Cuthill-McKee over the symmetric union of (rows, cols)
    edges. Returns the permutation (new row i = old row perm[i]), or None if
    the library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    perm = np.empty(n, np.int64)
    rc = lib.hpccg_rcm(
        n, len(rows), _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        _ptr(perm, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError("hpccg_rcm: bad input (indices out of range)")
    return perm
