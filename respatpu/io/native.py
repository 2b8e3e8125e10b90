"""ctypes bindings for the native host library (librespa_host.so).

The first use in a process runs ``make -C respatpu/io/_native``, which
rebuilds the library only when ``host_ops.cpp`` is newer, so the loaded
library is always built from the committed source. Where the build fails
(no C++ toolchain) no library is loaded, not even one left from an earlier
build, and all callers fall back to the pure numpy implementations.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(_HERE, "_native")
_SO_PATH = os.path.join(_NATIVE_DIR, "librespa_host.so")

_lib = None
_lock = threading.Lock()
_build_failed = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)


class _MtxInfo(ctypes.Structure):
    _fields_ = [("nrows", ctypes.c_int64), ("ncols", ctypes.c_int64),
                ("nnz", ctypes.c_int64), ("field", ctypes.c_int32),
                ("symmetry", ctypes.c_int32), ("fmt", ctypes.c_int32),
                ("data_offset", ctypes.c_int64)]


def _build() -> bool:
    # the file lock serialises builds by concurrent processes (test workers)
    # so none loads a library another is still writing
    try:
        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_SO_PATH)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _build():
            _build_failed = True
            return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.mtx_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MtxInfo)]
        lib.mtx_read_header.restype = ctypes.c_int
        lib.mtx_parse_entries.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_int32,
                                          _i32p, _i32p, _f64p, ctypes.c_int32]
        lib.mtx_parse_entries.restype = ctypes.c_int64
        lib.level_schedule.argtypes = [ctypes.c_int64, _i64p, _i32p,
                                       ctypes.c_int32, _i32p]
        lib.level_schedule.restype = ctypes.c_int
        lib.cp_schedule_count.argtypes = [ctypes.c_int64, _i64p, _i32p, _i64p,
                                          _i32p, _i32p, ctypes.c_int32]
        lib.cp_schedule_count.restype = ctypes.c_int64
        lib.cp_schedule_fill.argtypes = [ctypes.c_int64, _i64p, _i32p, _i64p,
                                         _i32p, _i64p, ctypes.c_int64, _i64p,
                                         _i64p, ctypes.c_int32]
        lib.cp_schedule_fill.restype = ctypes.c_int
        lib.entry_levels.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p,
                                     _i64p, _i64p, _i32p, _i32p]
        lib.entry_levels.restype = ctypes.c_int
        lib.symbolic_fill_compute.argtypes = [ctypes.c_int64, _i64p, _i32p]
        lib.symbolic_fill_compute.restype = ctypes.c_int64
        lib.symbolic_fill_sym_compute.argtypes = [ctypes.c_int64, _i64p, _i32p]
        lib.symbolic_fill_sym_compute.restype = ctypes.c_int64
        lib.symbolic_fill_fetch.argtypes = [ctypes.c_int64, _i64p, _i32p]
        lib.symbolic_fill_fetch.restype = ctypes.c_int
        lib.rcm_order.argtypes = [ctypes.c_int64, _i64p, _i32p, _i32p]
        lib.rcm_order.restype = ctypes.c_int
        lib.mindeg_order.argtypes = [ctypes.c_int64, _i64p, _i32p, _i32p,
                                     ctypes.c_int32]
        lib.mindeg_order.restype = ctypes.c_int
        lib.amd_order.argtypes = [ctypes.c_int64, _i64p, _i32p, _i32p,
                                  ctypes.c_double]
        lib.amd_order.restype = ctypes.c_int
        lib.sparse_assignment.argtypes = [ctypes.c_int64, _i64p, _i32p,
                                          _f64p, _i32p]
        lib.sparse_assignment.restype = ctypes.c_int
        lib.nd_order.argtypes = [ctypes.c_int64, _i64p, _i32p, _i32p,
                                 ctypes.c_int32]
        lib.nd_order.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_i64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def mtx_header(path: str):
    lib = _load()
    info = _MtxInfo()
    rc = lib.mtx_read_header(path.encode(), ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"native mtx header parse failed ({rc}) for {path}")
    return info


def mtx_parse(path: str, nthreads: int = 0):
    """Parse coordinate entries -> (info, row, col, val), indices as stored."""
    lib = _load()
    info = mtx_header(path)
    if info.fmt != 0:
        raise ValueError("native parser handles coordinate format only")
    nnz = info.nnz
    if info.field == 3:  # complex typecode (mm_io.h:49-89 parity)
        import warnings
        warnings.warn(
            "complex Matrix Market file: imaginary parts are DROPPED "
            "(real-part load)", UserWarning, stacklevel=2)
    row = np.empty(nnz, dtype=np.int32)
    col = np.empty(nnz, dtype=np.int32)
    val = np.empty(nnz, dtype=np.float64)
    got = lib.mtx_parse_entries(path.encode(), info.data_offset, nnz, info.field,
                                _ptr(row, _i32p), _ptr(col, _i32p),
                                _ptr(val, _f64p), nthreads)
    if got < nnz:
        raise ValueError(f"native mtx parse failed ({got}) for {path}")
    return info, row, col, val


def level_schedule(n: int, indptr: np.ndarray, indices: np.ndarray,
                   lower: bool) -> np.ndarray:
    lib = _load()
    indptr = _as_i64(indptr)
    indices = _as_i32(indices)
    out = np.zeros(n, dtype=np.int32)
    lib.level_schedule(n, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                       1 if lower else 0, _ptr(out, _i32p))
    return out


def cp_schedule(n: int, indptr: np.ndarray, indices: np.ndarray,
                col_ptr: np.ndarray, col_rows: np.ndarray,
                col_pos: np.ndarray, nthreads: int = 0,
                max_pair_bytes: int = 8 << 30):
    """Returns (pairs_a, pairs_b) int64[nnz, t_max] with -1 padding.

    Raises MemoryError (instead of attempting the allocation) when the
    padded pair lists would exceed ``max_pair_bytes`` — deep-fill circuit
    patterns can demand hundreds of GiB here (observed: 149 GiB at
    fill 2.8M x t_max 7152), and a clean refusal lets factorize()'s auto
    chain report instead of thrashing."""
    lib = _load()
    indptr = _as_i64(indptr)
    indices = _as_i32(indices)
    col_ptr = _as_i64(col_ptr)
    col_rows = _as_i32(col_rows)
    col_pos = _as_i64(col_pos)
    nnz = int(indptr[-1])
    tcount = np.zeros(nnz, dtype=np.int32)
    t_max = lib.cp_schedule_count(n, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                                  _ptr(col_ptr, _i64p), _ptr(col_rows, _i32p),
                                  _ptr(tcount, _i32p), nthreads)
    t_max = max(int(t_max), 1)
    need = 2 * nnz * t_max * 8
    if need > max_pair_bytes:
        raise MemoryError(
            f"schedule pair lists would need {need/2**30:.1f} GiB "
            f"(fill nnz={nnz}, t_max={t_max})")
    pairs_a = np.empty((nnz, t_max), dtype=np.int64)
    pairs_b = np.empty((nnz, t_max), dtype=np.int64)
    lib.cp_schedule_fill(n, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                         _ptr(col_ptr, _i64p), _ptr(col_rows, _i32p),
                         _ptr(col_pos, _i64p), t_max,
                         _ptr(pairs_a, _i64p), _ptr(pairs_b, _i64p), nthreads)
    return pairs_a, pairs_b


def entry_levels(pairs_a: np.ndarray, pairs_b: np.ndarray,
                 diag_pos_col: np.ndarray, is_lower: np.ndarray) -> np.ndarray:
    lib = _load()
    nnz, t_max = pairs_a.shape
    pa = _as_i64(pairs_a)
    pb = _as_i64(pairs_b)
    dpc = _as_i64(diag_pos_col)
    low = _as_i32(is_lower.astype(np.int32))
    out = np.zeros(nnz, dtype=np.int32)
    lib.entry_levels(nnz, t_max, _ptr(pa, _i64p), _ptr(pb, _i64p),
                     _ptr(dpc, _i64p), _ptr(low, _i32p), _ptr(out, _i32p))
    return out


def symbolic_fill(n: int, indptr: np.ndarray, indices: np.ndarray,
                  symmetric: bool = False):
    """Returns (fill_indptr int64[n+1], fill_indices int32[fnnz]).

    ``symmetric=True`` selects the near-linear etree-based algorithm
    (valid ONLY for structurally symmetric patterns — the caller must
    check); the default is the general row-merge."""
    lib = _load()
    with _lock:
        indptr = _as_i64(indptr)
        indices = _as_i32(indices)
        fn = (lib.symbolic_fill_sym_compute if symmetric
              else lib.symbolic_fill_compute)
        fnnz = fn(n, _ptr(indptr, _i64p), _ptr(indices, _i32p))
        if fnnz < 0:
            raise RuntimeError("symbolic fill failed")
        if fnnz * 4 > 32 << 30:
            # pre-sized refusal with the budget in the message (never a raw
            # allocator error): downstream numeric phases could not hold a
            # factor this dense anyway
            raise MemoryError(
                f"symbolic fill has {fnnz/1e9:.2f}G entries "
                f"({fnnz * 4 / 2**30:.0f} GiB of indices); the ordering "
                "does not control fill on this pattern")
        out_ptr = np.empty(n + 1, dtype=np.int64)
        out_idx = np.empty(fnnz, dtype=np.int32)
        lib.symbolic_fill_fetch(n, _ptr(out_ptr, _i64p), _ptr(out_idx, _i32p))
    return out_ptr, out_idx


def rcm(n: int, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    lib = _load()
    indptr = _as_i64(indptr)
    indices = _as_i32(indices)
    out = np.empty(n, dtype=np.int32)
    lib.rcm_order(n, _ptr(indptr, _i64p), _ptr(indices, _i32p), _ptr(out, _i32p))
    return out


def mindeg(n: int, indptr: np.ndarray, indices: np.ndarray,
           dense_threshold: int = 0) -> np.ndarray:
    lib = _load()
    indptr = _as_i64(indptr)
    indices = _as_i32(indices)
    out = np.empty(n, dtype=np.int32)
    lib.mindeg_order(n, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                     _ptr(out, _i32p), dense_threshold)
    return out


def sparse_assignment(n: int, indptr: np.ndarray, indices: np.ndarray,
                      cost: np.ndarray) -> Optional[np.ndarray]:
    """Min-cost perfect bipartite matching (MC64 slot). Returns
    ``match[i] = column of row i`` or None when structurally singular."""
    lib = _load()
    indptr = _as_i64(indptr)
    indices = _as_i32(indices)
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    out = np.empty(n, dtype=np.int32)
    rc = lib.sparse_assignment(n, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                               _ptr(cost, _f64p), _ptr(out, _i32p))
    return out if rc == 0 else None


def amd(n: int, indptr: np.ndarray, indices: np.ndarray,
        dense_alpha: float = 10.0) -> np.ndarray:
    """Approximate minimum degree (quotient graph) on a SYMMETRIC pattern."""
    lib = _load()
    indptr = _as_i64(indptr)
    indices = _as_i32(indices)
    out = np.empty(n, dtype=np.int32)
    rc = lib.amd_order(n, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                       _ptr(out, _i32p), ctypes.c_double(dense_alpha))
    if rc != 0:
        raise RuntimeError("amd_order failed (incomplete elimination)")
    return out


def nd(n: int, indptr: np.ndarray, indices: np.ndarray,
       leaf_size: int = 256) -> np.ndarray:
    """Nested dissection (level separators, AMD leaves) on a SYMMETRIC
    pattern — the METIS slot for large 3-D meshes."""
    lib = _load()
    indptr = _as_i64(indptr)
    indices = _as_i32(indices)
    out = np.empty(n, dtype=np.int32)
    rc = lib.nd_order(n, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                      _ptr(out, _i32p), leaf_size)
    if rc != 0:
        raise RuntimeError("nd_order failed (incomplete ordering)")
    return out
