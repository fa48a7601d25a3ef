"""Native host runtime: C++ inspector kernels bound via ctypes.

The device numeric path is XLA; the pointer-chasing *inspector* work
(plan geometry, level scheduling, symbolic SpGEMM, Matrix Market IO)
runs on host and is implemented natively (src/spblas_host.cpp), matching
the reference's division where all algorithms are native C++ headers.

The library self-builds on first import (one g++ invocation, cached next
to the source); every entry point has a numpy fallback so a missing
toolchain degrades gracefully rather than failing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "spblas_host.cpp")
_SRC2 = os.path.join(_HERE, "src", "sort_util.cpp")
_LIB = os.path.join(_HERE, "libspblas_host.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", _SRC, _SRC2, "-o", _LIB,
           "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # missing toolchain → numpy fallbacks
        print(f"spblas_tpu.native: build failed ({e}); using numpy "
              "fallbacks", file=sys.stderr)
        return False


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        # a deployment may ship the built .so without the sources:
        # treat missing sources as "no rebuild needed" instead of
        # raising from getmtime (graceful-degradation contract)
        src_mtime = max((os.path.getmtime(s)
                         for s in (_SRC, _SRC2)
                         if os.path.exists(s)), default=0.0)
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < src_mtime:
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            _declare(lib)
        except OSError as e:
            print(f"spblas_tpu.native: load failed ({e}); using numpy "
                  "fallbacks", file=sys.stderr)
            _build_failed = True
            return None
        _lib = lib
    return _lib


def _declare(lib):
    i64, i32p, i64p, u8p, f64p, charp = (
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_char_p)
    lib.spblas_ell_build.restype = i64
    lib.spblas_ell_build.argtypes = [i64, i64, i64, i64p, i32p, i64,
                                     i32p, i32p, u8p]
    lib.spblas_level_schedule.restype = i64
    lib.spblas_level_schedule.argtypes = [i64, i64, i64p, i32p,
                                          ctypes.c_int32, ctypes.c_int32,
                                          i32p, i64p]
    lib.spblas_transpose_plan.restype = None
    lib.spblas_transpose_plan.argtypes = [i64, i64, i64, i64p, i32p,
                                          i64p, i64p, i32p]
    lib.spblas_spgemm_symbolic.restype = i64
    lib.spblas_spgemm_symbolic.argtypes = [i64, i64, i64, i64, i64p, i32p,
                                           i64p, i32p, i64p]
    lib.spblas_mm_read.restype = i64
    lib.spblas_mm_read.argtypes = [charp, i64, i64p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.spblas_coo_to_csr.restype = None
    lib.spblas_coo_to_csr.argtypes = [i64, i64, i32p, i32p, f64p, i64p]
    lib.spblas_argsort_i64.restype = i64
    lib.spblas_argsort_i64.argtypes = [i64, i64p, i32p, i64p]


# ------------------------------------------------------------------ #
# public wrappers (native fast path + numpy fallback)
# ------------------------------------------------------------------ #

def ell_geometry(m, m_pad, nnz, rowptr, colind, width=0):
    """(gather, cols, valid, w): padded-row plan arrays.

    rowptr int64[m+1], colind int32[*]; width 0 derives max row length.
    """
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int32)
    lib = get_lib()
    if lib is not None:
        dummy = np.zeros(1, np.int32)
        w = width or int(lib.spblas_ell_build(
            m, m_pad, nnz, rowptr, colind, 0, dummy, dummy,
            np.zeros(1, np.uint8)))
        gather = np.zeros((m_pad, w), np.int32)
        cols = np.zeros((m_pad, w), np.int32)
        valid = np.zeros((m_pad, w), np.uint8)
        lib.spblas_ell_build(m, m_pad, nnz, rowptr, colind, w,
                             gather.reshape(-1), cols.reshape(-1),
                             valid.reshape(-1))
        return gather, cols, valid.astype(bool), w
    # numpy fallback (vectorized over the width axis)
    lo = np.minimum(rowptr[:-1], nnz)
    hi = np.minimum(rowptr[1:], nnz)
    lengths = hi - lo
    w = width or max(int(lengths.max()) if m else 0, 1)
    gather = np.zeros((m_pad, w), np.int64)
    gather[:m] = lo[:, None] + np.arange(w)[None, :]
    valid = np.zeros((m_pad, w), bool)
    valid[:m] = np.arange(w)[None, :] < lengths[:, None]
    gather = np.where(valid, gather, 0)
    if nnz and len(colind):
        cols = np.where(valid,
                        colind[np.minimum(gather, max(nnz - 1, 0))], 0)
    else:
        # np.where evaluates both branches: an empty colind would
        # IndexError even though valid is all-False
        cols = np.zeros_like(gather)
    return gather.astype(np.int32), cols.astype(np.int32), valid, w


def level_schedule(m, nnz, rowptr, colind, lower: bool, unit: bool):
    """(levels int32[m], diag int64[m], num_levels).

    Raises ValueError when an explicit-diagonal row lacks its diagonal
    (parity with the reference's divide-by-missing-diagonal contract).
    """
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int32)
    lib = get_lib()
    if lib is not None:
        levels = np.zeros(m, np.int32)
        diag = np.full(m, -1, np.int64)
        nl = int(lib.spblas_level_schedule(
            m, nnz, rowptr, colind, int(lower), int(unit), levels, diag))
        if nl < 0:
            raise ValueError(
                "explicit-diagonal solve but a row has no diagonal entry")
        return levels, diag, nl
    levels = np.zeros(m, np.int64)
    diag = np.full(m, -1, np.int64)
    order = range(m) if lower else range(m - 1, -1, -1)
    for i in order:
        lo, hi = rowptr[i], min(rowptr[i + 1], nnz)
        cols_i = colind[lo:hi]
        d = np.nonzero(cols_i == i)[0]
        if unit:
            pass  # unit diagonal: entries are not read, keep diag = -1
        elif d.size:
            diag[i] = lo + d[0]
        else:
            raise ValueError(
                "explicit-diagonal solve but a row has no diagonal entry")
        dep = cols_i[cols_i < i] if lower else cols_i[cols_i > i]
        levels[i] = 1 + levels[dep].max() if dep.size else 0
    nl = int(levels.max()) + 1 if m else 0
    return levels.astype(np.int32), diag, nl


def transpose_plan(m, n, nnz, rowptr, colind):
    """(t_rowptr int64[n+1], perm int64[nnz], t_colind int32[nnz])."""
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int32)
    lib = get_lib()
    if lib is not None:
        t_rowptr = np.zeros(n + 1, np.int64)
        perm = np.zeros(max(nnz, 1), np.int64)
        t_colind = np.zeros(max(nnz, 1), np.int32)
        lib.spblas_transpose_plan(m, n, nnz, rowptr, colind, t_rowptr,
                                  perm, t_colind)
        return t_rowptr, perm[:nnz], t_colind[:nnz]
    rows = np.repeat(np.arange(m),
                     np.minimum(rowptr[1:], nnz) -
                     np.minimum(rowptr[:-1], nnz))
    cols = colind[:nnz]
    perm = np.lexsort((rows, cols))
    t_rowptr = np.zeros(n + 1, np.int64)
    np.add.at(t_rowptr[1:], cols, 1)
    return np.cumsum(t_rowptr), perm.astype(np.int64), \
        rows[perm].astype(np.int32)


def spgemm_symbolic(m, n, nnz_a, nnz_b, a_rowptr, a_colind, b_rowptr,
                    b_colind):
    """(c_rowptr int64[m+1], total_nnz) — host Gustavson symbolic."""
    a_rowptr = np.ascontiguousarray(a_rowptr, dtype=np.int64)
    a_colind = np.ascontiguousarray(a_colind, dtype=np.int32)
    b_rowptr = np.ascontiguousarray(b_rowptr, dtype=np.int64)
    b_colind = np.ascontiguousarray(b_colind, dtype=np.int32)
    lib = get_lib()
    c_rowptr = np.zeros(m + 1, np.int64)
    if lib is not None:
        total = int(lib.spblas_spgemm_symbolic(
            m, n, nnz_a, nnz_b, a_rowptr, a_colind, b_rowptr, b_colind,
            c_rowptr))
        return c_rowptr, total
    for i in range(m):
        ks = a_colind[a_rowptr[i]: min(a_rowptr[i + 1], nnz_a)]
        cols = [b_colind[b_rowptr[k]: min(b_rowptr[k + 1], nnz_b)]
                for k in ks]
        u = np.unique(np.concatenate(cols)) if cols else np.zeros(0)
        c_rowptr[i + 1] = c_rowptr[i] + len(u)
    return c_rowptr, int(c_rowptr[m])


def mm_read(path: str):
    """Matrix Market coordinate file → (rows, cols, vals, shape).

    Symmetric/skew storage is expanded; duplicates preserved (caller
    coalesces via COO→CSR).  Native parser with a pure-python fallback.
    """
    lib = get_lib()
    if lib is not None:
        shape = np.zeros(2, np.int64)
        n = int(lib.spblas_mm_read(path.encode(), 0, shape,
                                   None, None, None))
        if n == -6:
            raise ValueError(
                f"mm_read({path}): complex Matrix Market files are not "
                "supported")
        if n < 0:
            raise ValueError(f"mm_read({path}) failed with code {n}")
        rows = np.zeros(max(n, 1), np.int32)
        cols = np.zeros(max(n, 1), np.int32)
        vals = np.zeros(max(n, 1), np.float64)
        # the fill pass is bounded by the count pass's capacity: a file
        # that changed between the two calls returns -7 instead of
        # overrunning the buffers
        n2 = int(lib.spblas_mm_read(
            path.encode(), n, shape,
            rows.ctypes.data_as(ctypes.c_void_p),
            cols.ctypes.data_as(ctypes.c_void_p),
            vals.ctypes.data_as(ctypes.c_void_p)))
        if n2 < 0:
            raise ValueError(f"mm_read({path}) failed with code {n2}")
        return rows[:n2], cols[:n2], vals[:n2], (int(shape[0]),
                                                 int(shape[1]))
    return _mm_read_py(path)


def _mm_read_py(path: str, complex_ok: bool = False):
    with open(path) as f:
        # the MM banner is case-insensitive per the spec
        header = f.readline().lower()
        if "coordinate" not in header:
            raise ValueError("only coordinate Matrix Market supported")
        is_cx = "complex" in header
        if is_cx and not complex_ok:
            raise ValueError(
                "complex Matrix Market files are not supported")
        pattern = "pattern" in header
        skew = "skew-symmetric" in header
        hermitian = "hermitian" in header
        symmetric = ("symmetric" in header or skew or hermitian)
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, nz = (int(t) for t in line.split())
        rows, cols, vals = [], [], []
        for _ in range(nz):
            parts = f.readline().split()
            i, j = int(parts[0]) - 1, int(parts[1]) - 1
            if pattern:
                v = 1.0
            elif is_cx:
                v = float(parts[2]) + 1j * float(parts[3])
            else:
                v = float(parts[2])
            rows.append(i)
            cols.append(j)
            vals.append(v)
            if symmetric and i != j:
                rows.append(j)
                cols.append(i)
                if skew:
                    v2 = -v
                elif hermitian:
                    v2 = np.conj(v)
                else:
                    v2 = v
                vals.append(v2)
    vdt = np.complex128 if is_cx else np.float64
    return (np.asarray(rows, np.int32), np.asarray(cols, np.int32),
            np.asarray(vals, vdt), (m, n))


def coo_to_csr(m, rows, cols, vals):
    """Sort COO by (row, col) and build rowptr — native counting sort.

    Inputs are copied: the native kernel permutes its buffers in place,
    and ascontiguousarray would alias already-contiguous inputs (the
    fallback path never mutates, so behavior must match)."""
    rows = np.array(rows, dtype=np.int32, copy=True)
    cols = np.array(cols, dtype=np.int32, copy=True)
    vals = np.array(vals, dtype=np.float64, copy=True)
    nnz = len(rows)
    lib = get_lib()
    if lib is not None:
        rowptr = np.zeros(m + 1, np.int64)
        lib.spblas_coo_to_csr(m, nnz, rows, cols, vals, rowptr)
        return rows, cols, vals, rowptr
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rowptr = np.zeros(m + 1, np.int64)
    np.add.at(rowptr[1:], rows, 1)
    return rows, cols, vals, np.cumsum(rowptr)


def argsort_i64(key):
    """Stable parallel radix argsort of non-negative int64 keys.

    Returns ``(order int32, sorted_key int64)`` — identical order to
    ``np.argsort(key, kind="stable")`` — or None when the library is
    unavailable or n >= 2^31."""
    lib = get_lib()
    if lib is None:
        return None
    key = np.ascontiguousarray(key, np.int64)
    n = len(key)
    order = np.empty(n, np.int32)
    sorted_key = np.empty(n, np.int64)
    if lib.spblas_argsort_i64(n, key, order, sorted_key) < 0:
        return None
    return order, sorted_key
