"""Format conversions (CSR ⇄ CSC ⇄ COO).

The reference's generic layer lets one algorithm iterate any format via
CPOs (include/spblas/backend/view_customizations.hpp); here the analogue
is cheap canonicalization: ops that want row iteration call ``to_csr`` and
pay one stable sort at most.  All conversions are jittable (shape-static).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spblas_tpu import types as _t
from spblas_tpu.backend import engine
from spblas_tpu.formats.csr import CSR
from spblas_tpu.formats.csc import CSC
from spblas_tpu.formats.coo import COO


def to_csr(a) -> CSR:
    from spblas_tpu.formats.bsr import BSR
    from spblas_tpu.formats.dcsr import DCSR
    if isinstance(a, CSR):
        return a
    if isinstance(a, COO):
        return a.to_csr()
    if isinstance(a, CSC):
        return csc_to_csr(a)
    if isinstance(a, DCSR):
        return a.to_csr()
    if isinstance(a, BSR):
        return bsr_to_csr(a)
    raise TypeError(f"cannot convert {type(a).__name__} to CSR")


def bsr_to_csr(a) -> CSR:
    """Expand BSR blocks to scalar entries (host-side; zero entries
    inside stored blocks are kept, like vendor BSR→CSR converters)."""
    import numpy as np
    bh, bw = a.block_shape
    m, n = a.shape
    nnzb = int(a.nnz_blocks)
    vals = np.asarray(a.values)[:nnzb]              # (nnzb, bh, bw)
    brow = np.asarray(a.block_row_ids())[:nnzb]
    bcol = np.asarray(a.block_colind)[:nnzb]
    rows = (brow[:, None, None] * bh
            + np.arange(bh)[None, :, None]).repeat(bw, axis=2)
    cols = (bcol[:, None, None] * bw
            + np.arange(bw)[None, None, :]).repeat(bh, axis=1)
    rows, cols, v = rows.ravel(), cols.ravel(), vals.ravel()
    order = np.lexsort((cols, rows))
    rowptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(rowptr[1:], rows, 1)
    return CSR.from_arrays(v[order], np.cumsum(rowptr), cols[order],
                           (m, n), nnz=len(v))


def to_csc(a) -> CSC:
    from spblas_tpu.formats.bsr import BSR
    from spblas_tpu.formats.dcsr import DCSR
    if isinstance(a, CSC):
        return a
    if isinstance(a, CSR):
        return csr_to_csc(a)
    if isinstance(a, (COO, BSR, DCSR)):
        return csr_to_csc(to_csr(a))
    raise TypeError(f"cannot convert {type(a).__name__} to CSC")


def to_coo(a) -> COO:
    if isinstance(a, COO):
        return a
    if isinstance(a, CSR):
        from spblas_tpu.formats.coo import csr_to_coo
        return csr_to_coo(a)
    if isinstance(a, CSC):
        # column-major entry order → re-sort row-major
        rows = a.rowind
        cols = a.col_ids()
        m, n = a.shape
        mask = a.entry_mask()
        rows_s, cols_s, vals_s = engine.lexsort_coo(
            jnp.where(mask, rows, m).astype(_t.index_dtype),
            jnp.where(mask, cols, 0).astype(_t.index_dtype),
            jnp.where(mask, a.values, 0))
        rows_s = jnp.where(jnp.arange(a.capacity) < a.nnz, rows_s, 0)
        return COO(values=vals_s, rowind=rows_s.astype(_t.index_dtype),
                   colind=jnp.where(jnp.arange(a.capacity) < a.nnz,
                                    cols_s, 0).astype(_t.index_dtype),
                   nnz=a.nnz, shape=(m, n))
    raise TypeError(f"cannot convert {type(a).__name__} to COO")


def csc_to_csr(a: CSC) -> CSR:
    """Materialized CSC→CSR: one stable sort by (row, col)."""
    return to_coo(a).to_csr()


def csr_to_csc(a: CSR) -> CSC:
    """Materialized CSR→CSC: sort entries by (col, row)."""
    m, n = a.shape
    mask = a.entry_mask()
    cols = jnp.where(mask, a.colind, n).astype(_t.index_dtype)
    rows = jnp.where(mask, a.row_ids(), 0).astype(_t.index_dtype)
    vals = jnp.where(mask, a.values, 0)
    cols_s, rows_s, vals_s = engine.lexsort_coo(cols, rows, vals)
    live = jnp.arange(a.capacity, dtype=jnp.int32) < a.nnz
    counts = engine.row_counts(cols_s, live, n)
    colptr = engine.rowptr_from_counts(counts, n)
    return CSC(values=jnp.where(live, vals_s, 0),
               colptr=colptr,
               rowind=jnp.where(live, rows_s, 0).astype(_t.index_dtype),
               nnz=a.nnz, shape=(m, n))
