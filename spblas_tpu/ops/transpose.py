"""Out-of-place transpose (materialized), plus the two-phase inspect stub.

Re-design of the reference transpose (include/spblas/algorithms/
transpose_impl.hpp:16-53 — two-pass count/exclusive-scan/scatter).  Here
the formulation is one stable lexicographic sort by (col, row); the
counting pass becomes a segment count (same two logical passes, both
vector-parallel).  ``transpose_inspect`` returns an info whose nnz equals
the input's (structure-preserving), mirroring transpose_impl.hpp:10-12.

The *lazy* ``transposed`` view (zero cost) lives in spblas_tpu.views.
"""

from __future__ import annotations

import jax.numpy as jnp

from spblas_tpu import types as _t
from spblas_tpu import views as _v
from spblas_tpu.backend import engine
from spblas_tpu.formats.csr import CSR
from spblas_tpu.formats.convert import to_csr
from spblas_tpu.info import OperationInfo
from spblas_tpu.utils.logging import traced


@traced
def transpose_inspect(a_view) -> OperationInfo:
    a = _v.get_ultimate_base(a_view)
    m, n = a.shape
    return OperationInfo(result_shape=(n, m), result_nnz=int(a.nnz),
                         result_capacity=a.capacity)


@traced
def transpose(a_view, capacity=None) -> CSR:
    """B = op(A)^T materialized as CSR (folds scaled/conjugated views)."""
    base, alpha, conj = _v.fold(a_view)
    a = to_csr(base)
    m, n = a.shape
    vals = _v.fold_values(a.values, alpha, conj)
    mask = a.entry_mask()
    # transposed entries: row' = col, col' = row; sort by (row', col')
    rows_t = jnp.where(mask, a.colind, n).astype(_t.index_dtype)
    cols_t = jnp.where(mask, a.row_ids(), 0).astype(_t.index_dtype)
    rows_s, cols_s, vals_s = engine.lexsort_coo(rows_t, cols_t, vals)
    live = jnp.arange(a.capacity, dtype=jnp.int32) < a.nnz
    counts = engine.row_counts(rows_s, live, n)
    rowptr = engine.rowptr_from_counts(counts, n)
    out = CSR(values=jnp.where(live, vals_s, 0),
              rowptr=rowptr,
              colind=jnp.where(live, cols_s, 0).astype(_t.index_dtype),
              nnz=a.nnz, shape=(n, m))
    if capacity is not None:
        if int(a.nnz) > capacity:
            raise RuntimeError("transpose: output capacity too small "
                               "(transpose_impl.hpp capacity check)")
        out = out.with_capacity(capacity)
    return out
