"""SpMV: y = A @ x for sparse A, dense x.

Re-design of the reference SpMV (reference:
include/spblas/algorithms/multiply_impl.hpp:33-53 — a scalar ``for_each``
scatter loop).  Here the O(nnz) hot loop becomes gather + multiply +
segment-sum, and canonical zero padding removes every mask from the
numeric path.

An optimized (structured-plan) path hangs off ``OptimizedMatrix`` plans —
see spblas_tpu.kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spblas_tpu.formats.csr import CSR
from spblas_tpu.formats.csc import CSC
from spblas_tpu.formats.coo import COO
from spblas_tpu import views as _v
from spblas_tpu.utils.logging import traced


@traced
def spmv(a_view, x_view) -> jax.Array:
    """y = (folded a_view) @ (folded x_view); shapes checked at trace time
    (the reference throws std::invalid_argument, multiply_impl.hpp:37-41)."""
    a, alpha_a, conj_a = _v.fold(a_view)
    x, alpha_x, conj_x = _v.fold(x_view)
    m, n = a.shape
    if x.shape[0] != n:
        raise ValueError(
            f"spmv dimension mismatch: A is {a.shape}, x is {x.shape}")
    if conj_x:
        x = jnp.conj(x)
    opt = _v.get_matrix_opt(a_view)
    if opt is not None and not conj_a and _v.is_sparse(a_view):
        from spblas_tpu.kernels import plans as _plans
        y = _plans.plan_spmv(_plans.optimized_plan(opt), x)
    else:
        y = _spmv_base(a, x, conj_a)
    alpha = alpha_a * alpha_x
    return y * alpha


def _spmv_base(a, x, conj_a: bool):
    from spblas_tpu.formats.bsr import BSR
    from spblas_tpu.formats.dcsr import DCSR
    if isinstance(a, BSR):
        from spblas_tpu.kernels.bsr import bsr_spmv
        vals_a = a
        if conj_a:
            import dataclasses
            vals_a = dataclasses.replace(a, values=jnp.conj(a.values))
        return bsr_spmv(vals_a, x)
    if isinstance(a, DCSR):
        vals = jnp.conj(a.values) if conj_a else a.values
        contrib = vals * x[a.colind]
        return jax.ops.segment_sum(contrib, a.row_ids(),
                                   num_segments=a.shape[0])
    if isinstance(a, CSR):
        vals = jnp.conj(a.values) if conj_a else a.values
        contrib = vals * x[a.colind]
        # padded entries: value 0, row id == m → dropped either way
        return jax.ops.segment_sum(contrib, a.row_ids(),
                                   num_segments=a.shape[0])
    if isinstance(a, CSC):
        vals = jnp.conj(a.values) if conj_a else a.values
        contrib = vals * x[a.col_ids() % a.shape[1]]
        return jax.ops.segment_sum(contrib, a.rowind,
                                   num_segments=a.shape[0])
    if isinstance(a, COO):
        vals = jnp.conj(a.values) if conj_a else a.values
        contrib = vals * x[a.colind]
        return jax.ops.segment_sum(contrib, a.rowind,
                                   num_segments=a.shape[0])
    # dense matrix fallback
    mat = jnp.conj(a) if conj_a else a
    return jnp.matmul(mat, x, precision=jax.lax.Precision.HIGHEST)
