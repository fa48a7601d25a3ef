"""SpMM: C = A @ B for sparse A, dense B (and dense @ dense fallback).

Re-design of the reference SpMM (include/spblas/algorithms/
multiply_impl.hpp:66-92 — scalar loop with an inner j-sweep over the B row).
The XLA form gathers whole B rows per nonzero and segment-sums them: the
inner j-loop becomes a parallel vector axis.  Structured plans (DIA, SELL)
are selected through OptimizedMatrix plans; BSR operands take the batched
block kernel (spblas_tpu.kernels.bsr).
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
def spmm(a_view, b_view) -> jax.Array:
    a, alpha_a, conj_a = _v.fold(a_view)
    b, alpha_b, conj_b = _v.fold(b_view)
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(
            f"spmm dimension mismatch: A is {a.shape}, B is {b.shape}")
    if conj_b:
        b = jnp.conj(b)
    opt = _v.get_matrix_opt(a_view)
    if opt is not None and not conj_a and _v.is_sparse(a_view):
        from spblas_tpu.kernels import plans as _plans
        c = _plans.plan_spmm(_plans.optimized_plan(opt), b)
    else:
        c = _spmm_base(a, b, conj_a)
    return c * (alpha_a * alpha_b)


def _spmm_base(a, b, conj_a: bool):
    from spblas_tpu.formats.bsr import BSR
    from spblas_tpu.formats.dcsr import DCSR
    if isinstance(a, BSR):
        from spblas_tpu.kernels.bsr import bsr_spmm
        vals_a = a
        if conj_a:
            import dataclasses
            vals_a = dataclasses.replace(a, values=jnp.conj(a.values))
        return bsr_spmm(vals_a, b)
    if isinstance(a, DCSR):
        vals = jnp.conj(a.values) if conj_a else a.values
        contrib = vals[:, None] * b[a.colind, :]
        return jax.ops.segment_sum(contrib, a.row_ids(),
                                   num_segments=a.shape[0])
    if isinstance(a, CSR):
        vals = jnp.conj(a.values) if conj_a else a.values
        contrib = vals[:, None] * b[a.colind, :]
        return jax.ops.segment_sum(contrib, a.row_ids(),
                                   num_segments=a.shape[0])
    if isinstance(a, CSC):
        vals = jnp.conj(a.values) if conj_a else a.values
        contrib = vals[:, None] * b[a.col_ids() % a.shape[1], :]
        return jax.ops.segment_sum(contrib, a.rowind,
                                   num_segments=a.shape[0])
    if isinstance(a, COO):
        vals = jnp.conj(a.values) if conj_a else a.values
        contrib = vals[:, None] * b[a.colind, :]
        return jax.ops.segment_sum(contrib, a.rowind,
                                   num_segments=a.shape[0])
    mat = jnp.conj(a) if conj_a else a
    # full-precision accumulation: library-of-record semantics, matching
    # the reference's exact scalar loops (an f32 dot otherwise may run in
    # TF32 on the GPU's tensor cores)
    return jnp.dot(mat, b, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.result_type(
                       mat.dtype, b.dtype))
