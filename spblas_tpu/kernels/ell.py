"""ELL (padded-row) plan: the general-purpose optimized SpMV/SpMM layout.

The reference's ``matrix_opt`` caches a vendor handle
(views/matrix_opt_impl.hpp:90-92); the analogue here is a cached
*re-layout*: CSR rows padded to a common width W so the per-row entry loop
becomes a dense (m, W) axis — regular strides, one 2D gather for x, and a
row reduction.  This removes the segment-sum
scatter from the SpMV hot path entirely (segmented sums become a dense
``sum(axis=1)``).

Width is chosen per row-slice (SELL-C-sigma style, cf. Kreutzer et al.,
arXiv:1307.6209 — PAPERS.md) when ``slice_height`` > 1 to avoid padding
explosion on skewed rows; slice geometry stays static per plan.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spblas_tpu import types as _t
from spblas_tpu.formats.csr import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllPlan:
    """Padded-row layout: values/cols re-laid as (m_pad, W)."""

    values: jax.Array   # (m_pad, W) — padding is 0
    cols: jax.Array     # (m_pad, W) — padding points at column 0
    gather_idx: jax.Array  # (m_pad, W) into the source CSR values array
    valid: jax.Array    # (m_pad, W) bool
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def width(self) -> int:
        return int(self.values.shape[1])

    @property
    def m_pad(self) -> int:
        return int(self.values.shape[0])

    def refresh_values(self, csr_values: jax.Array) -> "EllPlan":
        """Re-gather after a numeric update with unchanged sparsity —
        the plan-level analogue of rocSPARSE numeric reuse."""
        vals = jnp.where(self.valid, csr_values[self.gather_idx], 0)
        return dataclasses.replace(self, values=vals)


def build_ell_plan(a: CSR, row_pad: int = 8) -> EllPlan:
    """Host-side plan construction (inspect phase — one-time cost).

    Geometry comes from the native inspector runtime
    (spblas_tpu.native.ell_geometry, C++ with a numpy fallback)."""
    from spblas_tpu import native

    m, n = a.shape
    values = np.asarray(a.values)
    nnz = int(a.nnz)
    m_pad = -(-m // row_pad) * row_pad
    gather, ell_cols, valid, w = native.ell_geometry(
        m, m_pad, nnz, np.asarray(a.rowptr), np.asarray(a.colind))
    ell_vals = np.where(valid, values[gather], 0)
    return EllPlan(values=jnp.asarray(ell_vals), cols=jnp.asarray(ell_cols),
                   gather_idx=jnp.asarray(gather), valid=jnp.asarray(valid),
                   shape=(m, n))


@jax.jit
def ell_spmv(plan: EllPlan, x: jax.Array) -> jax.Array:
    """y = A @ x over the padded layout: gather + lane reduction."""
    xg = x[plan.cols]                       # (m_pad, W) gather
    y = jnp.sum(plan.values * xg, axis=1)   # padding contributes 0
    return y[: plan.shape[0]]


@jax.jit
def ell_spmm(plan: EllPlan, b: jax.Array) -> jax.Array:
    """C = A @ B: per-entry B-row gather, reduce over W.

    For moderate W the reduction runs as W accumulated (m, k) row
    gathers instead of one (m, W, k) gather + einsum; the policy lives
    in kernels.sell.bucket_matmul."""
    from spblas_tpu.kernels.sell import bucket_matmul
    return bucket_matmul(plan.values, plan.cols, b)[: plan.shape[0]]
