"""DIA (diagonal) plan: gather-free SpMV for banded matrices.

No reference counterpart — the reference delegates structure exploitation
to vendor handles; the banded case (BASELINE.json configs[0]: 10k x 10k
banded) deserves its own plan because storing diagonals densely removes
ALL index traffic: y += diag_d * shift(x, d) is pure streaming at 4
bytes/nnz of matrix traffic versus CSR's ~12.

Plan construction (inspect) detects the populated diagonals on host.
SpMV runs as one reduction over a stack of statically shifted x windows,
which XLA fuses into a single pass over the diagonals with the x reads
served from cache; SpMM keeps a shift-multiply-add chain, since a stack
of (m, k) windows would not fit in cache.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spblas_tpu.formats.csr import CSR, host_row_ids


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Diagonals stored dense: diags[k, i] = A[i, i + offsets[k]]."""

    diags: jax.Array      # (ndiag, m)
    offsets: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True))  # static → shifts unroll at trace time
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def ndiag(self) -> int:
        return int(self.diags.shape[0])


def dia_fill_fraction(a: CSR) -> float:
    """Fraction of DIA storage that would hold true nonzeros — the plan
    chooser's banded-ness test."""
    m, n = a.shape
    nnz = int(a.nnz)
    if nnz == 0:
        return 0.0
    colind = np.asarray(a.colind)[:nnz]
    rows = host_row_ids(a.rowptr, nnz, m)
    offs = np.unique(colind.astype(np.int64) - rows)
    return nnz / float(len(offs) * m)


def build_dia_plan(a: CSR) -> DiaPlan:
    m, n = a.shape
    nnz = int(a.nnz)
    colind = np.asarray(a.colind)[:nnz]
    rows = host_row_ids(a.rowptr, nnz, m)
    values = np.asarray(a.values)[:nnz]
    offs_arr = colind.astype(np.int64) - rows
    offsets = np.unique(offs_arr)
    diags = np.zeros((len(offsets), m), dtype=values.dtype)
    pos = np.searchsorted(offsets, offs_arr)
    diags[pos, rows] = values
    return DiaPlan(diags=jnp.asarray(diags),
                   offsets=tuple(int(o) for o in offsets), shape=(m, n))


def _padded(plan: DiaPlan, v: jax.Array):
    """v zero-padded so every diagonal's shifted window is in bounds;
    returns (padded v, pad_lo)."""
    m, n = plan.shape
    pad_lo = max(-min(plan.offsets, default=0), 0)
    pad_hi = max(max(plan.offsets, default=0) + m - n, 0)
    pad = [(pad_lo, pad_hi)] + [(0, 0)] * (v.ndim - 1)
    return jnp.pad(v, pad), pad_lo


@jax.jit
def dia_spmv(plan: DiaPlan, x: jax.Array) -> jax.Array:
    """y[i] = sum_k diags[k, i] * x[i + offsets[k]].

    diags[k, i] is 0 wherever i + off falls outside the matrix, so the
    padding contributes nothing.  On the H100 the stacked reduction beat
    a shift-multiply-add chain at 101 diagonals and tied it at 5
    (PERF.md)."""
    m = plan.shape[0]
    dt = jnp.result_type(plan.diags.dtype, x.dtype)
    if not plan.offsets:
        return jnp.zeros((m,), dt)
    xp, pad_lo = _padded(plan, x)
    windows = jnp.stack([jax.lax.slice(xp, (pad_lo + off,),
                                       (pad_lo + off + m,))
                         for off in plan.offsets])
    return jnp.sum(plan.diags * windows, axis=0, dtype=dt)


@jax.jit
def dia_spmm(plan: DiaPlan, b: jax.Array) -> jax.Array:
    m = plan.shape[0]
    kdim = b.shape[1]
    bp, pad_lo = _padded(plan, b)
    c = jnp.zeros((m, kdim), dtype=jnp.result_type(plan.diags.dtype,
                                                    b.dtype))
    for k, off in enumerate(plan.offsets):
        c = c + plan.diags[k][:, None] * jax.lax.slice(
            bp, (pad_lo + off, 0), (pad_lo + off + m, kdim))
    return c
