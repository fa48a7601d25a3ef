"""BSR kernels: block-sparse products as batched dense block products.

The reference's SpMM is a scalar loop (multiply_impl.hpp:66-92) and its
accelerated path is vendor-opaque.  With block structure every stored
block is a dense (bh, bw) tile, so each op becomes: gather the operand
blocks a stored block meets, one batched ``dot_general`` over all stored
blocks (XLA hands small batched GEMMs to the BLAS library), and a
``segment_sum`` by output block.  Any block shape works.

SpGEMM keeps the two-phase protocol: the symbolic phase runs on the
block graph on host (tiny next to the scalar expansion) and emits the
contraction-pair list; the numeric phase is the batched product over the
gathered pairs, re-runnable with new values over unchanged block
sparsity.  Layout contract: A has blocks (bh, bk), B has (bk, bw), and C
comes out with blocks (bh, bw).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spblas_tpu import types as _t
from spblas_tpu.formats.bsr import BSR

_HIGHEST = jax.lax.Precision.HIGHEST


@jax.jit
def bsr_spmv(a: BSR, x: jax.Array) -> jax.Array:
    """y = A @ x with BSR A."""
    m, n = a.shape
    bh, bw = a.block_shape
    if x.shape[0] != n:
        raise ValueError(f"bsr_spmv: A is {a.shape}, x is {x.shape}")
    xg = x.reshape(n // bw, bw)[a.block_colind]               # (cap, bw)
    blocks = jnp.einsum("cij,cj->ci", a.values, xg, precision=_HIGHEST)
    # padding blocks carry row id m // bh and are dropped
    y = jax.ops.segment_sum(blocks, a.block_row_ids(),
                            num_segments=m // bh)
    return y.reshape(m)


@jax.jit
def bsr_spmm(a: BSR, b: jax.Array) -> jax.Array:
    """C = A @ B with BSR A and dense B of shape (n, k)."""
    m, n = a.shape
    bh, bw = a.block_shape
    if b.shape[0] != n:
        raise ValueError(f"bsr_spmm: A is {a.shape}, B is {b.shape}")
    k = b.shape[1]
    bg = b.reshape(n // bw, bw, k)[a.block_colind]           # (cap, bw, k)
    blocks = jnp.einsum("cij,cjk->cik", a.values, bg, precision=_HIGHEST)
    c = jax.ops.segment_sum(blocks, a.block_row_ids(),
                            num_segments=m // bh)
    return c.reshape(m, k)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BsrSpgemmPlan:
    """Numeric plan from the block-symbolic phase.

    pair_a / pair_b: A / B block index per contraction pair;
    pair_c: the C block each pair accumulates into;
    c_rowptr / c_colind: C's block structure (capacity-padded colind).
    """

    pair_a: jax.Array
    pair_b: jax.Array
    pair_c: jax.Array
    c_rowptr: jax.Array
    c_colind: jax.Array
    nnzb_c: int = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    block_shape: Tuple[int, int] = dataclasses.field(
        metadata=dict(static=True))


def bsr_spgemm_compute(a: BSR, b: BSR) -> BsrSpgemmPlan:
    """Block-symbolic phase (host): structure of C and the contraction
    pair list.  Costs O(block flops) on the small block graph."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"bsr_spgemm: A is {a.shape}, B is {b.shape}")
    bh, bk = a.block_shape
    bk2, bw = b.block_shape
    if bk != bk2:
        raise ValueError(
            f"block mismatch: A blocks {a.block_shape}, "
            f"B blocks {b.block_shape}")
    na = int(a.nnz_blocks)
    nb = int(b.nnz_blocks)
    a_rp = np.asarray(a.block_rowptr).astype(np.int64)
    a_ci = np.asarray(a.block_colind)[:na]
    a_rows = np.repeat(np.arange(len(a_rp) - 1),
                       np.minimum(a_rp[1:], na) - np.minimum(a_rp[:-1], na))
    b_rp = np.asarray(b.block_rowptr).astype(np.int64)
    b_ci = np.asarray(b.block_colind)[:nb]

    # expansion over the block graph: every A block (i, kk) pairs with
    # every B block in block-row kk
    b_len = np.minimum(b_rp[1:], nb) - np.minimum(b_rp[:-1], nb)
    counts = b_len[a_ci]
    e_total = int(counts.sum())
    src_a = np.repeat(np.arange(na), counts)
    local = np.arange(e_total) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    src_b = np.repeat(np.minimum(b_rp[:-1], nb)[a_ci], counts) + local
    rows_e = np.repeat(a_rows, counts)
    cols_e = b_ci[src_b]
    order = np.lexsort((cols_e, rows_e))
    rows_s, cols_s = rows_e[order], cols_e[order]
    heads = np.ones(e_total, bool)
    heads[1:] = (rows_s[1:] != rows_s[:-1]) | (cols_s[1:] != cols_s[:-1])
    nnzb_c = int(heads.sum())
    cap = _t.quantize_capacity(max(nnzb_c, 1))
    c_colind = np.zeros(cap, np.int64)
    c_colind[:nnzb_c] = cols_s[heads]
    mb = len(a_rp) - 1
    c_rowptr = np.zeros(mb + 1, np.int64)
    np.add.at(c_rowptr[1:], rows_s[heads], 1)
    return BsrSpgemmPlan(
        pair_a=jnp.asarray(src_a[order], jnp.int32),
        pair_b=jnp.asarray(src_b[order], jnp.int32),
        pair_c=jnp.asarray(np.cumsum(heads) - 1, jnp.int32),
        c_rowptr=jnp.asarray(np.cumsum(c_rowptr), _t.offset_dtype),
        c_colind=jnp.asarray(c_colind, _t.index_dtype),
        nnzb_c=nnzb_c, shape=(m, n), block_shape=(bh, bw))


@jax.jit
def bsr_spgemm_numeric(plan: BsrSpgemmPlan, a: BSR, b: BSR) -> BSR:
    """Numeric phase: one batched block product over the contraction
    pairs, summed into C's blocks.  Re-runnable with new values over
    unchanged block sparsity."""
    bh, bw = plan.block_shape
    cap = int(plan.c_colind.shape[0])
    prods = jnp.einsum("pij,pjk->pik", a.values[plan.pair_a],
                       b.values[plan.pair_b], precision=_HIGHEST)
    values = jax.ops.segment_sum(prods, plan.pair_c, num_segments=cap)
    return BSR(values=values.astype(jnp.result_type(a.dtype, b.dtype)),
               block_rowptr=plan.c_rowptr, block_colind=plan.c_colind,
               nnz_blocks=jnp.asarray(plan.nnzb_c, jnp.int32),
               shape=plan.shape, block_shape=(bh, bw))


def bsr_spgemm(a: BSR, b: BSR) -> BSR:
    """One-shot block SpGEMM (compute + numeric)."""
    return bsr_spgemm_numeric(bsr_spgemm_compute(a, b), a, b)
