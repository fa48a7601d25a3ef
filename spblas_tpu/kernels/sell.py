"""SELL (sliced/bucketed ELL): degree-bucketed padded-row layout.

ELL pads every row to the GLOBAL max width, so a single long row (or a
skewed distribution) multiplies the gather traffic of the whole matrix:
uniform deg-10 at m=100k has max degree 26 — 2.6x padding.  SELL-C-σ
(Kreutzer et al., arXiv:1307.6209 — PAPERS.md) sorts rows by degree and
pads per slice; here slices are power-of-two WIDTH BUCKETS, each a
dense (mb, Wb) block, so padding is < 2x of the live entries per bucket
and the hot loop is an accumulated row gather per width column (no
(m, W, k) 3D-gather intermediate).

Outputs are computed bucket-by-bucket in degree-sorted order and
un-permuted with ONE (m, k) row gather; rows with no entries read an
appended zero row.

Reference capability bar: general CSR SpMM/SpMV of the vendor backends
(include/spblas/vendor/onemkl_sycl/detail/spmm_impl.hpp:40-200,
spmv_impl.hpp:38-120).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spblas_tpu.formats.csr import CSR

# buckets wider than this use the one-shot 3D gather + einsum instead of
# Wb unrolled row-gathers (compile-size guard; such buckets hold few
# rows, so the 3D intermediate is small)
_UNROLL_MAX = 64

# Width ladder for degree bucketing.  Gathered rows are the cost, so
# padding is throughput: pow-2 buckets pad uniform deg-10 by 1.36x,
# this ladder caps within-bucket padding at ~1.2x worst / ~1.08x
# typical while keeping the unrolled-gather count (sum of widths)
# bounded for compile size.  Wider than 64 -> pow-2 (einsum path, few
# rows).
_WIDTH_LADDER = (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32,
                 40, 48, 56, 64)


def _bucket_width(deg: int) -> int:
    """Smallest ladder width >= deg (pow-2 beyond the ladder)."""
    for w in _WIDTH_LADDER:
        if deg <= w:
            return w
    return 1 << int(deg - 1).bit_length()


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SellBucket:
    values: jax.Array       # (mb, Wb) f32, padding 0
    cols: jax.Array         # (mb, Wb) i32, padding 0
    gather_idx: jax.Array   # (mb, Wb) i32 into the CSR values array
    valid: jax.Array        # (mb, Wb) bool

    @property
    def width(self) -> int:
        return int(self.values.shape[1])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SellPlan:
    """Degree-bucketed layout + the inverse row permutation."""

    buckets: Tuple[SellBucket, ...]
    pos: jax.Array          # (m,) i32: row i's slot in the concat
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def width(self) -> int:
        """Max bucket width (diagnostic)."""
        return max((b.width for b in self.buckets), default=0)

    def refresh_values(self, csr_values: jax.Array) -> "SellPlan":
        """Numeric reuse: re-gather values, same sparsity."""
        bs = tuple(dataclasses.replace(
            b, values=jnp.where(b.valid, csr_values[b.gather_idx], 0))
            for b in self.buckets)
        return dataclasses.replace(self, buckets=bs)


def build_sell_plan(a: CSR) -> SellPlan:
    """Host-side bucketing (inspect phase)."""
    m, n = a.shape
    nnz = int(a.nnz)
    rowptr = np.minimum(np.asarray(a.rowptr).astype(np.int64), nnz)
    colind = np.asarray(a.colind)[:nnz].astype(np.int64)
    values = np.asarray(a.values)[:nnz]
    deg = np.diff(rowptr)
    live = np.flatnonzero(deg > 0)
    # bucket id = index into the width ladder (fine-grained: ~1.08x
    # typical padding vs 1.36x for pow-2 — the gather wall is flat in
    # rows/s, so padding is throughput); stable degree-sorted row order
    ladder = np.asarray(_WIDTH_LADDER, np.int64)
    bid = np.zeros(len(deg), np.int64)
    if len(live):
        dl = deg[live]
        in_ladder = np.searchsorted(ladder, dl)
        beyond = np.ceil(np.log2(np.maximum(dl, 2))).astype(np.int64)
        bid[live] = np.where(dl <= ladder[-1], in_ladder,
                             len(ladder) + beyond)
    order = live[np.argsort(bid[live], kind="stable")]
    pos = np.full(m, len(order), np.int64)   # default: the zero row
    pos[order] = np.arange(len(order))

    host_buckets = []
    sorted_bids = bid[order]
    bounds = np.flatnonzero(np.diff(sorted_bids)) + 1
    starts = np.concatenate([[0], bounds]) if len(order) else []
    ends = np.concatenate([bounds, [len(order)]]) if len(order) else []
    for s0, s1 in zip(starts, ends):
        rows = order[s0:s1]
        wb = _bucket_width(int(deg[rows].max()))
        offs = rowptr[rows][:, None] + np.arange(wb)[None, :]
        val_mask = np.arange(wb)[None, :] < deg[rows][:, None]
        gidx = np.where(val_mask, offs, 0)
        host_buckets.append((
            np.where(val_mask, values[gidx], 0).astype(values.dtype),
            np.where(val_mask, colind[gidx], 0).astype(np.int32),
            gidx.astype(np.int32), val_mask))
    flat = jax.device_put(
        tuple(arr for hb in host_buckets for arr in hb)
        + (pos.astype(np.int32),))
    buckets = tuple(
        SellBucket(values=flat[4 * i], cols=flat[4 * i + 1],
                   gather_idx=flat[4 * i + 2], valid=flat[4 * i + 3])
        for i in range(len(host_buckets)))
    return SellPlan(buckets=buckets, pos=flat[-1], shape=(m, n))


def bucket_matmul(values: jax.Array, cols: jax.Array,
                  mat: jax.Array) -> jax.Array:
    """(mb, W) padded rows x dense mat -> (mb, k): W accumulated row
    gathers for moderate widths, the one-shot
    3D gather for wide hub buckets (few rows there, and the unrolled
    form would trace thousands of gathers).  Shared by SELL, ELL and
    the distributed SELL executor."""
    if values.shape[1] <= _UNROLL_MAX:
        acc = jnp.zeros((values.shape[0], mat.shape[1]),
                        jnp.result_type(values.dtype, mat.dtype))
        for w in range(values.shape[1]):
            acc = acc + values[:, w, None] * mat[cols[:, w]]
        return acc
    bg = mat[cols]
    return jnp.einsum("mw,mwk->mk", values, bg,
                      precision=jax.lax.Precision.HIGHEST)


def _bucket_spmm(b: SellBucket, mat: jax.Array) -> jax.Array:
    return bucket_matmul(b.values, b.cols, mat)


@jax.jit
def sell_spmm(plan: SellPlan, mat: jax.Array) -> jax.Array:
    """C = A @ B over the bucketed layout."""
    k = mat.shape[1]
    dt = jnp.result_type(
        plan.buckets[0].values.dtype if plan.buckets else jnp.float32,
        mat.dtype)
    parts = [_bucket_spmm(b, mat).astype(dt) for b in plan.buckets]
    parts.append(jnp.zeros((1, k), dt))      # zero-degree rows read this
    stacked = jnp.concatenate(parts, axis=0)
    return stacked[plan.pos]


@jax.jit
def sell_spmv(plan: SellPlan, x: jax.Array) -> jax.Array:
    """y = A @ x over the bucketed layout."""
    dt = jnp.result_type(
        plan.buckets[0].values.dtype if plan.buckets else jnp.float32,
        x.dtype)
    parts = [jnp.sum(b.values * x[b.cols], axis=1).astype(dt)
             for b in plan.buckets]
    parts.append(jnp.zeros((1,), dt))
    stacked = jnp.concatenate(parts, axis=0)
    return stacked[plan.pos]
