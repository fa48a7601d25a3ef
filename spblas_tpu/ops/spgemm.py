"""Two-phase SpGEMM: C = A @ B (+ beta * D) for sparse A, B.

Re-design of the reference's three SpGEMM algorithms
(include/spblas/algorithms/detail/spgemm/spgemm_gustavsons.hpp:20-215,
spgemm_innerproduct.hpp, spgemm_outerproduct.hpp).  The reference picks
SPA / hash / dot kernels by operand iterability via C++ overload
resolution; here everything runs through one *expand → sort → compress*
(ESC) Gustavson formulation built from XLA sort + segment-sum (SURVEY.md
§7 step 4).  CSC operands are
canonicalized to CSR; a CSC result uses the transpose trick
C^T = B^T A^T (spgemm_gustavsons.hpp:97-127).

Protocol (mirrors the reference / oneMKL staging,
vendor/onemkl_sycl/spgemm_impl.hpp:39-265):

  symbolic  — enumerate flops, sort, count unique (i, j): ONE device→host
              sync reads result_nnz so the caller can allocate;
  numeric   — gather + multiply + segment-sum into the fixed structure.

The symbolic result is an :class:`SpgemmPlan` of pure gather/segment maps,
so repeated numeric runs with new values (same sparsity) cost one fused
gather-multiply-reduce — the capability rocSPARSE exposes as
``spgemm_state_t`` (vendor/rocsparse/multiply_spgemm.hpp:150-214), carried
over here as :class:`SpgemmState` plus the 4-argument fused form
C = alpha*A*B + beta*D (multiply_spgemm.hpp:232-317).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from spblas_tpu import types as _t
from spblas_tpu import views as _v
from spblas_tpu.backend import engine
from spblas_tpu.formats.csr import CSR
from spblas_tpu.formats.convert import to_csr
from spblas_tpu.info import OperationInfo
from spblas_tpu.utils.logging import traced


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Device-resident numeric plan: everything the numeric phase needs.

    For stream entry s (sorted order):
      is_d[s]  — entry comes from the D addend, not the A*B expansion
      src_a[s] — A entry index (A*B entries; 0 for D entries)
      src_b[s] — B entry index, or D entry index when is_d
      slot[s]  — output slot in C (== out_capacity → dropped)
    Plus the full C structure (rowptr, colind) and live entry count.
    """

    src_a: jax.Array
    src_b: jax.Array
    is_d: jax.Array
    valid: jax.Array
    slot: jax.Array
    c_rowptr: jax.Array
    c_colind: jax.Array
    c_nnz: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    has_d: bool = dataclasses.field(default=False,
                                    metadata=dict(static=True))

    @property
    def c_capacity(self) -> int:
        return int(self.c_colind.shape[0])

    def with_capacity(self, capacity: int) -> "SpgemmPlan":
        """Re-target the plan at a different output capacity (the user-owns-
        allocation handshake: slots stay valid, colind re-padded)."""
        capacity = int(capacity)
        cur = self.c_capacity
        if capacity == cur:
            return self
        if capacity > cur:
            pad = jnp.zeros((capacity - cur,), dtype=self.c_colind.dtype)
            colind = jnp.concatenate([self.c_colind, pad])
        else:
            colind = self.c_colind[:capacity]
        # slot sentinel must track the capacity (drop == capacity)
        slot = jnp.where(self.slot >= jnp.asarray(cur, self.slot.dtype),
                         capacity, jnp.minimum(self.slot, capacity))
        return dataclasses.replace(self, c_colind=colind, slot=slot)


# ------------------------------------------------------------------ #
# jitted stages
# ------------------------------------------------------------------ #

@partial(jax.jit,
         static_argnames=("a_capacity", "b_capacity", "d_capacity",
                          "e_capacity", "m"))
def _symbolic_sort(a_rowptr, a_colind, a_mask, b_rowptr, b_colind,
                   d_rowptr, d_colind, d_mask,
                   a_capacity, b_capacity, d_capacity, e_capacity, m):
    """Expansion + lexicographic sort + structure counts.

    Returns sorted streams and (rowptr, nnz).  d_* may be None-shaped
    (d_capacity == 0) for the plain 3-arg product.
    """
    src_a, src_b, rows, valid = engine.expansion_maps(
        a_rowptr, a_colind, a_mask, b_rowptr,
        a_capacity, b_capacity, e_capacity, m)
    cols = jnp.where(valid, b_colind[src_b], 0).astype(_t.index_dtype)
    is_d = jnp.zeros((e_capacity,), dtype=jnp.bool_)
    if d_capacity:
        d_rows_all = engine.segment_ids_from_ptr(d_rowptr, d_capacity)
        d_rows = jnp.where(d_mask, d_rows_all, m).astype(_t.index_dtype)
        d_cols = jnp.where(d_mask, d_colind, 0).astype(_t.index_dtype)
        d_src = jnp.arange(d_capacity, dtype=_t.offset_dtype)
        rows = jnp.concatenate([rows, d_rows])
        cols = jnp.concatenate([cols, d_cols])
        src_a = jnp.concatenate(
            [src_a, jnp.zeros((d_capacity,), dtype=_t.offset_dtype)])
        src_b = jnp.concatenate([src_b, d_src])
        valid = jnp.concatenate([valid, d_mask])
        is_d = jnp.concatenate(
            [is_d, jnp.ones((d_capacity,), dtype=jnp.bool_)])
    rows_s, cols_s, src_a_s, src_b_s, is_d_s, valid_s = engine.lexsort_coo(
        rows, cols, src_a, src_b, is_d, valid)
    heads, slots, nnz, rowptr = engine.coalesce_sorted(
        rows_s, cols_s, valid_s, m)
    return (rows_s, cols_s, src_a_s, src_b_s, is_d_s, valid_s, heads,
            slots, rowptr, nnz)


@partial(jax.jit, static_argnames=("c_capacity",))
def _structure_fill(cols_s, heads, slots, valid_s, c_capacity):
    drop = c_capacity
    slot_all = jnp.where(valid_s, jnp.minimum(slots, drop), drop)
    head_slot = jnp.where(heads, slot_all, drop)
    c_colind = jnp.zeros((c_capacity,), dtype=_t.index_dtype).at[
        head_slot].set(cols_s.astype(_t.index_dtype), mode="drop")
    return c_colind, slot_all.astype(_t.offset_dtype)


@jax.jit
def _numeric(plan: SpgemmPlan, a_values, b_values, d_values, alpha, beta):
    """Gather-multiply-reduce numeric fill; the whole reuse hot path."""
    cap = plan.c_capacity
    v_ab = a_values[plan.src_a] * b_values[plan.src_b]
    if d_values is not None:
        nd = d_values.shape[0]
        v_d = d_values[jnp.minimum(plan.src_b, nd - 1)]
        v = jnp.where(plan.is_d, beta * v_d, alpha * v_ab)
    else:
        v = alpha * v_ab
    v = jnp.where(plan.valid, v, 0)
    return jnp.zeros((cap,), dtype=v.dtype).at[plan.slot].add(
        v, mode="drop")


# ------------------------------------------------------------------ #
# public two-phase API
# ------------------------------------------------------------------ #

@traced
def spgemm_compute(a_view, b_view, d_view=None,
                   c_capacity: Optional[int] = None) -> OperationInfo:
    """Symbolic phase: structure of C = A@B (+ D's structure if given).

    One host sync reads result_nnz (mirrors spgemm_impl.hpp:106-117).
    """
    a = to_csr(_v.get_ultimate_base(a_view))
    b = to_csr(_v.get_ultimate_base(b_view))
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"spgemm dimension mismatch: A is {a.shape}, B is {b.shape}")
    d = None
    if d_view is not None:
        d = to_csr(_v.get_ultimate_base(d_view))
        if d.shape != (m, n):
            raise ValueError(
                f"spgemm: D shape {d.shape} != C shape {(m, n)}")
    # flop count → expansion capacity (host-side int64 — a device int32
    # sum would silently wrap past 2^31 flops)
    import numpy as np
    b_rowptr_h = np.asarray(b.rowptr).astype(np.int64)
    b_len = (np.minimum(b_rowptr_h[1:], int(b.nnz))
             - np.minimum(b_rowptr_h[:-1], int(b.nnz)))
    a_cols_h = np.asarray(a.colind)[: int(a.nnz)]
    e_total = int(b_len[a_cols_h].sum())
    if e_total >= 2**31:
        raise RuntimeError(
            f"SpGEMM expansion has {e_total} flops (>= 2^31): use "
            "spgemm_chunked to bound the expansion")
    e_capacity = _t.quantize_capacity(max(e_total, 1))
    d_cap = d.capacity if d is not None else 0
    zero_i = jnp.zeros((1,), dtype=_t.offset_dtype)
    (rows_s, cols_s, src_a_s, src_b_s, is_d_s, valid_s, heads, slots,
     c_rowptr, nnz_dev) = _symbolic_sort(
        a.rowptr, a.colind, a.entry_mask(), b.rowptr, b.colind,
        d.rowptr if d is not None else zero_i,
        d.colind if d is not None else zero_i.astype(_t.index_dtype),
        d.entry_mask() if d is not None else jnp.zeros((1,), jnp.bool_),
        a.capacity, b.capacity, d_cap, e_capacity, m)
    nnz = int(nnz_dev)  # THE device→host sync of the two-phase protocol
    if c_capacity is None:
        c_capacity = _t.quantize_capacity(max(nnz, 1))
    if nnz > c_capacity:
        # reference behaviour: csr_builder throws on overflow
        raise RuntimeError(
            f"SpGEMM ran out of memory: result_nnz {nnz} exceeds "
            f"requested capacity {c_capacity}")
    c_colind, slot_all = _structure_fill(cols_s, heads, slots, valid_s,
                                         int(c_capacity))
    plan = SpgemmPlan(src_a=src_a_s, src_b=src_b_s, is_d=is_d_s,
                      valid=valid_s, slot=slot_all,
                      c_rowptr=c_rowptr, c_colind=c_colind,
                      c_nnz=nnz_dev, shape=(m, n),
                      has_d=d is not None)
    return OperationInfo(result_shape=(m, n), result_nnz=nnz,
                         result_capacity=int(c_capacity), plan=plan)


@traced
def spgemm_fill(info: OperationInfo, a_view, b_view, d_view=None,
                c: Optional[CSR] = None) -> CSR:
    """Numeric phase into the structure computed by :func:`spgemm_compute`.

    ``c`` (optional) supplies user-owned capacity, mirroring the
    allocate-then-update handshake (examples/simple_spgemm.cpp:50-60).
    """
    plan: SpgemmPlan = info.plan
    if plan.has_d and d_view is None:
        raise ValueError(
            "spgemm_fill: plan was computed with a D addend but none was "
            "passed (the D slots would fill with garbage)")
    if not plan.has_d and d_view is not None:
        raise ValueError(
            "spgemm_fill: plan has no D structure; recompute with d_view")
    a_base, alpha_a, conj_a = _v.fold(a_view)
    b_base, alpha_b, conj_b = _v.fold(b_view)
    a = to_csr(a_base)
    b = to_csr(b_base)
    a_values = jnp.conj(a.values) if conj_a else a.values
    b_values = jnp.conj(b.values) if conj_b else b.values
    alpha = alpha_a * alpha_b
    beta = jnp.asarray(1, dtype=alpha.dtype)
    d_values = None
    if d_view is not None:
        d_base, beta_d, conj_d = _v.fold(d_view)
        d = to_csr(d_base)
        d_values = jnp.conj(d.values) if conj_d else d.values
        beta = beta_d
    if c is not None:
        if c.capacity < info.result_nnz:
            raise RuntimeError(
                f"spgemm_fill: user capacity {c.capacity} < result_nnz "
                f"{info.result_nnz} (csr_builder overflow analogue)")
        if c.capacity != plan.c_capacity:
            plan = plan.with_capacity(c.capacity)
    c_values = _numeric(plan, a_values, b_values, d_values, alpha, beta)
    return CSR(values=c_values, rowptr=plan.c_rowptr,
               colind=plan.c_colind[:c_values.shape[0]],
               nnz=plan.c_nnz, shape=plan.shape)


@traced
def spgemm(a_view, b_view, c_capacity: Optional[int] = None):
    """One-shot C = A @ B (compute + fill).

    BSR x BSR operands with compatible blocks take the batched block
    kernel (kernels/bsr.py) and return a BSR result; everything else
    canonicalizes to CSR."""
    from spblas_tpu.formats.bsr import BSR

    a_base, alpha_a, conj_a = _v.fold(a_view)
    b_base, alpha_b, conj_b = _v.fold(b_view)
    if (isinstance(a_base, BSR) and isinstance(b_base, BSR)
            and a_base.block_shape[1] == b_base.block_shape[0]
            and not conj_a and not conj_b):
        import dataclasses

        from spblas_tpu.kernels.bsr import bsr_spgemm
        c = bsr_spgemm(a_base, b_base)
        alpha = alpha_a * alpha_b
        return dataclasses.replace(c, values=c.values * alpha)
    info = spgemm_compute(a_view, b_view, c_capacity=c_capacity)
    return spgemm_fill(info, a_view, b_view)


# ------------------------------------------------------------------ #
# reuse state — rocSPARSE spgemm_state_t parity
# ------------------------------------------------------------------ #

class SpgemmState:
    """Opaque reuse handle for repeated numeric SpGEMM
    (vendor/rocsparse/multiply_spgemm.hpp:28-230).

    Workspace (the plan) is grow-only across calls, like the rocSPARSE
    buffer (multiply_spgemm.hpp:101-105); the user guarantees unchanged
    sparsity between ``numeric`` calls.
    """

    def __init__(self):
        self.info: Optional[OperationInfo] = None
        self._has_d = False

    def symbolic_compute(self, a, b, d=None,
                         c_capacity: Optional[int] = None) -> OperationInfo:
        self.info = spgemm_compute(a, b, d_view=d, c_capacity=c_capacity)
        self._has_d = d is not None
        return self.info

    def symbolic_fill(self, a, b, c: Optional[CSR] = None) -> CSR:
        """Materialize the structure (colind/rowptr) with zero values —
        rocSPARSE stage_symbolic (multiply_spgemm.hpp:150-173)."""
        self._require_info()
        plan = self.info.plan
        if c is not None:
            if c.capacity < self.info.result_nnz:
                # same contract as spgemm_fill: silently truncating the
                # structure (and persisting the truncated plan for every
                # later numeric()) is the csr_builder overflow case
                raise RuntimeError(
                    f"symbolic_fill: user capacity {c.capacity} < "
                    f"result_nnz {self.info.result_nnz} "
                    "(csr_builder overflow analogue)")
            if c.capacity != plan.c_capacity:
                plan = plan.with_capacity(c.capacity)
                self.info = self.info.update(plan=plan)
        cap = plan.c_capacity
        values = jnp.zeros((cap,), dtype=_v.get_ultimate_base(a).dtype)
        return CSR(values=values, rowptr=plan.c_rowptr,
                   colind=plan.c_colind, nnz=plan.c_nnz, shape=plan.shape)

    def numeric(self, a, b, d=None) -> CSR:
        """Numeric re-run with new values, same sparsity
        (multiply_spgemm.hpp:178-214)."""
        self._require_info()
        return spgemm_fill(self.info, a, b, d_view=d)

    def _require_info(self):
        if self.info is None:
            raise RuntimeError(
                "SpgemmState used before symbolic_compute "
                "(mirrors rocsparse_status_invalid_pointer)")


# free-function parity with the reference's reuse API names
def multiply_symbolic_compute(state: SpgemmState, a, b,
                              c_capacity: Optional[int] = None
                              ) -> OperationInfo:
    return state.symbolic_compute(a, b, c_capacity=c_capacity)


def multiply_symbolic_fill(state: SpgemmState, a, b,
                           c: Optional[CSR] = None) -> CSR:
    return state.symbolic_fill(a, b, c)


def multiply_numeric(state: SpgemmState, a, b) -> CSR:
    return state.numeric(a, b)


def multiply_fused(state: SpgemmState, a, b, d,
                   c_capacity: Optional[int] = None) -> CSR:
    """4-argument fused C = alpha*A*B + beta*D
    (multiply_spgemm.hpp:232-317; alpha/beta ride in as scaled views).
    Pass d=None for the null-D shortcut."""
    if d is None:
        state.symbolic_compute(a, b, c_capacity=c_capacity)
        return state.numeric(a, b)
    state.symbolic_compute(a, b, d=d, c_capacity=c_capacity)
    return state.numeric(a, b, d=d)


def spgemm_csc(a_view, b_view, c_capacity: Optional[int] = None):
    """C = A @ B materialized as CSC — the reference's transpose trick
    (spgemm_gustavsons.hpp:97-127): compute CSR of Cᵀ = Bᵀ·Aᵀ, then
    reinterpret as CSC of C at zero cost (views.transposed)."""
    from spblas_tpu import views as _vw
    ct = spgemm(_vw.transposed(b_view), _vw.transposed(a_view),
                c_capacity=c_capacity)
    return _vw.transposed(ct)


def spgemm_chunked(a_view, b_view, rows_per_chunk: int) -> CSR:
    """C = A @ B with the expansion bounded by row chunking.

    The ESC formulation materializes O(total flops) expansion arrays
    (SURVEY.md §7 hard parts); chunking A's rows caps that at the
    per-chunk flop count.  Chunks are padded to a uniform row count so
    every chunk reuses the same compiled stages (capacity buckets keep
    the set of shapes small).
    """
    import numpy as np

    a_base, alpha_a, conj_a = _v.fold(a_view)
    b_base, alpha_b, conj_b = _v.fold(b_view)
    a = to_csr(a_base)
    b = to_csr(b_base)
    if conj_a:
        a = dataclasses.replace(a, values=jnp.conj(a.values))
    if conj_b:
        b = dataclasses.replace(b, values=jnp.conj(b.values))
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"spgemm dimension mismatch: A is {a.shape}, B is {b.shape}")
    alpha = alpha_a * alpha_b
    rows_per_chunk = int(rows_per_chunk)
    rowptr = np.asarray(a.rowptr).astype(np.int64)
    nnz = int(a.nnz)
    vals_l, cols_l, counts = [], [], np.zeros(m + 1, np.int64)
    for r0 in range(0, m, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, m)
        lo = int(min(rowptr[r0], nnz))
        hi = int(min(rowptr[r1], nnz))
        sub_rowptr = np.zeros(rows_per_chunk + 1, np.int64)
        sub_rowptr[: r1 - r0 + 1] = \
            np.minimum(rowptr[r0: r1 + 1], nnz) - lo
        sub_rowptr[r1 - r0 + 1:] = hi - lo
        sub = CSR.from_arrays(a.values[lo:hi], sub_rowptr,
                              a.colind[lo:hi], (rows_per_chunk, k),
                              nnz=hi - lo)
        info = spgemm_compute(sub, b)
        c_chunk = spgemm_fill(info, sub, b)
        cn = info.result_nnz
        vals_l.append(c_chunk.values[:cn])
        cols_l.append(c_chunk.colind[:cn])
        counts[r0 + 1: r1 + 1] = np.diff(
            np.asarray(c_chunk.rowptr)[: r1 - r0 + 1])
    values = jnp.concatenate(vals_l) if vals_l else \
        jnp.zeros((0,), a.dtype)
    colind = jnp.concatenate(cols_l) if cols_l else \
        jnp.zeros((0,), _t.index_dtype)
    c = CSR.from_arrays(values * alpha, np.cumsum(counts), colind,
                        (m, n), nnz=int(values.shape[0]))
    return c
