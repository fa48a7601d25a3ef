"""SpTRSV: solve op(A) x = b for triangular sparse A.

Re-design of the reference row-sweep substitution
(include/spblas/algorithms/triangular_solve_impl.hpp:44-93) whose rows are
strictly sequential.  The reference delegates parallelization to vendors
(``optimize_trsv`` hooks, vendor/onemkl_sycl/triangular_solve_impl.hpp:69-70);
here the **inspect phase performs level-set analysis of the dependency DAG**
— rows whose dependencies all live in earlier levels solve together — and
the execute phase is a jitted ``fori_loop`` over levels, each level a fully
vector-parallel batched row solve (SURVEY.md §7 step 6).

Triangle/diagonal semantics mirror detail/triangular_types.hpp:5-23:
``uplo`` in {"lower", "upper"}; ``diag`` in {"explicit", "unit"} (implicit
unit diagonal — diagonal entries are not read).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from spblas_tpu import views as _v
from spblas_tpu.formats.convert import to_csr
from spblas_tpu.info import OperationInfo
from spblas_tpu.utils.logging import traced


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrsvPlan:
    """Level schedule in *ragged* form: one flat off-diagonal entry
    stream sorted by (level, row) plus per-level offsets, and one flat
    row stream sorted by level.

    Memory is O(nnz + m + L) — a single dense row or one fat level only
    widens the per-level *slice caps* (``e_cap`` additive in entries,
    ``r_cap`` in rows), never a (levels x rows x width) product (the
    first version of this plan inflated multiplicatively).
    Serializable and reusable across numeric re-runs (SURVEY.md §5.4).
    """

    ent_idx: jax.Array     # (E_pad,) int32 into values
    ent_col: jax.Array     # (E_pad,) int32
    ent_slot: jax.Array    # (E_pad,) int32 row slot within its level
    lv_estart: jax.Array   # (L+1,) int32 entry-stream offsets
    row_ids: jax.Array     # (m_pad,) int32 rows sorted by level
    diag_idx: jax.Array    # (m_pad,) int32 aligned with row_ids; -1 unit
    lv_rstart: jax.Array   # (L+1,) int32 row-stream offsets
    e_cap: int = dataclasses.field(metadata=dict(static=True))
    r_cap: int = dataclasses.field(metadata=dict(static=True))
    uplo: str = dataclasses.field(metadata=dict(static=True))
    unit_diag: bool = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_levels(self) -> int:
        return int(self.lv_estart.shape[0]) - 1


@traced
def triangular_solve_inspect(a_view, uplo: str = "lower",
                             diag: str = "explicit") -> OperationInfo:
    """Level-set analysis (host-side) — the work vendors hide inside
    ``optimize_trsv``.  Returns an info whose plan drives the solve.
    """
    import time as _time
    from spblas_tpu.utils.profiling import record_phase
    a = to_csr(_v.get_ultimate_base(a_view))
    m, n = a.shape
    if m != n:
        raise ValueError(f"triangular_solve requires square A, got {a.shape}")
    lower = _check_uplo(uplo)
    unit = _check_diag(diag)
    _t0 = _time.perf_counter()
    rowptr = np.asarray(a.rowptr).astype(np.int64)
    colind = np.asarray(a.colind)
    nnz = int(a.nnz)
    record_phase("trsv_inspect", "pull_s", _time.perf_counter() - _t0)

    # level-set analysis in the native inspector runtime (C++ via ctypes,
    # numpy fallback) — the work vendors bury in optimize_trsv
    _t0 = _time.perf_counter()
    from spblas_tpu import native
    levels, diag_pos, num_levels = native.level_schedule(
        m, nnz, rowptr, colind, lower, unit)
    record_phase("trsv_inspect", "schedule_s", _time.perf_counter() - _t0)
    _t0 = _time.perf_counter()

    # ragged schedule assembly from (levels, diag_pos)
    lo = np.minimum(rowptr[:-1], nnz)
    hi = np.minimum(rowptr[1:], nnz)
    row_of = np.repeat(np.arange(m), hi - lo)          # per live entry
    eidx_all = np.arange(nnz, dtype=np.int64)
    cols_all = colind[:nnz].astype(np.int64) if nnz else \
        np.zeros(0, np.int64)
    off = (cols_all < row_of) if nnz else np.zeros(0, bool)
    if not lower:
        off = (cols_all > row_of) if nnz else off
    num_levels = max(num_levels, 1)

    # rows sorted by level
    counts = np.bincount(levels, minlength=num_levels) if m else \
        np.zeros(num_levels, np.int64)
    lv_rstart = np.concatenate([[0], np.cumsum(counts)])
    order = np.argsort(levels, kind="stable") if m else \
        np.zeros(0, np.int64)
    j_of = np.empty(max(m, 1), np.int64)
    j_of[order] = np.arange(m) - np.repeat(lv_rstart[:-1], counts)
    r_cap = max(int(counts.max()) if m else 0, 1)

    # off-diag entries sorted by (level, row)
    e_rows = row_of[off]
    e_lv = levels[e_rows] if m else np.zeros(0, np.int64)
    e_order = np.lexsort((e_rows, e_lv)) if len(e_rows) else \
        np.zeros(0, np.int64)
    e_counts = np.bincount(e_lv, minlength=num_levels) if len(e_rows) \
        else np.zeros(num_levels, np.int64)
    lv_estart = np.concatenate([[0], np.cumsum(e_counts)])
    e_cap = max(int(e_counts.max()), 1)

    ent_idx = eidx_all[off][e_order]
    ent_col = cols_all[off][e_order]
    ent_slot = j_of[e_rows][e_order]
    # pad tails so every dynamic slice of size e_cap / r_cap is in-bounds
    epad = np.zeros(e_cap, np.int64)
    ent_idx = np.concatenate([ent_idx, epad])
    ent_col = np.concatenate([ent_col, epad])
    ent_slot = np.concatenate([ent_slot, epad])
    row_ids = np.concatenate([np.arange(m, dtype=np.int64)[order],
                              np.full(r_cap, m, np.int64)])
    dpos = np.concatenate([diag_pos.astype(np.int64)[order] if m else
                           np.zeros(0, np.int64),
                           np.full(r_cap, -1, np.int64)])

    record_phase("trsv_inspect", "ragged_pack_s",
                 _time.perf_counter() - _t0)

    _t0 = _time.perf_counter()
    (ent_idx_d, ent_col_d, ent_slot_d, lv_estart_d, row_ids_d, dpos_d,
     lv_rstart_d) = jax.device_put(tuple(
         arr.astype(np.int32) for arr in (
             ent_idx, ent_col, ent_slot, lv_estart, row_ids, dpos,
             lv_rstart)))
    record_phase("trsv_inspect", "upload_s", _time.perf_counter() - _t0)

    plan = TrsvPlan(
        ent_idx=ent_idx_d,
        ent_col=ent_col_d,
        ent_slot=ent_slot_d,
        lv_estart=lv_estart_d,
        row_ids=row_ids_d,
        diag_idx=dpos_d,
        lv_rstart=lv_rstart_d,
        e_cap=int(e_cap), r_cap=int(r_cap),
        uplo="lower" if lower else "upper",
        unit_diag=unit, m=m)
    return OperationInfo(result_shape=(m, 1), result_nnz=m, plan=plan)


@jax.jit
def _trsv_execute(plan: TrsvPlan, values, b, alpha):
    """Jitted level sweep over the ragged schedule: each level slices a
    fixed e_cap window of the entry stream (masked to the live count),
    segment-sums the off-diagonal dots per row slot, and solves its rows
    in parallel.

    The per-level cost is dominated by per-op overhead, so the streams
    are interleaved into ONE (3, E) / (2, R) array each and sliced once
    per level (two dynamic slices per level instead of five)."""
    m = plan.m
    e_cap, r_cap = plan.e_cap, plan.r_cap
    ent3 = jnp.stack([plan.ent_idx, plan.ent_col, plan.ent_slot])
    rows2 = jnp.stack([plan.row_ids, plan.diag_idx])

    def body(lv, x):
        es = plan.lv_estart[lv]
        en = plan.lv_estart[lv + 1] - es
        zero = jnp.zeros((), es.dtype)   # x64: match index dtypes
        sl = jax.lax.dynamic_slice(ent3, (zero, es), (3, e_cap))
        eidx, cols, slot = sl[0], sl[1], sl[2]
        ev = jnp.arange(e_cap) < en
        av = jnp.where(ev, values[eidx] * alpha * x[cols], 0)
        dot = jax.ops.segment_sum(av, jnp.where(ev, slot, r_cap - 1),
                                  num_segments=r_cap)

        rs = plan.lv_rstart[lv]
        rn = plan.lv_rstart[lv + 1] - rs
        rd = jax.lax.dynamic_slice(rows2, (zero, rs), (2, r_cap))
        rows, dpos = rd[0], rd[1]
        rv = jnp.arange(r_cap) < rn
        rows = jnp.where(rv, rows, m)
        # implicit unit diagonal of alpha*A is alpha itself
        diag = jnp.where(dpos >= 0, values[jnp.maximum(dpos, 0)], 1) * alpha
        xi = (b[jnp.minimum(rows, m - 1)] - dot) / diag
        return x.at[rows].set(xi, mode="drop")

    x0 = jnp.zeros((m,), dtype=jnp.result_type(values.dtype, b.dtype,
                                               alpha.dtype))
    return jax.lax.fori_loop(0, plan.num_levels, body, x0)


@traced
def triangular_solve(a_view, b, uplo: str = "lower",
                     diag: str = "explicit",
                     info: Optional[OperationInfo] = None) -> jax.Array:
    """x = op(A)^{-1} b.  Pass ``info`` from
    :func:`triangular_solve_inspect` to amortize the level analysis
    (the inspector-executor split the reference reserves for vendors)."""
    base, alpha, conj = _v.fold(a_view)
    a = to_csr(base)
    if info is None:
        info = triangular_solve_inspect(a, uplo=uplo, diag=diag)
    plan: TrsvPlan = info.plan
    # a supplied info must agree with the call's triangle/diag tags —
    # silently solving the OTHER triangle is worse than an error
    # (round-4 review; the reference static_asserts its tags,
    # triangular_solve_impl.hpp:46-47)
    if plan.uplo != ("lower" if _check_uplo(uplo) else "upper"):
        raise ValueError(
            f"triangular_solve: info was inspected with "
            f"uplo={plan.uplo!r} but called with uplo={uplo!r}")
    if plan.unit_diag != _check_diag(diag):
        plan_diag = "unit" if plan.unit_diag else "explicit"
        raise ValueError(
            f"triangular_solve: info was inspected with "
            f"diag={plan_diag!r} but called with diag={diag!r}")
    b = jnp.asarray(b)
    if b.shape[0] != plan.m:
        raise ValueError(
            f"triangular_solve: b length {b.shape[0]} != m {plan.m}")
    values = jnp.conj(a.values) if conj else a.values
    return _trsv_execute(plan, values, b, alpha)


def _check_uplo(uplo: str) -> bool:
    if uplo not in ("lower", "upper"):
        raise ValueError(f"uplo must be 'lower' or 'upper', got {uplo!r}")
    return uplo == "lower"


def _check_diag(diag: str) -> bool:
    if diag not in ("explicit", "unit"):
        raise ValueError(f"diag must be 'explicit' or 'unit', got {diag!r}")
    return diag == "unit"
