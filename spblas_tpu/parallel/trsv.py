"""Distributed SpTRSV: block substitution over row-partitioned factors.

No reference counterpart (single-device reference; vendors hide even the
serial analysis).  Algorithm: lower-triangular A row-partitioned into p
blocks; step d solves the diagonal block on device d with its local
level schedule, the solved piece is broadcast (psum of a masked vector —
one collective per step), and every later device folds it into its rhs
through its off-diagonal entries.  p steps, each: one local level sweep
+ one collective; the standard block forward/backward substitution.

The inspect phase builds, per device: a padded local level schedule
(uniform (L, R, W) across devices so the mesh runs one SPMD program)
and the off-diagonal entries as global-column COO.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spblas_tpu import types as _t
from spblas_tpu.formats.convert import to_csr
from spblas_tpu.parallel.mesh import ROW_AXIS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistTrsvPlan:
    """Per-device arrays (leading axis p, sharded over rows).

    Local diagonal-block schedule (sentinel mloc rows are padding):
      rows (p, L, R); eidx/evalid/cols (p, L, R, W) — eidx into the
      device's local value slice lvals (p, lcap); ldiag (p, L, R).
    Off-diagonal entries: ovals (p, ocap), ocols (p, ocap) global
    columns, orows (p, ocap) local row (sentinel mloc = padding).
    """

    rows: jax.Array
    eidx: jax.Array
    evalid: jax.Array
    cols: jax.Array
    ldiag: jax.Array
    lvals: jax.Array
    ovals: jax.Array
    ocols: jax.Array
    orows: jax.Array
    lower: bool = dataclasses.field(metadata=dict(static=True))
    unit_diag: bool = dataclasses.field(metadata=dict(static=True))
    mloc: int = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def p(self) -> int:
        return int(self.rows.shape[0])


def dist_triangular_solve_inspect(a, mesh: Mesh, uplo: str = "lower",
                                  diag: str = "explicit") -> DistTrsvPlan:
    from spblas_tpu import native

    a = to_csr(a)
    m, n = a.shape
    if m != n:
        raise ValueError("triangular solve requires square A")
    from spblas_tpu.ops.triangular_solve import _check_diag, _check_uplo
    lower = _check_uplo(uplo)
    unit = _check_diag(diag)
    p = mesh.devices.size
    mloc = -(-m // p)
    nnz = int(a.nnz)
    rowptr = np.asarray(a.rowptr).astype(np.int64)
    lo = np.minimum(rowptr[:-1], nnz)
    hi = np.minimum(rowptr[1:], nnz)
    g_rows = np.repeat(np.arange(m), hi - lo)
    g_cols = np.asarray(a.colind)[:nnz].astype(np.int64)
    g_vals = np.asarray(a.values)[:nnz]
    dev = g_rows // mloc
    dev_c = g_cols // mloc
    diag_blk = dev == dev_c

    per = []
    L = R = W = ocap = lcap = 1
    for d in range(p):
        sel = (dev == d) & diag_blk
        lv = g_vals[sel]
        lr = g_rows[sel] - d * mloc
        lc = g_cols[sel] - d * mloc
        r1 = max(0, min((d + 1) * mloc, m) - min(d * mloc, m))
        # local CSR of the diagonal block
        lrp = np.zeros(r1 + 1, np.int64)
        np.add.at(lrp[1:], lr, 1)
        lrp = np.cumsum(lrp)
        order = np.lexsort((lc, lr))
        lv, lc2 = lv[order], lc[order].astype(np.int32)
        levels, diag_pos, nl = native.level_schedule(
            r1, len(lv), lrp, lc2, lower, unit)
        off_mask = (lc2 < np.repeat(np.arange(r1), np.diff(lrp))) \
            if lower else \
            (lc2 > np.repeat(np.arange(r1), np.diff(lrp)))
        # off-diagonal (other blocks) entries of this device
        osel = (dev == d) & ~diag_blk
        per.append((lv, lc2, lrp, levels, diag_pos, nl, off_mask,
                    g_vals[osel], g_cols[osel], g_rows[osel] - d * mloc))
        L = max(L, nl)
        lcap = max(lcap, len(lv))
        ocap = max(ocap, int(osel.sum()))
        if r1:
            cnt = np.bincount(levels, minlength=max(nl, 1))
            R = max(R, int(cnt.max()))
            rowlen = np.zeros(r1, np.int64)
            np.add.at(rowlen, np.repeat(np.arange(r1), np.diff(lrp)),
                      off_mask)
            W = max(W, int(rowlen.max()) if r1 else 1, 1)

    rows_a = np.full((p, L, R), mloc, np.int32)
    eidx_a = np.zeros((p, L, R, W), np.int32)
    evalid_a = np.zeros((p, L, R, W), bool)
    cols_a = np.zeros((p, L, R, W), np.int32)
    ldiag_a = np.full((p, L, R), -1, np.int32)
    lvals_a = np.zeros((p, lcap), g_vals.dtype)
    ovals_a = np.zeros((p, ocap), g_vals.dtype)
    ocols_a = np.zeros((p, ocap), np.int32)
    orows_a = np.full((p, ocap), mloc, np.int32)
    for d, (lv, lc2, lrp, levels, diag_pos, nl, off_mask, ov, oc, orw) \
            in enumerate(per):
        r1 = len(lrp) - 1
        lvals_a[d, :len(lv)] = lv
        ovals_a[d, :len(ov)] = ov
        ocols_a[d, :len(oc)] = oc
        orows_a[d, :len(orw)] = orw
        if r1 == 0:
            continue
        counts = np.bincount(levels, minlength=max(nl, 1))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        order = np.argsort(levels, kind="stable")
        j_of = np.empty(r1, np.int64)
        j_of[order] = np.arange(r1) - np.repeat(starts, counts)
        rows_a[d, levels, j_of] = np.arange(r1, dtype=np.int32)
        ldiag_a[d, levels, j_of] = diag_pos.astype(np.int32)
        row_of = np.repeat(np.arange(r1), np.diff(lrp))
        e_all = np.arange(len(lv))
        c = np.cumsum(off_mask)
        base = np.concatenate([[0], c])[lrp[:-1]]
        rank = (c - 1) - np.repeat(base, np.diff(lrp))
        om = off_mask.astype(bool)
        lv_e = levels[row_of[om]]
        j_e = j_of[row_of[om]]
        r_e = rank[om]
        eidx_a[d, lv_e, j_e, r_e] = e_all[om].astype(np.int32)
        evalid_a[d, lv_e, j_e, r_e] = True
        cols_a[d, lv_e, j_e, r_e] = lc2[om]

    shard = lambda x: jax.device_put(  # noqa: E731
        jnp.asarray(x), NamedSharding(
            mesh, P(ROW_AXIS, *([None] * (np.ndim(x) - 1)))))
    return DistTrsvPlan(
        rows=shard(rows_a), eidx=shard(eidx_a), evalid=shard(evalid_a),
        cols=shard(cols_a), ldiag=shard(ldiag_a), lvals=shard(lvals_a),
        ovals=shard(ovals_a), ocols=shard(ocols_a), orows=shard(orows_a),
        lower=lower, unit_diag=unit, mloc=mloc, shape=(m, n))


def dist_triangular_solve(plan: DistTrsvPlan, b: jax.Array, mesh: Mesh
                          ) -> jax.Array:
    """x = A^{-1} b with b (p*mloc,) row-sharded; returns x row-sharded."""
    p, mloc = plan.p, plan.mloc
    from spblas_tpu.parallel.mesh import check_mesh_matches
    check_mesh_matches(p, mesh, "dist_triangular_solve")
    if b.shape[0] != p * mloc:
        raise ValueError(f"b length {b.shape[0]} != padded {p * mloc}")
    L = plan.rows.shape[1]
    steps = range(p) if plan.lower else range(p - 1, -1, -1)

    def local_solve(rows, eidx, evalid, cols, ldiag, lvals, rhs):
        def body(lv, x):
            r = rows[lv]
            av = jnp.where(evalid[lv], lvals[eidx[lv]], 0)
            dot = jnp.sum(av * x[cols[lv]], axis=-1)
            dpos = ldiag[lv]
            dval = jnp.where(dpos >= 0, lvals[jnp.maximum(dpos, 0)], 1)
            xi = (rhs[jnp.minimum(r, mloc - 1)] - dot) / dval
            return x.at[r].set(xi, mode="drop")
        x0 = jnp.zeros((mloc,), rhs.dtype)
        return jax.lax.fori_loop(0, L, body, x0)

    def kernel(rows, eidx, evalid, cols, ldiag, lvals, ovals, ocols,
               orows, bl):
        d = jax.lax.axis_index(ROW_AXIS)
        (rows, eidx, evalid, cols, ldiag, lvals, ovals, ocols, orows) = (
            rows[0], eidx[0], evalid[0], cols[0], ldiag[0], lvals[0],
            ovals[0], ocols[0], orows[0])
        x_glob = jnp.zeros((p * mloc,), bl.dtype)
        for step in steps:
            # fold already-known x through this device's off-diag entries
            adj = jax.ops.segment_sum(ovals * x_glob[ocols], orows,
                                      num_segments=mloc)
            x_loc = local_solve(rows, eidx, evalid, cols, ldiag, lvals,
                                bl - adj)
            piece = jnp.where(d == step, x_loc, 0)
            piece = jax.lax.psum(piece, ROW_AXIS)       # broadcast solver's
            x_glob = jax.lax.dynamic_update_slice(
                x_glob, piece, (step * mloc,))
        return jax.lax.dynamic_slice(x_glob, (d * mloc,), (mloc,))

    spec = {1: P(ROW_AXIS), 2: P(ROW_AXIS, None),
            3: P(ROW_AXIS, None, None), 4: P(ROW_AXIS, None, None, None)}
    in_specs = tuple(spec[a.ndim] for a in (
        plan.rows, plan.eidx, plan.evalid, plan.cols, plan.ldiag,
        plan.lvals, plan.ovals, plan.ocols, plan.orows)) + (P(ROW_AXIS),)
    fn = jax.jit(jax.shard_map(kernel, mesh=mesh, in_specs=in_specs,
                               out_specs=P(ROW_AXIS), check_vma=False))
    return fn(plan.rows, plan.eidx, plan.evalid, plan.cols, plan.ldiag,
              plan.lvals, plan.ovals, plan.ocols, plan.orows, b)
