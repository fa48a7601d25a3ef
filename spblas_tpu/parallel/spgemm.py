"""Distributed two-phase SpGEMM: C = A @ B over row-partitioned operands.

New layer (the reference is single-device, SURVEY.md §2.6); follows the
inspector-executor split the serial SpGEMM already draws
(spblas_tpu.ops.spgemm): **symbolic planning happens once on host**, the
repeated **numeric phase is fully distributed** — a shard_map program in
which each device all-gathers B's values (structure is fixed by the plan;
only values move between devices) and runs a gather·mul·scatter-add into its
own C row block.  This mirrors how rocSPARSE's reuse API amortizes
symbolic cost across numeric re-runs (multiply_spgemm.hpp:150-214), with
the plan itself sharded by C row block.
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
from spblas_tpu.parallel.rowblock import RowBlockCSR, partition_rowblock


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistSpgemmPlan:
    """Per-device numeric plan, leading axis = device (sharded).

    For device d, stream entry s (sorted by (local row, col)):
      src_a (p, scap) — local A entry index on device d
      src_b (p, scap) — index into the flattened all-gathered B values
      valid (p, scap); slot (p, scap) — local C slot (ccap → dropped)
    C structure: c_rowptr (p, mloc+1), c_colind (p, ccap) global columns,
    c_nnz (p,) live counts per device.
    """

    src_a: jax.Array
    src_b: jax.Array
    valid: jax.Array
    slot: jax.Array
    c_rowptr: jax.Array
    c_colind: jax.Array
    c_nnz: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    mloc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def p(self) -> int:
        return int(self.src_a.shape[0])

    @property
    def c_capacity(self) -> int:
        return int(self.c_colind.shape[1])

    @property
    def result_nnz(self) -> int:
        return int(np.asarray(self.c_nnz).sum())


def dist_spgemm_compute(a: RowBlockCSR, b: RowBlockCSR, mesh: Mesh
                        ) -> DistSpgemmPlan:
    """Host-side symbolic phase (inspect): Gustavson expansion + sort per
    C row block, emitted as sharded gather maps.

    The one-time host cost buys a numeric phase that is pure device work;
    result_nnz is known on return (the two-phase allocation handshake).
    """
    p = a.p
    from spblas_tpu.parallel.mesh import check_mesh_matches
    check_mesh_matches(p, mesh, "dist_spgemm_compute")
    if b.p != p:
        raise ValueError(
            f"dist_spgemm: a partitioned for p={p} but b for "
            f"p={b.p}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"spgemm dimension mismatch: A is {a.shape}, B is {b.shape}")
    mloc, lcap_b = a.mloc, b.local_capacity
    nloc_b = b.mloc

    a_cols = np.asarray(a.colind)
    a_rptr = np.asarray(a.rowptr)
    b_cols = np.asarray(b.colind)
    b_rptr = np.asarray(b.rowptr)

    # global B row k → (start, len) in the flattened gathered values
    kk = np.arange(k2)
    bd, bi = kk // nloc_b, kk % nloc_b
    b_start = bd * lcap_b + b_rptr[bd, bi]
    b_len = b_rptr[bd, bi + 1] - b_rptr[bd, bi]

    per_dev = []
    scap = ccap = 1
    for d in range(p):
        r1 = max(0, min((d + 1) * mloc, m) - min(d * mloc, m))
        nnz_d = int(a_rptr[d, r1]) if r1 > 0 else 0
        cols_d = a_cols[d, :nnz_d]
        rows_d = np.repeat(np.arange(r1), np.diff(a_rptr[d, : r1 + 1]))
        # expansion: every (i, k) A entry × every entry of B row k
        counts = b_len[cols_d]
        e_total = int(counts.sum())
        src_a = np.repeat(np.arange(nnz_d), counts)
        local = np.arange(e_total) - np.repeat(
            np.cumsum(counts) - counts, counts)
        src_b = np.repeat(b_start[cols_d], counts) + local
        rows_e = np.repeat(rows_d, counts)
        cols_e = b_cols.reshape(-1)[src_b] if e_total else \
            np.zeros(0, np.int64)
        if int(mloc) * int(n) < (1 << 62):
            # packed single-key threaded sort (native LSD radix) —
            # the 4-key lexsort was the host hot spot at 10M expansion
            from spblas_tpu import native as _nat
            key = rows_e.astype(np.int64) * np.int64(n) + cols_e
            srt = _nat.argsort_i64(key)
            order = srt[0] if srt is not None else \
                np.argsort(key, kind="stable")
        else:
            order = np.lexsort((cols_e, rows_e))
        rows_s, cols_s = rows_e[order], cols_e[order]
        heads = np.concatenate([[True], (rows_s[1:] != rows_s[:-1]) |
                                (cols_s[1:] != cols_s[:-1])]) \
            if e_total else np.zeros(0, bool)
        slots = np.cumsum(heads) - 1
        nnz_c = int(heads.sum())
        c_cols = cols_s[heads] if e_total else np.zeros(0, np.int64)
        c_rows = rows_s[heads] if e_total else np.zeros(0, np.int64)
        c_rptr = np.zeros(mloc + 1, dtype=np.int64)
        np.add.at(c_rptr[1:], c_rows, 1)
        c_rptr = np.cumsum(c_rptr)
        per_dev.append((src_a[order], src_b[order], slots, nnz_c,
                        c_cols, c_rptr))
        scap = max(scap, e_total)
        ccap = max(ccap, nnz_c)
    scap = _t.quantize_capacity(scap)
    ccap = _t.quantize_capacity(ccap)

    P_src_a = np.zeros((p, scap), dtype=np.int64)
    P_src_b = np.zeros((p, scap), dtype=np.int64)
    P_valid = np.zeros((p, scap), dtype=bool)
    P_slot = np.full((p, scap), ccap, dtype=np.int64)
    P_rptr = np.zeros((p, mloc + 1), dtype=np.int64)
    P_cols = np.zeros((p, ccap), dtype=np.int32)
    P_nnz = np.zeros((p,), dtype=np.int32)
    for d, (sa, sb, sl, nnz_c, cc, cr) in enumerate(per_dev):
        e = len(sa)
        P_src_a[d, :e] = sa
        P_src_b[d, :e] = sb
        P_valid[d, :e] = True
        P_slot[d, :e] = sl
        P_rptr[d] = cr
        P_cols[d, :nnz_c] = cc
        P_nnz[d] = nnz_c

    # src_b indexes the FLATTENED all-gathered B values (p * lcap_b
    # padded entries): the p-times-amplified index space can overflow
    # int32 even when each matrix is within the per-matrix 2^31 limit
    # (round-4 review) — fail loudly instead of wrapping negative
    if P_src_b.size and int(P_src_b.max()) >= 2 ** 31:
        raise ValueError(
            f"dist_spgemm: flattened B index space "
            f"{int(P_src_b.max()) + 1} exceeds int32; reduce per-device "
            "B capacity or the device count")
    shard2 = NamedSharding(mesh, P(ROW_AXIS, None))
    shard1 = NamedSharding(mesh, P(ROW_AXIS))
    dput = jax.device_put
    return DistSpgemmPlan(
        src_a=dput(jnp.asarray(P_src_a, dtype=jnp.int32), shard2),
        src_b=dput(jnp.asarray(P_src_b, dtype=jnp.int32), shard2),
        valid=dput(jnp.asarray(P_valid), shard2),
        slot=dput(jnp.asarray(P_slot, dtype=jnp.int32), shard2),
        c_rowptr=dput(jnp.asarray(P_rptr, dtype=_t.offset_dtype), shard2),
        c_colind=dput(jnp.asarray(P_cols, dtype=_t.index_dtype), shard2),
        c_nnz=dput(jnp.asarray(P_nnz), shard1),
        shape=(m, n), mloc=mloc)


def _numeric_kernel(src_a, src_b, valid, slot, a_values, b_values, *,
                    ccap):
    """shard_map body: local slices (1, ...); all-gather B values only."""
    src_a, src_b = src_a[0], src_b[0]
    valid, slot = valid[0], slot[0]
    bg = jax.lax.all_gather(b_values, ROW_AXIS).reshape(-1)  # (p*lcap_b,)
    v = a_values[0][src_a] * bg[src_b]
    v = jnp.where(valid, v, 0)
    out = jnp.zeros((ccap,), dtype=v.dtype).at[slot].add(v, mode="drop")
    return out[None]


def dist_spgemm_numeric(plan: DistSpgemmPlan, a: RowBlockCSR,
                        b: RowBlockCSR, mesh: Mesh) -> RowBlockCSR:
    """Distributed numeric phase (execute): re-runnable with new values of
    unchanged sparsity — the distributed ``multiply_numeric``: gather +
    scatter-add over the expansion maps, B's values all-gathered."""
    from spblas_tpu.parallel.mesh import check_mesh_matches
    check_mesh_matches(plan.p, mesh, "dist_spgemm_numeric")
    ccap = plan.c_capacity
    spec2 = P(ROW_AXIS, None)
    fn = jax.jit(jax.shard_map(
        lambda sa, sb, vl, sl, av, bv: _numeric_kernel(
            sa, sb, vl, sl, av, bv, ccap=ccap),
        mesh=mesh,
        in_specs=(spec2,) * 4 + (spec2, spec2),
        out_specs=spec2))
    c_values = fn(plan.src_a, plan.src_b, plan.valid, plan.slot,
                  a.values, b.values)
    return RowBlockCSR(values=c_values, colind=plan.c_colind,
                       rowptr=plan.c_rowptr, shape=plan.shape,
                       mloc=plan.mloc)


def dist_spgemm(a, b, mesh: Mesh) -> RowBlockCSR:
    """One-shot distributed C = A @ B from global or pre-partitioned
    operands."""
    if not isinstance(a, RowBlockCSR):
        a = partition_rowblock(to_csr(a), mesh)
    if not isinstance(b, RowBlockCSR):
        b = partition_rowblock(to_csr(b), mesh)
    plan = dist_spgemm_compute(a, b, mesh)
    return dist_spgemm_numeric(plan, a, b, mesh)
