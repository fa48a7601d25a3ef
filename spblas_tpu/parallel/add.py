"""Distributed SpADD: C = A + B over row-partitioned operands.

Same inspector-executor split as the distributed SpGEMM: structure union
is planned once on host per row block, the numeric phase is a sharded
scatter-add of both operands' values into the planned slots (pure local
work — row-aligned operands need no communication at all).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spblas_tpu import types as _t
from spblas_tpu.parallel.mesh import ROW_AXIS
from spblas_tpu.parallel.rowblock import RowBlockCSR, partition_rowblock
from spblas_tpu.formats.convert import to_csr


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistAddPlan:
    """slot_a/slot_b (p, lcap_a/b): output slot of each operand entry
    (ccap → padding, dropped); c structure per device."""

    slot_a: jax.Array
    slot_b: jax.Array
    c_rowptr: jax.Array
    c_colind: jax.Array
    c_nnz: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    mloc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def c_capacity(self) -> int:
        return int(self.c_colind.shape[1])


def dist_add_compute(a: RowBlockCSR, b: RowBlockCSR, mesh: Mesh
                     ) -> DistAddPlan:
    if a.shape != b.shape:
        raise ValueError(f"add shape mismatch {a.shape} vs {b.shape}")
    if a.mloc != b.mloc:
        raise ValueError("operands partitioned with different row blocks")
    p, mloc = a.p, a.mloc
    from spblas_tpu.parallel.mesh import check_mesh_matches
    check_mesh_matches(p, mesh, "dist_add_compute")
    if b.p != p:
        raise ValueError(
            f"dist_add: a partitioned for p={p} but b for "
            f"p={b.p}")
    m, n = a.shape
    a_cols = np.asarray(a.colind)
    a_rptr = np.asarray(a.rowptr)
    b_cols = np.asarray(b.colind)
    b_rptr = np.asarray(b.rowptr)
    lcap_a, lcap_b = a.local_capacity, b.local_capacity

    per_dev = []
    ccap = 1
    for d in range(p):
        r1 = max(0, min((d + 1) * mloc, m) - min(d * mloc, m))
        na = int(a_rptr[d, r1])
        nb = int(b_rptr[d, r1])
        rows = np.concatenate([
            np.repeat(np.arange(r1), np.diff(a_rptr[d, : r1 + 1])),
            np.repeat(np.arange(r1), np.diff(b_rptr[d, : r1 + 1]))])
        cols = np.concatenate([a_cols[d, :na], b_cols[d, :nb]])
        src = np.concatenate([np.arange(na), lcap_a + np.arange(nb)])
        order = np.lexsort((cols, rows))
        rows_s, cols_s, src_s = rows[order], cols[order], src[order]
        heads = np.concatenate([[True], (rows_s[1:] != rows_s[:-1]) |
                                (cols_s[1:] != cols_s[:-1])]) \
            if len(rows_s) else np.zeros(0, bool)
        slots = np.cumsum(heads) - 1
        nnz_c = int(heads.sum())
        c_rptr = np.zeros(mloc + 1, np.int64)
        np.add.at(c_rptr[1:], rows_s[heads], 1)
        per_dev.append((src_s, slots, nnz_c, cols_s[heads],
                        np.cumsum(c_rptr)))
        ccap = max(ccap, nnz_c)
    ccap = _t.quantize_capacity(ccap)

    P_rptr = np.zeros((p, mloc + 1), np.int64)
    P_cols = np.zeros((p, ccap), np.int32)
    P_nnz = np.zeros((p,), np.int32)
    slot_a = np.full((p, lcap_a), ccap, dtype=np.int64)
    slot_b = np.full((p, lcap_b), ccap, dtype=np.int64)
    for d, (src_s, slots, nnz_c, cc, cr) in enumerate(per_dev):
        a_mask = src_s < lcap_a
        slot_a[d, src_s[a_mask]] = slots[a_mask]
        slot_b[d, src_s[~a_mask] - lcap_a] = slots[~a_mask]
        P_rptr[d] = cr
        P_cols[d, :nnz_c] = cc
        P_nnz[d] = nnz_c

    shard2 = NamedSharding(mesh, P(ROW_AXIS, None))
    shard1 = NamedSharding(mesh, P(ROW_AXIS))
    dput = jax.device_put
    return DistAddPlan(
        slot_a=dput(jnp.asarray(slot_a, jnp.int32), shard2),
        slot_b=dput(jnp.asarray(slot_b, jnp.int32), shard2),
        c_rowptr=dput(jnp.asarray(P_rptr, _t.offset_dtype), shard2),
        c_colind=dput(jnp.asarray(P_cols, _t.index_dtype), shard2),
        c_nnz=dput(jnp.asarray(P_nnz), shard1),
        shape=(m, n), mloc=mloc)


def dist_add_numeric(plan: DistAddPlan, a: RowBlockCSR, b: RowBlockCSR,
                     mesh: Mesh, alpha=1.0, beta=1.0) -> RowBlockCSR:
    """C = alpha*A + beta*B into the planned structure — purely local."""
    ccap = plan.c_capacity
    # scalars PROMOTE the output dtype instead of truncating to each
    # operand's (casting alpha to a.dtype dropped complex parts against
    # real operands and rounded fractional scales against integer-
    # valued containers — round-4 review)
    out_dtype = jnp.result_type(a.dtype, b.dtype,
                                jnp.result_type(alpha),
                                jnp.result_type(beta))
    alpha = jnp.asarray(alpha, out_dtype)
    beta = jnp.asarray(beta, out_dtype)

    def body(sa, sb, av, bv):
        out = jnp.zeros((ccap,), out_dtype)
        out = out.at[sa[0]].add(alpha * av[0], mode="drop")
        out = out.at[sb[0]].add(beta * bv[0], mode="drop")
        return out[None]

    spec = P(ROW_AXIS, None)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                               out_specs=spec))
    c_values = fn(plan.slot_a, plan.slot_b, a.values, b.values)
    return RowBlockCSR(values=c_values, colind=plan.c_colind,
                       rowptr=plan.c_rowptr, shape=plan.shape,
                       mloc=plan.mloc)


def dist_add(a, b, mesh: Mesh, alpha=1.0, beta=1.0) -> RowBlockCSR:
    if not isinstance(a, RowBlockCSR):
        a = partition_rowblock(to_csr(a), mesh)
    if not isinstance(b, RowBlockCSR):
        b = partition_rowblock(to_csr(b), mesh)
    plan = dist_add_compute(a, b, mesh)
    return dist_add_numeric(plan, a, b, mesh, alpha=alpha, beta=beta)
