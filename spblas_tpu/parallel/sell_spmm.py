"""Distributed UNSTRUCTURED SpMM: per-shard SELL plans under shard_map.

Each device's row block gets its own degree-bucketed SELL layout
(kernels/sell.py); the per-device layouts are padded to one uniform
bucket geometry so the mesh runs one SPMD program, and B is gathered
with one ``all_gather``.

No reference counterpart (SURVEY.md §2.6); extends the north-star
distributed SpMV to unstructured SpMM.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spblas_tpu.formats.convert import to_csr
from spblas_tpu.parallel.mesh import ROW_AXIS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistSellPlan:
    """Stacked per-device SELL plans with a UNIFORM bucket geometry
    (bucket widths = union over devices, per-bucket row counts padded
    to the device maximum; pad rows gather B row 0 with value 0)."""

    bucket_values: Tuple[jax.Array, ...]   # each (p, mb, Wb)
    bucket_cols: Tuple[jax.Array, ...]     # each (p, mb, Wb) int32
    pos: jax.Array                         # (p, mloc) int32 concat slot
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    mloc: int = dataclasses.field(metadata=dict(static=True))
    nloc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def p(self) -> int:
        return int(self.pos.shape[0])


def partition_sell(a, mesh: Mesh) -> DistSellPlan:
    """Host inspect step: one SELL bucketing per row block, padded to a
    uniform SPMD geometry."""
    from spblas_tpu.kernels.sell import build_sell_plan
    from spblas_tpu.formats.csr import CSR

    a = to_csr(a)
    p = mesh.devices.size
    m, n = a.shape
    mloc = -(-m // p)
    nloc = -(-n // p)
    nnz = int(a.nnz)
    rowptr = np.minimum(np.asarray(a.rowptr).astype(np.int64), nnz)
    colind = np.asarray(a.colind)[:nnz]
    values = np.asarray(a.values)[:nnz]

    from spblas_tpu.parallel.rowblock import local_rowptr
    plans = []
    for d in range(p):
        lo, hi, sub_rp = local_rowptr(rowptr, d, mloc, m)
        sub = CSR.from_arrays(values[lo:hi], sub_rp, colind[lo:hi],
                              (mloc, n), nnz=hi - lo)
        plans.append(build_sell_plan(sub))

    widths = sorted({b.width for q in plans for b in q.buckets})
    bucket_values, bucket_cols = [], []
    # per device: map its buckets by width, pad row counts to the max
    per_dev = [{b.width: b for b in q.buckets} for q in plans]
    mb_of = {w: max((int(d[w].values.shape[0]) for d in per_dev
                     if w in d), default=1) for w in widths}
    pos = np.zeros((p, mloc), np.int64)
    for w in widths:
        mb = mb_of[w]
        vs = np.zeros((p, mb, w), values.dtype)
        cs = np.zeros((p, mb, w), np.int32)
        for d in range(p):
            b = per_dev[d].get(w)
            if b is None:
                continue
            nv = np.asarray(b.values)
            vs[d, : nv.shape[0]] = nv
            cs[d, : nv.shape[0]] = np.asarray(b.cols)
        bucket_values.append(vs)
        bucket_cols.append(cs)
    # per-device pos: bucket-concat offsets differ per device in the
    # single-device plan; recompute against the UNIFORM geometry
    total = sum(mb_of[w] for w in widths)
    for d in range(p):
        q = plans[d]
        qpos = np.asarray(q.pos).astype(np.int64)
        # map each device-local concat slot -> uniform concat slot
        remap = np.full(sum(int(b.values.shape[0])
                            for b in q.buckets) + 1, total, np.int64)
        off_local = 0
        off_uniform = 0
        for w in widths:
            b = per_dev[d].get(w)
            nb = int(b.values.shape[0]) if b is not None else 0
            remap[off_local: off_local + nb] = \
                off_uniform + np.arange(nb)
            off_local += nb
            off_uniform += mb_of[w]
        pos[d] = remap[np.minimum(qpos, len(remap) - 1)]

    sharding = NamedSharding(mesh, P(ROW_AXIS))
    put = lambda arr: jax.device_put(arr, sharding)
    return DistSellPlan(
        bucket_values=tuple(put(v) for v in bucket_values),
        bucket_cols=tuple(put(c) for c in bucket_cols),
        pos=put(pos.astype(np.int32)),
        shape=(m, n), mloc=mloc, nloc=nloc)


def dist_sell_spmm(plan: DistSellPlan, b: jax.Array, mesh: Mesh
                   ) -> jax.Array:
    """C = A @ B for dense B (p*nloc, k) row-sharded; C is (p*mloc, k)
    row-sharded.  Local compute is the accumulated-row-gather SELL form
    (kernels/sell.py) over the all-gathered B."""
    p, mloc, nloc = plan.p, plan.mloc, plan.nloc
    from spblas_tpu.parallel.mesh import check_mesh_matches
    check_mesh_matches(p, mesh, "dist_sell_spmm")
    n = plan.shape[1]
    if b.shape[0] != p * nloc:
        raise ValueError(
            f"operand leading dim {b.shape[0]} != padded n {p * nloc}")

    def body(pos, bloc, *buckets):
        k = bloc.shape[-1]
        nb = len(buckets) // 2
        vals = buckets[:nb]
        cols = buckets[nb:]
        bg = jax.lax.all_gather(bloc, ROW_AXIS).reshape(-1, k)[:n]
        from spblas_tpu.kernels.sell import bucket_matmul
        parts = [bucket_matmul(vv[0], cc[0], bg)
                 for vv, cc in zip(vals, cols)]
        dt = jnp.result_type(*parts) if parts else bg.dtype
        parts = [q.astype(dt) for q in parts]
        parts.append(jnp.zeros((1, k), dt))
        stacked = jnp.concatenate(parts, axis=0)
        return stacked[pos[0]]

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROW_AXIS),) * (2 + 2 * len(plan.bucket_values)),
        out_specs=P(ROW_AXIS)))
    return fn(plan.pos, b, *plan.bucket_values, *plan.bucket_cols)
