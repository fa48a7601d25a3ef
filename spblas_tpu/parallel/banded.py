"""Distributed banded SpMV/SpMM: halo exchange + local band panels.

The BASELINE.json north-star configuration: a row-partitioned banded
matrix where device d's rows touch only columns
[d*mloc - h, (d+1)*mloc + h) — so the only communication per multiply is
a ppermute of the h-wide x edges with the two ring neighbors, which XLA
overlaps with the local sweep.  Compare `dist_csr.DistCSR`'s general
rotation pipeline: the banded structure shrinks the exchanged volume
from O(n) to O(h) per device.

Local layout: each 128-row block of a device's rows is a dense
(128, 128 + 2h) panel over the block's column window, so the local
product is a batched panel-times-window contraction with no index
traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spblas_tpu.formats.convert import to_csr
from spblas_tpu.formats.csr import CSR, host_row_ids
from spblas_tpu.parallel.mesh import ROW_AXIS

_R = 128  # rows per panel


def band_halfwidth(a: CSR) -> int:
    """Max |col - row| over live entries (host-side, numpy only)."""
    nnz = int(a.nnz)
    if nnz == 0:
        return 0
    rows = host_row_ids(a.rowptr, nnz, a.shape[0])
    cols = np.asarray(a.colind)[:nnz]
    return int(np.abs(cols - rows).max())


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistBandPlan:
    """panels (p, nblk_loc*128, w) sharded over the row axis; device d's
    panel block i covers global rows d*mloc + [i*128, (i+1)*128) and
    global columns d*mloc + i*128 + [−h, 128+h)."""

    panels: jax.Array
    h: int = dataclasses.field(metadata=dict(static=True))
    mloc: int = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def p(self) -> int:
        return int(self.panels.shape[0])

    @property
    def width(self) -> int:
        return int(self.panels.shape[2])


def partition_band(a, mesh: Mesh) -> DistBandPlan:
    """Host inspect: partition a banded square matrix into per-device
    dense panels."""
    a = to_csr(a)
    m, n = a.shape
    if m != n:
        raise ValueError("distributed band requires a square matrix")
    p = mesh.devices.size
    h = band_halfwidth(a)
    mloc = -(-m // p)
    mloc = -(-mloc // _R) * _R   # whole panels per device
    if h > mloc:
        raise ValueError(
            f"band half-width {h} exceeds local rows {mloc}; "
            "use fewer devices or the general DistCSR path")
    w = _R + 2 * h
    nnz = int(a.nnz)
    rows = host_row_ids(a.rowptr, nnz, m)
    cols = np.asarray(a.colind)[:nnz]
    vals = np.asarray(a.values)[:nnz]

    panels = np.zeros((p, mloc, w), dtype=vals.dtype)
    dev = rows // mloc
    r_loc = rows % mloc
    # panel-local column: global col - (dev*mloc + blk*128 - h)
    c_loc = cols - dev * mloc - (r_loc // _R) * _R + h
    if not ((c_loc >= 0) & (c_loc < w)).all():
        raise ValueError("entry outside band window")
    panels[dev, r_loc, c_loc] = vals
    shard = NamedSharding(mesh, P(ROW_AXIS, None, None))
    return DistBandPlan(panels=jax.device_put(panels, shard),
                        h=h, mloc=mloc, shape=(m, n))


def band_sweep(panels: jax.Array, xp: jax.Array) -> jax.Array:
    """Local panel product: out[i*128 + r] = sum_c panels[i*128 + r, c]
    * xp[i*128 + c] for xp = [left halo | local x | right halo] (a
    vector, or a (rows, k) matrix for SpMM)."""
    nblk = panels.shape[0] // _R
    w = panels.shape[1]
    chunks = -(-w // _R)
    tail = xp.shape[1:]
    need = (nblk + chunks) * _R
    xq = jnp.pad(xp, [(0, need - xp.shape[0])] + [(0, 0)] * len(tail))
    x2 = xq.reshape((nblk + chunks, _R) + tail)
    # windows[i, c] = xp[i*128 + c]: shifted block views, no gather
    win = jnp.concatenate([x2[k: k + nblk] for k in range(chunks)],
                          axis=1)[:, :w]
    pan = panels.reshape(nblk, _R, w)
    spec = "brw,bw->br" if not tail else "brw,bwk->brk"
    out = jnp.einsum(spec, pan, win,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape((nblk * _R,) + tail)


def _halo_apply(plan: DistBandPlan, v: jax.Array, mesh: Mesh,
                name: str) -> jax.Array:
    p, mloc, h = plan.p, plan.mloc, plan.h
    from spblas_tpu.parallel.mesh import check_mesh_matches
    check_mesh_matches(p, mesh, name)
    if v.shape[0] != p * mloc:
        raise ValueError(
            f"operand rows {v.shape[0]} != padded {p * mloc}; "
            "use partition_band_vector")
    tail = v.shape[1:]
    spec = P(ROW_AXIS, *([None] * len(tail)))

    def body(panels, vl):
        panels = panels[0]
        # halo exchange: device d sends its tail right / head left;
        # boundary devices receive zeros (ppermute semantics), matching
        # zero padding
        if h:
            left = jax.lax.ppermute(vl[mloc - h:], ROW_AXIS,
                                    [(i, i + 1) for i in range(p - 1)])
            right = jax.lax.ppermute(vl[:h], ROW_AXIS,
                                     [(i + 1, i) for i in range(p - 1)])
            vl = jnp.concatenate([left, vl, right])
        return band_sweep(panels, vl)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(ROW_AXIS, None, None), spec),
        out_specs=spec))
    return fn(plan.panels, v)


def dist_band_spmv(plan: DistBandPlan, x: jax.Array, mesh: Mesh
                   ) -> jax.Array:
    """y = A @ x with x/y block-sharded (padded length p*mloc): one
    ppermute of each h-wide edge, then the local panel sweep."""
    return _halo_apply(plan, x, mesh, "dist_band_spmv")


def dist_band_spmm(plan: DistBandPlan, b: jax.Array, mesh: Mesh
                   ) -> jax.Array:
    """C = A @ B for dense B (p*mloc, k) row-sharded: each device
    exchanges only its (h, k) edge panels with ring neighbors."""
    return _halo_apply(plan, b, mesh, "dist_band_spmm")


def partition_band_vector(x, plan: DistBandPlan, mesh: Mesh) -> jax.Array:
    x = jnp.asarray(x)
    tgt = plan.p * plan.mloc
    if x.shape[0] < tgt:
        pad = [(0, tgt - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        x = jnp.pad(x, pad)
    spec = P(ROW_AXIS, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))
