"""Stacked row-block CSR: the distributed container for SpGEMM/SpMM.

Device d owns global rows [d*mloc, (d+1)*mloc) as a local CSR with
**global** column indices, all devices padded to one uniform entry
capacity so the mesh runs a single SPMD program.  Complements
:class:`spblas_tpu.parallel.dist_csr.DistCSR` (whose column-blocked
rotation layout serves the ring SpMV); this layout serves ops that need
whole rows — SpGEMM expansion and B-row gathering.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spblas_tpu import types as _t
from spblas_tpu.formats.csr import CSR
from spblas_tpu.formats.convert import to_csr
from spblas_tpu.parallel.mesh import ROW_AXIS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RowBlockCSR:
    """Row-partitioned CSR over a 1-D mesh (leading axis = device).

    values (p, lcap); colind (p, lcap) global column ids; rowptr
    (p, mloc + 1) local offsets with rowptr[d, mloc] = local nnz.
    Padding entries carry value 0 / colind 0 (canonical, like CSR).
    """

    values: jax.Array
    colind: jax.Array
    rowptr: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    mloc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def p(self) -> int:
        return int(self.values.shape[0])

    @property
    def local_capacity(self) -> int:
        return int(self.values.shape[1])

    @property
    def dtype(self):
        return self.values.dtype


def local_rowptr(rowptr, d: int, mloc: int, m: int):
    """Device ``d``'s zero-based clamped sub-rowptr (mloc+1) plus its
    global entry range [lo, hi) — ONE copy of the block-slicing idiom
    shared by partition_sell and partition_rowblock."""
    import numpy as _np
    r0, r1 = min(d * mloc, m), min((d + 1) * mloc, m)
    lo, hi = int(rowptr[r0]), int(rowptr[r1])
    sub = _np.zeros(mloc + 1, _np.int64)
    if r1 > r0:
        sub[: r1 - r0 + 1] = rowptr[r0: r1 + 1] - lo
    sub[r1 - r0 + 1:] = hi - lo
    return lo, hi, sub


def partition_rowblock(a, mesh: Mesh,
                       local_capacity: int | None = None) -> RowBlockCSR:
    """Host-side partition of a CSR into p uniform row blocks."""
    a = to_csr(a)
    p = mesh.devices.size
    m, n = a.shape
    mloc = -(-m // p)
    nnz = int(a.nnz)
    rowptr = np.asarray(a.rowptr)[: m + 1].astype(np.int64)
    colind = np.asarray(a.colind)[:nnz]
    values = np.asarray(a.values)[:nnz]

    starts = rowptr[np.minimum(np.arange(p) * mloc, m)]
    ends = rowptr[np.minimum((np.arange(p) + 1) * mloc, m)]
    cap = int((ends - starts).max()) if p else 1
    cap = max(_t.quantize_capacity(max(cap, 1)), 1)
    if local_capacity is not None:
        if local_capacity < cap:
            raise ValueError(
                f"local_capacity {local_capacity} < required {cap}")
        cap = int(local_capacity)

    vals_b = np.zeros((p, cap), dtype=values.dtype)
    cols_b = np.zeros((p, cap), dtype=np.int32)
    rptr_b = np.zeros((p, mloc + 1), dtype=np.int64)
    for d in range(p):
        lo, hi = starts[d], ends[d]
        k = hi - lo
        vals_b[d, :k] = values[lo:hi]
        cols_b[d, :k] = colind[lo:hi]
        r0, r1 = min(d * mloc, m), min((d + 1) * mloc, m)
        rptr_b[d, : r1 - r0 + 1] = rowptr[r0: r1 + 1] - lo
        rptr_b[d, r1 - r0 + 1:] = hi - lo
    shard = NamedSharding(mesh, P(ROW_AXIS, None))
    return RowBlockCSR(
        values=jax.device_put(jnp.asarray(vals_b), shard),
        colind=jax.device_put(jnp.asarray(cols_b, dtype=_t.index_dtype),
                              shard),
        rowptr=jax.device_put(jnp.asarray(rptr_b, dtype=_t.offset_dtype),
                              shard),
        shape=(m, n), mloc=mloc)


def assemble_csr(rb: RowBlockCSR) -> CSR:
    """Host-side reassembly into one global CSR (testing / IO)."""
    p, mloc = rb.p, rb.mloc
    m, n = rb.shape
    values = np.asarray(rb.values)
    colind = np.asarray(rb.colind)
    rowptr = np.asarray(rb.rowptr)
    out_vals, out_cols, counts = [], [], np.zeros(m + 1, dtype=np.int64)
    for d in range(p):
        r1 = max(0, min((d + 1) * mloc, m) - d * mloc)
        k = int(rowptr[d, r1])
        out_vals.append(values[d, :k])
        out_cols.append(colind[d, :k])
        counts[d * mloc + 1: d * mloc + r1 + 1] = np.diff(
            rowptr[d, : r1 + 1])
    g_rowptr = np.cumsum(counts)
    vals = np.concatenate(out_vals) if out_vals else np.zeros(0)
    cols = np.concatenate(out_cols) if out_cols else np.zeros(0, np.int32)
    return CSR.from_arrays(vals, g_rowptr, cols, (m, n), nnz=len(vals))
