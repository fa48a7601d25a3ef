"""BSR container — block compressed sparse row.

No reference counterpart (the reference has CSR/CSC only) but in scope per
BASELINE.json's north-star format list.  Each nonzero is a dense (bh, bw)
block, so SpMV/SpMM become batched dense block contractions with zero index
traffic inside a block — see spblas_tpu.kernels.bsr.

Layout: values (capacity, bh, bw), block_rowptr (mb + 1,),
block_colind (capacity,), where mb = m // bh.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spblas_tpu import types as _t
from spblas_tpu.formats.csr import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSR:
    values: jax.Array        # (capacity, bh, bw)
    block_rowptr: jax.Array  # (mb + 1,)
    block_colind: jax.Array  # (capacity,)
    nnz_blocks: jax.Array    # () int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    block_shape: Tuple[int, int] = dataclasses.field(
        metadata=dict(static=True))

    @classmethod
    def from_dense(cls, dense, block_shape=(128, 128), capacity=None,
                   tol=0.0) -> "BSR":
        dense = np.asarray(dense)
        m, n = dense.shape
        bh, bw = block_shape
        if m % bh or n % bw:
            raise ValueError(
                f"shape {dense.shape} not divisible by blocks {block_shape}")
        mb, nb = m // bh, n // bw
        blocks = dense.reshape(mb, bh, nb, bw).transpose(0, 2, 1, 3)
        nz = np.abs(blocks).max(axis=(2, 3)) > tol   # (mb, nb)
        brow, bcol = np.nonzero(nz)
        vals = blocks[brow, bcol]                    # (nnzb, bh, bw)
        rowptr = np.zeros(mb + 1, dtype=np.int64)
        np.add.at(rowptr[1:], brow, 1)
        rowptr = np.cumsum(rowptr)
        nnzb = len(brow)
        if capacity is None:
            capacity = _t.quantize_capacity(max(nnzb, 1))
        pad = capacity - nnzb
        if pad < 0:
            raise ValueError("capacity too small")
        vals = np.concatenate(
            [vals, np.zeros((pad, bh, bw), dtype=vals.dtype)])
        bcol = np.concatenate([bcol, np.zeros(pad, dtype=np.int64)])
        return cls(values=jnp.asarray(vals),
                   block_rowptr=jnp.asarray(rowptr, dtype=_t.offset_dtype),
                   block_colind=jnp.asarray(bcol, dtype=_t.index_dtype),
                   nnz_blocks=jnp.asarray(nnzb, dtype=jnp.int32),
                   shape=(m, n), block_shape=(bh, bw))

    @classmethod
    def from_csr(cls, a: CSR, block_shape=(128, 128), capacity=None) -> "BSR":
        """Host-side re-blocking of a CSR matrix (an optimize-phase
        conversion — the matrix_opt plan analogue).  Direct entry
        scatter, no dense intermediate (m*n would not fit for the
        benchmark-scale matrices this serves)."""
        bh, bw = block_shape
        m, n = a.shape
        if m % bh or n % bw:
            raise ValueError(
                f"shape {a.shape} not divisible by blocks {block_shape}")
        mb = m // bh
        nnz = int(a.nnz)
        rowptr = np.asarray(a.rowptr).astype(np.int64)
        lo = np.minimum(rowptr[:-1], nnz)
        hi = np.minimum(rowptr[1:], nnz)
        rows = np.repeat(np.arange(m), hi - lo)
        cols = np.asarray(a.colind)[:nnz].astype(np.int64)
        vals = np.asarray(a.values)[:nnz]
        bkey = (rows // bh) * (n // bw) + cols // bw
        uniq, inv = np.unique(bkey, return_inverse=True)
        nnzb = len(uniq)
        if capacity is None:
            capacity = _t.quantize_capacity(max(nnzb, 1))
        if nnzb > capacity:
            raise ValueError("capacity too small")
        blocks = np.zeros((capacity, bh, bw), dtype=vals.dtype)
        blocks[inv, rows % bh, cols % bw] = vals
        brow = (uniq // (n // bw)).astype(np.int64)
        bcol = np.concatenate([uniq % (n // bw),
                               np.zeros(capacity - nnzb, np.int64)])
        b_rowptr = np.zeros(mb + 1, dtype=np.int64)
        np.add.at(b_rowptr[1:], brow, 1)
        return cls(values=jnp.asarray(blocks),
                   block_rowptr=jnp.asarray(np.cumsum(b_rowptr),
                                            dtype=_t.offset_dtype),
                   block_colind=jnp.asarray(bcol, dtype=_t.index_dtype),
                   nnz_blocks=jnp.asarray(nnzb, dtype=jnp.int32),
                   shape=(m, n), block_shape=(bh, bw))

    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self) -> jax.Array:
        bh, bw = self.block_shape
        return self.nnz_blocks * (bh * bw)

    def block_row_ids(self) -> jax.Array:
        mb = self.shape[0] // self.block_shape[0]
        e = jnp.arange(self.capacity, dtype=self.block_rowptr.dtype)
        return jnp.searchsorted(self.block_rowptr[1:], e,
                                side="right").astype(_t.index_dtype)

    def todense(self) -> jax.Array:
        m, n = self.shape
        bh, bw = self.block_shape
        mb, nb = m // bh, n // bw
        out = jnp.zeros((mb, nb, bh, bw), dtype=self.dtype)
        out = out.at[self.block_row_ids(), self.block_colind].add(
            self.values, mode="drop")
        return out.transpose(0, 2, 1, 3).reshape(m, n)

    def __repr__(self):
        return (f"BSR(shape={self.shape}, blocks={self.block_shape}, "
                f"capacity={self.capacity}, dtype={self.dtype})")
