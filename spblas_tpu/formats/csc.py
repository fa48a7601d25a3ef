"""CSC container — column-compressed mirror of CSR.

Re-design of the reference's ``csc_view`` (reference:
include/spblas/views/csc_view.hpp:9-72).  Same padded-capacity container
design as :mod:`spblas_tpu.formats.csr`; ``colptr`` compresses columns and
``rowind`` holds per-entry row indices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spblas_tpu import types as _t
from spblas_tpu.formats.csr import _pad_to


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column matrix with padded static capacity.

    Data fields: values (capacity,), colptr (n + 1,), rowind (capacity,),
    nnz () int32.  Meta: shape (m, n).
    """

    values: jax.Array
    colptr: jax.Array
    rowind: jax.Array
    nnz: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_arrays(cls, values, colptr, rowind, shape, nnz=None,
                    capacity=None) -> "CSC":
        _t.check_values_dtype(values, "CSC.from_arrays")
        values = jnp.asarray(values)
        colptr = jnp.asarray(colptr, dtype=_t.offset_dtype)
        rowind = jnp.asarray(rowind, dtype=_t.index_dtype)
        if nnz is None:
            nnz = int(values.shape[0])
        nnz_i = int(nnz)
        if capacity is None:
            capacity = max(_t.quantize_capacity(nnz_i), int(values.shape[0]))
        capacity = int(capacity)
        if int(values.shape[0]) > nnz_i:
            # canonical zero padding over caller-supplied oversized
            # buffers (mirrors CSR/COO.from_arrays, round-4 review)
            live = jnp.arange(int(values.shape[0]),
                              dtype=jnp.int32) < nnz_i
            values = jnp.where(live, values, 0)
            rowind = jnp.where(live, rowind, 0)
        return cls(values=_pad_to(values, capacity), colptr=colptr,
                   rowind=_pad_to(rowind, capacity),
                   nnz=jnp.asarray(nnz_i, dtype=jnp.int32),
                   shape=(int(shape[0]), int(shape[1])))

    @classmethod
    def from_dense(cls, dense, capacity=None, tol=0.0) -> "CSC":
        dense = np.asarray(dense)
        m, n = dense.shape
        cols, rows = np.nonzero(np.abs(dense.T) > tol)
        vals = dense[rows, cols]
        colptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(colptr[1:], cols, 1)
        colptr = np.cumsum(colptr)
        return cls.from_arrays(vals, colptr, rows, (m, n),
                               nnz=len(vals), capacity=capacity)

    def update(self, values, colptr=None, rowind=None, nnz=None) -> "CSC":
        colptr = self.colptr if colptr is None else jnp.asarray(
            colptr, dtype=_t.offset_dtype)
        rowind = self.rowind if rowind is None else jnp.asarray(
            rowind, dtype=_t.index_dtype)
        nnz = self.nnz if nnz is None else jnp.asarray(nnz, dtype=jnp.int32)
        return CSC(values=jnp.asarray(values), colptr=colptr, rowind=rowind,
                   nnz=nnz, shape=self.shape)

    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    def col_ids(self) -> jax.Array:
        """Per-entry column index, (capacity,); padded entries map to n."""
        e = jnp.arange(self.capacity, dtype=self.colptr.dtype)
        return jnp.searchsorted(self.colptr[1:], e, side="right").astype(
            _t.index_dtype)

    def col_lengths(self) -> jax.Array:
        return (self.colptr[1:] - self.colptr[:-1]).astype(_t.index_dtype)

    def entry_mask(self) -> jax.Array:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.nnz

    def todense(self) -> jax.Array:
        m, n = self.shape
        out = jnp.zeros((m, n), dtype=self.dtype)
        return out.at[self.rowind, self.col_ids()].add(
            self.values, mode="drop")

    def validate(self) -> None:
        m, n = self.shape
        colptr = np.asarray(self.colptr)
        rowind = np.asarray(self.rowind)
        values = np.asarray(self.values)
        nnz = int(self.nnz)
        if colptr.shape != (n + 1,):
            raise ValueError(f"colptr shape {colptr.shape} != ({n + 1},)")
        if colptr[0] != 0 or colptr[-1] != nnz:
            raise ValueError("colptr must start at 0 and end at nnz")
        if np.any(np.diff(colptr) < 0):
            raise ValueError("colptr must be monotone non-decreasing")
        if nnz and (rowind[:nnz].min() < 0 or rowind[:nnz].max() >= m):
            raise ValueError("rowind out of range")
        if np.any(values[nnz:] != 0) or np.any(rowind[nnz:] != 0):
            raise ValueError("padding not canonical (zeros)")

    def __repr__(self):
        return (f"CSC(shape={self.shape}, capacity={self.capacity}, "
                f"dtype={self.dtype})")
