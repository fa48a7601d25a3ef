"""CSR container — the workhorse sparse format.

Re-design of the reference's ``csr_view`` (reference:
include/spblas/views/csr_view.hpp:12-77).  The reference exposes *non-owning
spans* over user memory; spans don't map to JAX, so this is an immutable
registered-pytree **container** with *static capacity*: ``values`` and
``colind`` are padded to ``capacity >= nnz`` so XLA sees static shapes, while
``nnz`` rides along as a 0-d device scalar (dynamic — one compiled program
serves every matrix of a given capacity).

Canonical padding invariant: entries at positions >= nnz have
``values == 0`` and ``colind == 0``.  Numeric ops may then ignore ``nnz``
entirely (zero contributions vanish); structural ops mask with
``arange(capacity) < nnz``.

The reference's ``update()`` re-binding handshake (csr_view.hpp:36-49) —
user allocates bigger buffers, view re-binds — becomes the functional
``update()`` here: return a new container over new arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spblas_tpu import types as _t


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with padded static capacity.

    Data fields (traced):
      values: (capacity,) scalar dtype
      rowptr: (m + 1,) offset dtype, rowptr[m] == nnz
      colind: (capacity,) index dtype
      nnz:    () int32 scalar — the live entry count

    Meta fields (static):
      shape: (m, n)
    """

    values: jax.Array
    rowptr: jax.Array
    colind: jax.Array
    nnz: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    @classmethod
    def from_arrays(cls, values, rowptr, colind, shape, nnz=None,
                    capacity=None) -> "CSR":
        """Build a CSR from (possibly unpadded) arrays.

        Mirrors the csr_view constructor (csr_view.hpp:20-34) but owns
        padded copies.  ``capacity`` defaults to a power-of-two bucket of
        nnz to bound recompilation.
        """
        _t.check_values_dtype(values, "CSR.from_arrays")
        values = jnp.asarray(values)
        rowptr = jnp.asarray(rowptr, dtype=_t.offset_dtype)
        colind = jnp.asarray(colind, dtype=_t.index_dtype)
        if nnz is None:
            nnz = int(values.shape[0])
        nnz_i = int(nnz)
        if capacity is None:
            capacity = max(_t.quantize_capacity(nnz_i), int(values.shape[0]))
        capacity = int(capacity)
        if int(values.shape[0]) > nnz_i:
            # canonical zero padding over caller-supplied oversized
            # buffers (stale tails would trip validate and leak into
            # mask-free consumers)
            live = jnp.arange(int(values.shape[0]),
                              dtype=jnp.int32) < nnz_i
            values = jnp.where(live, values, 0)
            colind = jnp.where(live, colind, 0)
        values = _pad_to(values, capacity)
        colind = _pad_to(colind, capacity)
        return cls(values=values, rowptr=rowptr, colind=colind,
                   nnz=jnp.asarray(nnz_i, dtype=jnp.int32),
                   shape=(int(shape[0]), int(shape[1])))

    @classmethod
    def from_dense(cls, dense, capacity=None, tol=0.0) -> "CSR":
        dense = np.asarray(dense)
        m, n = dense.shape
        mask = np.abs(dense) > tol
        rows, cols = np.nonzero(mask)
        vals = dense[rows, cols]
        rowptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(rowptr[1:], rows, 1)
        rowptr = np.cumsum(rowptr)
        return cls.from_arrays(vals, rowptr, cols, (m, n),
                               nnz=len(vals), capacity=capacity)

    def update(self, values, rowptr=None, colind=None, nnz=None) -> "CSR":
        """Functional re-bind over new buffers (csr_view.hpp:36-49)."""
        rowptr = self.rowptr if rowptr is None else jnp.asarray(
            rowptr, dtype=_t.offset_dtype)
        colind = self.colind if colind is None else jnp.asarray(
            colind, dtype=_t.index_dtype)
        nnz = self.nnz if nnz is None else jnp.asarray(nnz, dtype=jnp.int32)
        return CSR(values=jnp.asarray(values), rowptr=rowptr, colind=colind,
                   nnz=nnz, shape=self.shape)

    def with_capacity(self, capacity: int) -> "CSR":
        """Grow or shrink the padded capacity (caller ensures nnz fits;
        shrinking only drops canonical zero padding)."""
        capacity = int(capacity)
        if capacity < self.capacity:
            return CSR(values=self.values[:capacity], rowptr=self.rowptr,
                       colind=self.colind[:capacity], nnz=self.nnz,
                       shape=self.shape)
        return CSR(values=_pad_to(self.values, capacity),
                   rowptr=self.rowptr,
                   colind=_pad_to(self.colind, capacity),
                   nnz=self.nnz, shape=self.shape)

    # ------------------------------------------------------------------ #
    # accessors
    # ------------------------------------------------------------------ #
    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def index_dtype(self):
        return self.colind.dtype

    def row_ids(self) -> jax.Array:
        """Per-entry row index, (capacity,).  Padded entries map to m
        (one past the last row) and are dropped by segment reductions."""
        m = self.shape[0]
        e = jnp.arange(self.capacity, dtype=self.rowptr.dtype)
        return jnp.searchsorted(self.rowptr[1:], e, side="right").astype(
            _t.index_dtype)

    def row_lengths(self) -> jax.Array:
        return (self.rowptr[1:] - self.rowptr[:-1]).astype(_t.index_dtype)

    def entry_mask(self) -> jax.Array:
        """(capacity,) bool — True for live entries."""
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.nnz

    def todense(self) -> jax.Array:
        m, n = self.shape
        out = jnp.zeros((m, n), dtype=self.dtype)
        return out.at[self.row_ids(), self.colind].add(
            self.values, mode="drop")

    # ------------------------------------------------------------------ #
    # debug validation (the reference's sanitizer analogue, SURVEY.md §5.2)
    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        """Host-side structural checks; raises ValueError on violation."""
        m, n = self.shape
        rowptr = np.asarray(self.rowptr)
        colind = np.asarray(self.colind)
        values = np.asarray(self.values)
        nnz = int(self.nnz)
        if rowptr.shape != (m + 1,):
            raise ValueError(f"rowptr shape {rowptr.shape} != ({m + 1},)")
        if rowptr[0] != 0 or rowptr[-1] != nnz:
            raise ValueError("rowptr must start at 0 and end at nnz")
        if np.any(np.diff(rowptr) < 0):
            raise ValueError("rowptr must be monotone non-decreasing")
        if nnz > self.capacity:
            raise ValueError(f"nnz {nnz} exceeds capacity {self.capacity}")
        if nnz and (colind[:nnz].min() < 0 or colind[:nnz].max() >= n):
            raise ValueError("colind out of range")
        if np.any(values[nnz:] != 0) or np.any(colind[nnz:] != 0):
            raise ValueError("padding not canonical (zeros)")

    def __repr__(self):  # keep tracers printable
        return (f"CSR(shape={self.shape}, capacity={self.capacity}, "
                f"dtype={self.dtype})")


def host_row_ids(rowptr, nnz: int, m: int) -> "np.ndarray":
    """Per-live-entry row ids from a (possibly capacity-padded) rowptr —
    the shared host-inspect idiom (numpy only; safe under an outer jit
    because it never emits jnp ops on the captured arrays)."""
    rowptr = np.asarray(rowptr).astype(np.int64)
    lo = np.minimum(rowptr[:-1], nnz)
    hi = np.minimum(rowptr[1:], nnz)
    return np.repeat(np.arange(m), hi - lo)


def _pad_to(arr: jax.Array, capacity: int) -> jax.Array:
    n = arr.shape[0]
    if n == capacity:
        return arr
    if n > capacity:
        raise ValueError(f"array length {n} exceeds capacity {capacity}")
    return jnp.concatenate(
        [arr, jnp.zeros((capacity - n,), dtype=arr.dtype)])
