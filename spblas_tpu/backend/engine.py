"""Sort-based sparse kernel building blocks.

Replacement for the reference's scatter-style accumulators —
``spa_accumulator`` (include/spblas/backend/spa_accumulator.hpp:14-104),
``hash_accumulator`` (hash_accumulator.hpp:16-88) and ``csr_builder``
(csr_builder.hpp:18-70).  Per-row dense scatter-accumulators don't map to
a data-parallel device; the idiomatic XLA formulation is *expand →
lexicographic sort → segmented reduce* (ESC), built entirely from
``lax.sort`` (stable, multi-key), cumulative sums and segment reductions.

Everything here is shape-static and jittable: invalid/padded entries carry a
sentinel row ``m`` that sorts after all live entries and is dropped by
out-of-bounds scatter semantics.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from spblas_tpu import types as _t


def lexsort_coo(rows, cols, *payload):
    """Stable lexicographic sort of COO triples by (row, col).

    Invalid entries must already carry a sentinel row >= m so they sink to
    the tail.  Returns (rows, cols, *payload) sorted.
    """
    return jax.lax.sort((rows, cols) + tuple(payload), num_keys=2)


def head_flags(rows_sorted, cols_sorted, valid_sorted):
    """True at the first entry of each (row, col) group among live entries.

    The vectorised equivalent of the SPA's "already stored?" membership bit
    (spa_accumulator.hpp: insert path).
    """
    prev_r = jnp.concatenate([rows_sorted[:1] - 1, rows_sorted[:-1]])
    prev_c = jnp.concatenate([cols_sorted[:1] - 1, cols_sorted[:-1]])
    new_group = (rows_sorted != prev_r) | (cols_sorted != prev_c)
    return new_group & valid_sorted


def coalesce_sorted(rows_sorted, cols_sorted, valid_sorted, m: int):
    """(heads, slots, nnz, rowptr) for a (row, col)-sorted stream — the
    shared ESC coalescing core behind SpGEMM/SpADD structure passes."""
    heads = head_flags(rows_sorted, cols_sorted, valid_sorted)
    slots = jnp.cumsum(heads.astype(_t.offset_dtype)) - 1
    nnz = jnp.sum(heads).astype(jnp.int32)
    rowptr = rowptr_from_counts(row_counts(rows_sorted, heads, m), m)
    return heads, slots, nnz, rowptr


def compress(rows_sorted, cols_sorted, vals_sorted, valid_sorted,
             m: int, out_capacity: int):
    """Coalesce sorted COO entries: sum duplicates, emit unique structure.

    The ESC analogue of per-row SPA accumulate + sort + csr_builder insert
    (spgemm_gustavsons.hpp:35-49).  Returns
    (out_vals, out_rows, out_cols, rowptr, nnz) where nnz is a device
    scalar; entries beyond ``out_capacity`` are dropped (the jit-safe
    analogue of csr_builder's capacity throw — callers check on host).
    """
    heads = head_flags(rows_sorted, cols_sorted, valid_sorted)
    # output slot of each entry = index of its group among live groups
    slots = jnp.cumsum(heads.astype(_t.offset_dtype)) - 1
    nnz = jnp.sum(heads).astype(jnp.int32)
    drop = out_capacity  # out-of-bounds slot → dropped by scatter
    slot_or_drop = jnp.where(valid_sorted, slots, drop)
    out_vals = jnp.zeros((out_capacity,), dtype=vals_sorted.dtype).at[
        slot_or_drop].add(jnp.where(valid_sorted, vals_sorted, 0),
                          mode="drop")
    head_slot = jnp.where(heads, slots, drop)
    out_cols = jnp.zeros((out_capacity,), dtype=_t.index_dtype).at[
        head_slot].set(cols_sorted.astype(_t.index_dtype), mode="drop")
    out_rows = jnp.zeros((out_capacity,), dtype=_t.index_dtype).at[
        head_slot].set(rows_sorted.astype(_t.index_dtype), mode="drop")
    rowptr = rowptr_from_counts(
        row_counts(rows_sorted, heads, m), m)
    return out_vals, out_rows, out_cols, rowptr, nnz


def symbolic_compress(rows_sorted, cols_sorted, valid_sorted, m: int):
    """Structure-only pass: per-row unique counts + total nnz.

    Mirrors the symbolic SPA-set union (spgemm_gustavsons.hpp:74-86) —
    returns (rowptr, nnz) as device arrays.
    """
    heads = head_flags(rows_sorted, cols_sorted, valid_sorted)
    counts = row_counts(rows_sorted, heads, m)
    return rowptr_from_counts(counts, m), jnp.sum(heads).astype(jnp.int32)


def row_counts(rows, weights, m: int):
    """Per-row count of entries with True/1 weight; rows >= m dropped."""
    return jnp.zeros((m,), dtype=_t.offset_dtype).at[rows].add(
        weights.astype(_t.offset_dtype), mode="drop")


def rowptr_from_counts(counts, m: int):
    return jnp.concatenate(
        [jnp.zeros((1,), dtype=_t.offset_dtype),
         jnp.cumsum(counts).astype(_t.offset_dtype)])


def segment_ids_from_ptr(ptr, capacity: int):
    """Inverse of rowptr: per-entry segment id; padded entries map past
    the last segment (ptr has len m+1)."""
    e = jnp.arange(capacity, dtype=ptr.dtype)
    return jnp.searchsorted(ptr[1:], e, side="right").astype(_t.index_dtype)


def expansion_maps(a_rowptr, a_colind, a_mask, b_rowptr,
                   a_capacity: int, b_capacity: int, e_capacity: int,
                   m: int):
    """Gather maps for the SpGEMM expansion phase.

    For each live A entry t = (i, k) the expansion enumerates all entries of
    B row k.  Returns per-expanded-entry arrays of shape (e_capacity,):
      a_idx  — source A entry index t
      b_idx  — source B entry index (b_rowptr[k] + local)
      rows   — output row i (sentinel m when invalid)
      valid  — live flag
    This is the flop enumeration of Gustavson's algorithm
    (spgemm_gustavsons.hpp:35-43) as pure gathers — no scatter, no hash.
    """
    b_len = (b_rowptr[1:] - b_rowptr[:-1]).astype(_t.offset_dtype)
    counts = jnp.where(a_mask, b_len[a_colind], 0)
    ends = jnp.cumsum(counts)  # inclusive
    total = ends[-1] if a_capacity > 0 else jnp.zeros((), _t.offset_dtype)
    e = jnp.arange(e_capacity, dtype=ends.dtype)
    t = jnp.searchsorted(ends, e, side="right")
    valid = (e < total) & (t < a_capacity)
    t_c = jnp.minimum(t, a_capacity - 1)
    starts = ends[t_c] - counts[t_c]
    local = (e - starts).astype(_t.offset_dtype)
    k = a_colind[t_c]
    # clamp so gathers through b_idx stay in bounds even for dead entries
    b_idx = jnp.clip(b_rowptr[k] + local, 0, b_capacity - 1).astype(
        _t.offset_dtype)
    a_rows = segment_ids_from_ptr(a_rowptr, a_capacity)
    rows = jnp.where(valid, a_rows[t_c], m).astype(_t.index_dtype)
    return t_c.astype(_t.offset_dtype), b_idx, rows, valid
