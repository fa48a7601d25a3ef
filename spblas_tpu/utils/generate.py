"""Seeded random matrix generators — the test/example fixture layer.

Mirrors the reference's generators (include/spblas/backend/generate.hpp:48-196)
in *distribution*, not bit pattern: unique random (row, col) entries, sorted
row-major, values U[0, 100), seeded.  ``generate_csr`` deliberately shuffles
colind *within rows* (generate.hpp:107-120) so no algorithm may assume sorted
rows — that property is preserved here because it shook out real bugs in the
reference's test suite.
"""

from __future__ import annotations

import numpy as np

from spblas_tpu.formats.csr import CSR
from spblas_tpu.formats.csc import CSC
from spblas_tpu.formats.coo import COO


def _complex_dtype(dtype):
    """complex_=True with a real dtype means the matching complex one
    (float32 -> complex64); a bare .astype(float) would silently discard
    the imaginary part."""
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        return dtype
    return np.dtype(np.complex128 if dtype == np.float64 else np.complex64)


def _coo_arrays(m, n, nnz, seed=0, dtype=np.float32, complex_=False):
    if nnz > m * n:
        raise ValueError("nnz exceeds m*n")
    rng = np.random.default_rng(seed)
    # unique entries, mirroring the reference's rejection loop
    # (generate.hpp:63-74), vectorised: sample flat indices w/o replacement.
    flat = rng.choice(m * n, size=nnz, replace=False)
    rows = (flat // n).astype(np.int64)
    cols = (flat % n).astype(np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    if complex_:
        vals = (rng.uniform(0, 100, nnz) + 1j * rng.uniform(0, 100, nnz)
                ).astype(_complex_dtype(dtype))
    else:
        vals = rng.uniform(0, 100, nnz).astype(dtype)
    return vals, rows, cols


def generate_coo(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                 capacity=None) -> COO:
    vals, rows, cols = _coo_arrays(m, n, nnz, seed, dtype, complex_)
    return COO.from_arrays(vals, rows, cols, (m, n), nnz=nnz,
                           capacity=capacity)


def _rows_to_rowptr(rows, m):
    rowptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(rowptr[1:], rows, 1)
    return np.cumsum(rowptr)


def generate_csr_sorted(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                        capacity=None) -> CSR:
    """CSR with sorted column indices within rows (generate.hpp:92-105)."""
    vals, rows, cols = _coo_arrays(m, n, nnz, seed, dtype, complex_)
    return CSR.from_arrays(vals, _rows_to_rowptr(rows, m), cols, (m, n),
                           nnz=nnz, capacity=capacity)


def generate_csr_arrays(m, n, nnz, seed=0, dtype=np.float32,
                        complex_=False):
    """HOST (numpy) arrays of :func:`generate_csr` — for inspectors
    that run on host anyway."""
    vals, rows, cols = _coo_arrays(m, n, nnz, seed, dtype, complex_)
    rowptr = _rows_to_rowptr(rows, m)
    # Vectorised within-row shuffle: lexsort by (row, random key) applies
    # an independent uniform permutation inside every row at O(nnz log nnz)
    # (the per-row rng.permutation loop took ~60 s/Mrow of host time).
    rng = np.random.default_rng(seed)
    order = np.lexsort((rng.random(nnz), rows))
    cols, vals = cols[order], vals[order]
    return vals, rowptr, cols


def generate_csr(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                 capacity=None) -> CSR:
    """CSR with *shuffled* colind within each row (generate.hpp:107-120)."""
    vals, rowptr, cols = generate_csr_arrays(m, n, nnz, seed, dtype,
                                             complex_)
    return CSR.from_arrays(vals, rowptr, cols, (m, n), nnz=nnz,
                           capacity=capacity)


def generate_csc_sorted(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                        capacity=None) -> CSC:
    """CSC of an m x n matrix = CSR of the n x m transpose
    (generate.hpp:122-129)."""
    t = generate_csr_sorted(n, m, nnz, seed, dtype, complex_, capacity)
    return CSC(values=t.values, colptr=t.rowptr, rowind=t.colind,
               nnz=t.nnz, shape=(m, n))


def generate_csc(m, n, nnz, seed=0, dtype=np.float32, complex_=False,
                 capacity=None) -> CSC:
    t = generate_csr(n, m, nnz, seed, dtype, complex_, capacity)
    return CSC(values=t.values, colptr=t.rowptr, rowind=t.colind,
               nnz=t.nnz, shape=(m, n))


def generate_dense(m, n, seed=0, dtype=np.float32, complex_=False):
    """Dense U[0, 100) matrix (generate.hpp:170-182)."""
    rng = np.random.default_rng(seed)
    if complex_:
        return (rng.uniform(0, 100, (m, n))
                + 1j * rng.uniform(0, 100, (m, n))).astype(
                    _complex_dtype(dtype))
    return rng.uniform(0, 100, (m, n)).astype(dtype)


def generate_gaussian(m, n, seed=0, dtype=np.float32):
    """Dense N(0, 1) matrix (generate.hpp:184-196)."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (m, n)).astype(dtype)


def generate_vector(n, seed=0, dtype=np.float32, complex_=False):
    return generate_dense(1, n, seed, dtype, complex_)[0]


def generate_banded_csr(m, n, bandwidth, seed=0, dtype=np.float32,
                        capacity=None) -> CSR:
    """Synthetic banded matrix for the headline SpMV benchmark
    (BASELINE.json configs[0]: 10k x 10k banded): every entry within
    ``bandwidth // 2`` of the diagonal is stored, values U(-1, 1)."""
    rng = np.random.default_rng(seed)
    half = bandwidth // 2
    # built directly in row-major order (no sort): row i holds the
    # contiguous columns [lo_i, hi_i)
    i = np.arange(m, dtype=np.int64)
    lo = np.clip(i - half, 0, n)
    hi = np.clip(i + half + 1, 0, n)
    counts = np.maximum(hi - lo, 0)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(rowptr[-1])
    cols = (np.arange(nnz, dtype=np.int64)
            - np.repeat(rowptr[:-1] - lo, counts))
    vals = rng.uniform(-1, 1, nnz)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        vals = vals + 1j * rng.uniform(-1, 1, nnz)
    return CSR.from_arrays(vals.astype(dtype), rowptr, cols, (m, n),
                           nnz=nnz, capacity=capacity)


def generate_bsr(mb, nb, blocks_per_row, block_shape, seed=0,
                 dtype=np.float32):
    """Random block-sparse matrix: ``blocks_per_row`` distinct block
    columns in each of ``mb`` block rows (of ``nb``), dense U(-1, 1)
    blocks of ``block_shape``."""
    from spblas_tpu import types as _t
    from spblas_tpu.formats.bsr import BSR
    import jax.numpy as jnp

    bh, bw = block_shape
    k = int(blocks_per_row)
    if k > nb:
        raise ValueError("blocks_per_row exceeds block columns")
    rng = np.random.default_rng(seed)
    # k distinct sorted block columns per row: one random column in
    # each of k equal segments of the block-column range
    seg = nb // k
    cols = (np.arange(k) * seg + rng.integers(0, seg, (mb, k))).reshape(-1)
    nnzb = mb * k
    vals = rng.uniform(-1, 1, (nnzb, bh, bw)).astype(dtype)
    return BSR(values=jnp.asarray(vals),
               block_rowptr=jnp.asarray(np.arange(mb + 1) * k,
                                        _t.offset_dtype),
               block_colind=jnp.asarray(cols, _t.index_dtype),
               nnz_blocks=jnp.asarray(nnzb, jnp.int32),
               shape=(mb * bh, nb * bw), block_shape=(bh, bw))


def _coo_to_csr(rows, cols, vals, shape, capacity=None) -> CSR:
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    return CSR.from_arrays(vals, _rows_to_rowptr(rows, shape[0]), cols,
                           shape, nnz=len(rows), capacity=capacity)


def generate_stencil_csr(dims, seed=0, dtype=np.float32,
                         capacity=None) -> CSR:
    """Finite-difference Laplacian stencil on a structured grid: 2D
    5-point for ``dims=(nx, ny)``, 3D 7-point for ``(nx, ny, nz)`` —
    the mesh-family structure of the SuiteSparse PDE matrices the
    north-star benchmark names (BASELINE.md row 1).  Diagonal = coordination number, off-diagonals = -1 with a
    small seeded jitter so values are not degenerate."""
    dims = tuple(int(d) for d in dims)
    m = int(np.prod(dims))
    idx = np.arange(m, dtype=np.int64)
    grid = np.unravel_index(idx, dims)
    rows_l, cols_l = [idx], [idx]
    for ax in range(len(dims)):
        for step in (-1, 1):
            coord = grid[ax] + step
            ok = (coord >= 0) & (coord < dims[ax])
            nb = list(grid)
            nb[ax] = np.where(ok, coord, grid[ax])
            j = np.ravel_multi_index(tuple(nb), dims)
            rows_l.append(idx[ok])
            cols_l.append(j[ok])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    rng = np.random.default_rng(seed)
    vals = np.where(rows == cols, 2.0 * len(dims),
                    -1.0 + 0.01 * rng.standard_normal(len(rows)))
    return _coo_to_csr(rows, cols, vals.astype(dtype), (m, m), capacity)


def generate_fem_graph_csr(nx, ny, seed=0, dtype=np.float32,
                           capacity=None) -> CSR:
    """FEM-style irregular mesh graph: P1 triangles on an ``nx x ny``
    structured triangulation with per-cell randomized diagonal flips —
    node degrees vary 4-8 and the sparsity is mesh-like but not a pure
    stencil (the FEM-graph family of BASELINE.md row 1)."""
    m = nx * ny
    idx = np.arange(m, dtype=np.int64)
    ix, iy = idx // ny, idx % ny
    rows_l, cols_l = [idx], [idx]           # self (diagonal)
    # grid edges, both directions
    for dx, dy in ((1, 0), (0, 1)):
        ok = (ix + dx < nx) & (iy + dy < ny)
        j = idx + dx * ny + dy
        rows_l += [idx[ok], j[ok]]
        cols_l += [j[ok], idx[ok]]
    # one randomized diagonal per cell
    rng = np.random.default_rng(seed)
    cok = (ix < nx - 1) & (iy < ny - 1)
    cells = idx[cok]
    flip = rng.integers(0, 2, len(cells)).astype(bool)
    a = np.where(flip, cells, cells + ny)            # (i,j) or (i+1,j)
    b = np.where(flip, cells + ny + 1, cells + 1)    # (i+1,j+1) or (i,j+1)
    rows_l += [a, b]
    cols_l += [b, a]
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    deg = np.zeros(m, np.int64)
    np.add.at(deg, rows[rows != cols], 1)
    vals = np.where(rows == cols, deg[rows].astype(np.float64) + 1.0,
                    -1.0 + 0.01 * rng.standard_normal(len(rows)))
    return _coo_to_csr(rows, cols, vals.astype(dtype), (m, m), capacity)


def generate_triangular_csr(m, seed=0, lower=True, unit_diag=False,
                            density=0.05, dtype=np.float32,
                            capacity=None) -> CSR:
    """Well-conditioned random triangular factor for SpTRSV tests —
    mirrors the construction in the reference's triangular_solve_test
    (dominant diagonal so substitution is stable)."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l, vals_l = [], [], []
    for r in range(m):
        lo, hi = (0, r) if lower else (r + 1, m)
        span = hi - lo
        k = min(span, rng.binomial(span, density)) if span > 0 else 0
        if k > 0:
            cs = np.sort(rng.choice(np.arange(lo, hi), size=k,
                                    replace=False))
            rows_l.append(np.full(k, r, dtype=np.int64))
            cols_l.append(cs)
            vals_l.append(rng.uniform(-1, 1, k).astype(dtype))
        if not unit_diag:
            rows_l.append(np.array([r], dtype=np.int64))
            cols_l.append(np.array([r], dtype=np.int64))
            # dominant diagonal keeps the solve well-conditioned
            vals_l.append(np.array([m + rng.uniform(1, 2)], dtype=dtype))
    if rows_l:
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        vals = np.concatenate(vals_l)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
    else:  # strictly-unit-diagonal factor with no off-diagonal entries
        rows = np.zeros(0, np.int64)
        cols = np.zeros(0, np.int64)
        vals = np.zeros(0, dtype)
    return CSR.from_arrays(vals, _rows_to_rowptr(rows, m), cols, (m, m),
                           nnz=len(rows), capacity=capacity)


def generate_dcsr(m, n, nnz, seed=0, dtype=np.float32):
    """Hypersparse fixture: entries concentrated in few rows — mirrors the
    reference's generate_dcsr (backend/generate.hpp:140-168)."""
    from spblas_tpu.formats.dcsr import DCSR
    rng = np.random.default_rng(seed)
    num_rows = max(1, min(m, nnz // 4 + 1))
    active = np.sort(rng.choice(m, size=num_rows, replace=False))
    rows = rng.choice(active, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    # unique (row, col)
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = rng.uniform(0, 100, len(rows)).astype(dtype)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    csr = CSR.from_arrays(vals, _rows_to_rowptr(rows, m), cols, (m, n),
                          nnz=len(rows))
    return DCSR.from_csr(csr)


def generate_rmat_csr(n, nnz, seed=0, a=0.57, b=0.19, c=0.19,
                      dtype=np.float32) -> CSR:
    """R-MAT power-law pattern (Chakrabarti et al.) — the offline stand-in
    for SuiteSparse-class skewed-degree matrices (BASELINE.md names the
    SuiteSparse set; the benchmark environment has no network egress).

    Recursively drops edges into quadrants with probabilities
    (a, b, c, 1-a-b-c); duplicates are coalesced so the result is a valid
    CSR with nnz <= the requested count.
    """
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    n_pow = 1 << scale
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    for level in range(scale):
        r = rng.random(nnz)
        quad_b = (r >= a) & (r < a + b)
        quad_c = (r >= a + b) & (r < a + b + c)
        quad_d = r >= a + b + c
        bit = 1 << (scale - 1 - level)
        rows += bit * (quad_c | quad_d)
        cols += bit * (quad_b | quad_d)
    keep = (rows < n) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    key = rows * n_pow + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.uniform(0.1, 1.0, len(rows)).astype(dtype) / \
        max(len(rows) / max(n, 1), 1.0)
    return CSR.from_arrays(vals, _rows_to_rowptr(rows, n), cols, (n, n),
                           nnz=len(rows))


def generate_powerlaw_cluster_csr(n, attach=8, p_tri=0.5, seed=0,
                                  dtype=np.float32) -> CSR:
    """Scale-free graph WITH clustering (Holme–Kim powerlaw-cluster
    model): growing preferential attachment where each new link closes
    a triangle with probability ``p_tri`` — the social/web-network
    structure class that is neither mesh-family nor plain R-MAT
    (the checked-in set needed a genuinely non-mesh, non-RMAT
    pattern).  Symmetric, zero-free diagonal, values U(0.1,1)
    scaled by 1/sqrt(deg) so row sums stay O(1).

    No reference counterpart (the reference fixtures are uniform random,
    include/spblas/backend/generate.hpp:49-120); this is a benchmark
    fixture for the power-law + local-clustering regime.
    """
    rng = np.random.default_rng(seed)
    attach = int(attach)
    n = int(n)
    if n <= attach + 1:
        raise ValueError("n must exceed attach+1")
    adj = [set() for _ in range(n)]
    # endpoint pool: each edge contributes both endpoints, so uniform
    # draws from the pool ARE degree-proportional (BA's standard trick)
    pool = []
    for v in range(attach + 1):          # seed clique
        for u in range(v):
            adj[v].add(u)
            adj[u].add(v)
            pool.append(u)
            pool.append(v)
    for v in range(attach + 1, n):
        targets = set()
        last = None
        draws = rng.integers(0, 1 << 62, size=4 * attach)
        coin = rng.random(attach)
        di = 0
        while len(targets) < attach:
            t = None
            if last is not None and coin[len(targets) % attach] < p_tri:
                # triangle step: a random neighbor of the last target
                nbrs = adj[last]
                if nbrs:
                    cand = list(nbrs)[int(draws[di] % len(nbrs))]
                    di = (di + 1) % len(draws)
                    if cand != v and cand not in targets:
                        t = cand
            if t is None:                 # preferential-attachment step
                t = pool[int(draws[di] % len(pool))]
                di = (di + 1) % len(draws)
                if t == v or t in targets:
                    last = None
                    continue
            targets.add(t)
            last = t
        for t in targets:
            adj[v].add(t)
            adj[t].add(v)
            pool.append(v)
            pool.append(t)
    rows = np.concatenate([np.full(len(adj[v]), v, np.int64)
                           for v in range(n)])
    cols = np.concatenate([np.fromiter(adj[v], np.int64, len(adj[v]))
                           for v in range(n)])
    deg = np.bincount(rows, minlength=n)
    # one value per UNDIRECTED edge (numerically symmetric): a u<v
    # half-edge draws the value, the mirror looks it up by edge key
    lo = np.minimum(rows, cols)
    hi = np.maximum(rows, cols)
    key = lo * n + hi
    uniq, inv = np.unique(key, return_inverse=True)
    edge_vals = rng.uniform(0.1, 1.0, len(uniq))
    scale = 1.0 / np.sqrt(np.maximum(deg[lo], 1) *
                          np.maximum(deg[hi], 1)) ** 0.5
    vals = (edge_vals[inv] * scale).astype(dtype)
    return _coo_to_csr(rows, cols, vals, (n, n))


def generate_block_chain_lower(m, block=64, deg=4, seed=0,
                               dtype=np.float32):
    """Lower-triangular with a LONG dependency chain: every row in
    block k depends on ``deg`` rows of block k-1, so the level schedule
    has exactly ceil(m/block) levels with ``block`` rows each — the
    high-level-count solve stressor (no reference
    counterpart: the reference row sweep is sequential regardless,
    algorithms/triangular_solve_impl.hpp:44-93).  Diagonal dominant so
    substitution is well-conditioned."""
    rng = np.random.default_rng(seed)
    rows_i = np.arange(m, dtype=np.int64)
    blk = rows_i // block
    dep_rows = np.repeat(rows_i[blk > 0], deg)
    prev_base = (blk[blk > 0] - 1) * block
    dep_cols = (np.repeat(prev_base, deg)
                + rng.integers(0, block, len(dep_rows)))
    dep_vals = rng.uniform(-0.1, 0.1, len(dep_rows))
    rows = np.concatenate([dep_rows, rows_i])
    cols = np.concatenate([dep_cols, rows_i])
    vals = np.concatenate([dep_vals, rng.uniform(2.0, 3.0, m)])
    # coalesce duplicate deps, keep sorted CSR
    key = rows * np.int64(m) + cols
    order = np.argsort(key, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    head = np.concatenate([[True], key[order][1:] != key[order][:-1]])
    grp = np.cumsum(head) - 1
    out_vals = np.zeros(int(grp[-1]) + 1, np.float64)
    np.add.at(out_vals, grp, vals)
    rows, cols = rows[head], cols[head]
    return CSR.from_arrays(out_vals.astype(dtype),
                           _rows_to_rowptr(rows, m), cols, (m, m),
                           nnz=len(rows))


def generate_block_chain_arrays(m, block=64, deg=4, seed=0,
                                dtype=np.float32):
    """HOST (numpy) arrays of :func:`generate_block_chain_lower` —
    ``(vals, rowptr, cols)`` for inspectors that run on host anyway."""
    rng = np.random.default_rng(seed)
    rows_i = np.arange(m, dtype=np.int64)
    blk = rows_i // block
    dep_rows = np.repeat(rows_i[blk > 0], deg)
    prev_base = (blk[blk > 0] - 1) * block
    dep_cols = (np.repeat(prev_base, deg)
                + rng.integers(0, block, len(dep_rows)))
    dep_vals = rng.uniform(-0.1, 0.1, len(dep_rows))
    rows = np.concatenate([dep_rows, rows_i])
    cols = np.concatenate([dep_cols, rows_i])
    vals = np.concatenate([dep_vals, rng.uniform(2.0, 3.0, m)])
    key = rows * np.int64(m) + cols
    order = np.argsort(key, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    head = np.concatenate([[True], key[order][1:] != key[order][:-1]])
    grp = np.cumsum(head) - 1
    out_vals = np.zeros(int(grp[-1]) + 1, np.float64)
    np.add.at(out_vals, grp, vals)
    rows, cols = rows[head], cols[head]
    return (out_vals.astype(dtype), _rows_to_rowptr(rows, m), cols)
