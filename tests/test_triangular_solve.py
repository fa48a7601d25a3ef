"""SpTRSV tests — mirrors test/gtest/triangular_solve_test.cpp:
lower/upper triangle, explicit/implicit-unit diagonal, plus the
level-schedule inspector-executor split (a capability the reference
leaves to vendors)."""

import numpy as np
import pytest

import spblas_tpu as sp
from spblas_tpu.utils import generate as gen
from tests.util import assert_close, dense_from_csr


def _np_trsv(dense, b, lower, unit):
    m = dense.shape[0]
    x = np.zeros(m, dtype=np.result_type(dense.dtype, b.dtype))
    order = range(m) if lower else range(m - 1, -1, -1)
    for i in order:
        deps = range(i) if lower else range(i + 1, m)
        dot = sum(dense[i, k] * x[k] for k in deps)
        diag = 1.0 if unit else dense[i, i]
        x[i] = (b[i] - dot) / diag
    return x


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit", [True, False])
def test_trsv(lower, unit):
    m = 120
    a = gen.generate_triangular_csr(m, seed=0, lower=lower, unit_diag=unit,
                                    density=0.08)
    b = gen.generate_vector(m, seed=1)
    uplo = "lower" if lower else "upper"
    diag = "unit" if unit else "explicit"
    x = sp.triangular_solve(a, b, uplo=uplo, diag=diag)
    expected = _np_trsv(dense_from_csr(a), b, lower, unit)
    assert_close(np.asarray(x), expected, factor=1024, abs_floor=1e-4)


def test_trsv_inspect_reuse():
    """Level schedule amortized across numeric re-runs (the optimize_trsv
    capability, vendor/onemkl_sycl/triangular_solve_impl.hpp:69-70)."""
    m = 80
    a = gen.generate_triangular_csr(m, seed=2, lower=True, density=0.1)
    info = sp.triangular_solve_inspect(a, uplo="lower", diag="explicit")
    assert info.plan.num_levels >= 1
    dense = dense_from_csr(a)
    for seed in (3, 4):
        b = gen.generate_vector(m, seed=seed)
        x = sp.triangular_solve(a, b, uplo="lower", info=info)
        assert_close(np.asarray(x), _np_trsv(dense, b, True, False),
                     factor=1024, abs_floor=1e-4)


def test_trsv_scaled():
    m = 60
    a = gen.generate_triangular_csr(m, seed=5, lower=True, density=0.1)
    b = gen.generate_vector(m, seed=6)
    x = sp.triangular_solve(sp.scaled(2.0, a), b, uplo="lower")
    expected = _np_trsv(2.0 * dense_from_csr(a), b, True, False)
    assert_close(np.asarray(x), expected, factor=1024, abs_floor=1e-4)


def test_trsv_levels_parallelism():
    """A diagonal matrix solves in one level; a dense-band chain in many."""
    m = 32
    diag_only = gen.generate_triangular_csr(m, seed=7, lower=True,
                                            density=0.0)
    info = sp.triangular_solve_inspect(diag_only, uplo="lower")
    assert info.plan.num_levels == 1


def test_trsv_missing_diag_raises():
    a = gen.generate_triangular_csr(10, seed=8, lower=True, unit_diag=True)
    with pytest.raises(ValueError):
        sp.triangular_solve_inspect(a, uplo="lower", diag="explicit")


def test_trsv_bad_args():
    a = gen.generate_triangular_csr(10, seed=9, lower=True)
    b = gen.generate_vector(10, seed=10)
    with pytest.raises(ValueError):
        sp.triangular_solve(a, b, uplo="diagonal")
    with pytest.raises(ValueError):
        sp.triangular_solve(a, b, diag="fancy")


def test_trsv_skewed_triangle_plan_memory():
    """One dense row must cost O(its nnz), not (levels x rows x width)
    (the first padded plan inflated multiplicatively)."""
    import numpy as np
    import spblas_tpu as sp
    from spblas_tpu.formats.csr import CSR

    m = 400
    rng = np.random.default_rng(0)
    rows, cols = [], []
    for i in range(1, m):          # sparse bidiagonal part
        rows.append(i)
        cols.append(i - 1)
    rows += [m - 1] * (m - 1)      # one dense last row
    cols += list(range(m - 1))
    rows = np.array(rows)
    cols = np.array(cols)
    keep = np.ones(len(rows), bool)
    seen = set()
    for k, (r, c) in enumerate(zip(rows, cols)):
        if (r, c) in seen:
            keep[k] = False
        seen.add((r, c))
    rows, cols = rows[keep], cols[keep]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    # add explicit diagonal
    rows = np.concatenate([rows, np.arange(m)])
    cols = np.concatenate([cols, np.arange(m)])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    vals[rows == cols] = 2.0 + np.abs(vals[rows == cols])
    rowptr = np.zeros(m + 1, np.int64)
    np.add.at(rowptr[1:], rows, 1)
    a = CSR.from_arrays(vals, np.cumsum(rowptr), cols, (m, m),
                        nnz=len(vals))

    info = sp.triangular_solve_inspect(a, uplo="lower")
    plan = info.plan
    # ragged plan: entry stream ~ nnz, not L*R*W
    assert plan.ent_idx.shape[0] <= len(vals) + plan.e_cap
    assert plan.e_cap <= m          # the dense row bounds e_cap, fine
    # solve correctness against scipy-style forward substitution
    b = rng.standard_normal(m).astype(np.float32)
    x = np.asarray(sp.triangular_solve(a, b, uplo="lower", info=info))
    dense = np.zeros((m, m), np.float32)
    dense[rows, cols] = vals
    want = np.zeros(m, np.float64)
    for i in range(m):
        want[i] = (b[i] - dense[i, :i] @ want[:i]) / dense[i, i]
    np.testing.assert_allclose(x, want.astype(np.float32), rtol=2e-3,
                               atol=2e-3)


def test_level_sweep_matches_scipy():
    """The ragged level sweep matches scipy, including a reused info
    with changed values (same structure)."""
    import dataclasses
    import numpy as np
    import scipy.sparse as sps
    import scipy.sparse.linalg as spl
    import spblas_tpu as sp
    from spblas_tpu.utils.generate import generate_triangular_csr
    from tests.util import assert_close

    L = generate_triangular_csr(3000, seed=7, lower=True)
    info = sp.triangular_solve_inspect(L, uplo="lower")
    rng = np.random.default_rng(2)
    b = rng.standard_normal(3000).astype(np.float32)
    x = np.asarray(sp.triangular_solve(L, b, uplo="lower", info=info))
    nnz = int(L.nnz)
    A = sps.csr_matrix((np.asarray(L.values)[:nnz],
                        np.asarray(L.colind)[:nnz],
                        np.asarray(L.rowptr)), shape=(3000, 3000))
    ref = spl.spsolve_triangular(A, b, lower=True)
    assert_close(x, ref, factor=256, abs_floor=1e-4)
    L2 = dataclasses.replace(L, values=L.values * 2.0)
    x2 = np.asarray(sp.triangular_solve(L2, b, uplo="lower", info=info))
    assert_close(x2, ref / 2.0, factor=256, abs_floor=1e-4)


def test_solve_values_refresh_reuses_info():
    """inspect -> solve -> perturb values -> solve with the same info
    matches scipy (the rocSPARSE numeric-reuse contract), for explicit
    and unit diagonals."""
    import dataclasses
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sps
    import scipy.sparse.linalg as spl
    import spblas_tpu as sp
    from spblas_tpu.utils.generate import generate_triangular_csr
    from tests.util import assert_close

    m = 3000
    L = generate_triangular_csr(m, seed=7, lower=True)
    info = sp.triangular_solve_inspect(L, uplo="lower")
    rng = np.random.default_rng(3)
    b = rng.standard_normal(m).astype(np.float32)
    nnz = int(L.nnz)
    pert = (1.0 + 0.1 * rng.standard_normal(nnz)).astype(np.float32)
    new_vals = np.asarray(L.values).copy()
    new_vals[:nnz] *= pert
    L2 = dataclasses.replace(L, values=jnp.asarray(new_vals))
    x2 = np.asarray(sp.triangular_solve(L2, b, uplo="lower", info=info))
    A2 = sps.csr_matrix((new_vals[:nnz], np.asarray(L.colind)[:nnz],
                         np.asarray(L.rowptr)), shape=(m, m))
    ref2 = spl.spsolve_triangular(A2, b, lower=True)
    assert_close(x2, ref2, factor=256,
                 abs_floor=3e-5 * float(np.abs(ref2).max()))

    Lu = generate_triangular_csr(m, seed=9, lower=True, unit_diag=True)
    info_u = sp.triangular_solve_inspect(Lu, uplo="lower", diag="unit")
    nnz_u = int(Lu.nnz)
    vals_u = np.asarray(Lu.values).copy()
    vals_u[:nnz_u] *= 0.5
    Lu2 = dataclasses.replace(Lu, values=jnp.asarray(vals_u))
    xu = np.asarray(sp.triangular_solve(Lu2, b, uplo="lower", diag="unit",
                                        info=info_u))
    Au = sps.csr_matrix((vals_u[:nnz_u], np.asarray(Lu.colind)[:nnz_u],
                         np.asarray(Lu.rowptr)), shape=(m, m))
    Au = (Au + sps.eye(m)).tocsr()
    ref_u = spl.spsolve_triangular(Au, b, lower=True)
    assert_close(xu, ref_u, factor=256,
                 abs_floor=3e-5 * float(np.abs(ref_u).max()))


def test_solve_grad_with_info():
    """jax.grad through a solve with a precomputed info."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import spblas_tpu as sp
    from spblas_tpu.utils.generate import generate_triangular_csr

    L = generate_triangular_csr(300, seed=5, lower=True)
    info = sp.triangular_solve_inspect(L, uplo="lower")
    b = jnp.asarray(
        np.random.default_rng(1).standard_normal(300).astype(np.float32))

    def loss(bv):
        x = sp.triangular_solve(L, bv, uplo="lower", info=info)
        return jnp.sum(x * x)

    g = jax.grad(loss)(b)
    e = jnp.zeros_like(b).at[7].set(1e-3)
    fd = (loss(b + e) - loss(b - e)) / 2e-3
    assert np.isfinite(np.asarray(g)).all()
    np.testing.assert_allclose(float(g[7]), float(fd), rtol=2e-2,
                               atol=1e-3)


@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_deep_level_chain_solve(uplo):
    """A 625-level dependency chain through the ragged sweep, lower and
    (via the transpose) upper."""
    import numpy as np
    import jax.numpy as jnp
    import scipy.sparse as sps
    from spblas_tpu.formats.csr import CSR
    from spblas_tpu.ops.triangular_solve import (
        triangular_solve, triangular_solve_inspect)
    from spblas_tpu.utils.generate import generate_block_chain_lower

    m = 40_000
    L = generate_block_chain_lower(m, block=64, deg=4, seed=3)
    nnz = int(L.nnz)
    A = sps.csr_matrix((np.asarray(L.values)[:nnz],
                        np.array(L.colind)[:nnz], np.asarray(L.rowptr)),
                       shape=(m, m))
    if uplo == "upper":
        A = A.T.tocsr()
        L = CSR.from_arrays(A.data, A.indptr, A.indices, (m, m))
    info = triangular_solve_inspect(L, uplo=uplo)
    assert info.plan.num_levels == m // 64
    b = np.random.default_rng(1).standard_normal(m).astype(np.float32)
    x = np.asarray(triangular_solve(L, jnp.asarray(b), uplo=uplo,
                                    info=info))
    assert np.abs(A @ x - b).max() < 1e-3
