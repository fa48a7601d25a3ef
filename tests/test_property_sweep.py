"""Randomized sweeps over the reference dims grid (util.hpp:27-33) —
many seeds through every op against dense oracles.  Complements the
per-op suites with breadth (the reference CI runs its grid across many
compilers; here we sweep generators instead)."""

import numpy as np
import pytest

import spblas_tpu as sp
from spblas_tpu.utils import generate as gen
from tests.util import DIMS, assert_close

SEEDS = [0, 3, 17]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m,n,nnz", DIMS)
def test_sweep_spmv(m, n, nnz, seed):
    a = gen.generate_csr(m, n, nnz, seed=seed)
    x = gen.generate_vector(n, seed=seed + 1)
    y = sp.multiply(a, x)
    assert_close(np.asarray(y),
                 np.asarray(a.todense()) @ np.asarray(x), factor=256)


@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_spgemm_square(seed):
    m = 60
    a = gen.generate_csr(m, m, 500, seed=seed)
    b = gen.generate_csr(m, m, 450, seed=seed + 100)
    c = sp.multiply(a, b)
    expected = np.asarray(a.todense()) @ np.asarray(b.todense())
    assert_close(np.asarray(c.todense()), expected, factor=256)


@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_add(seed):
    m, n = 80, 70
    a = gen.generate_csr(m, n, 600, seed=seed)
    b = gen.generate_csr(m, n, 550, seed=seed + 200)
    c = sp.add(a, b)
    assert_close(np.asarray(c.todense()),
                 np.asarray(a.todense()) + np.asarray(b.todense()),
                 factor=256)


@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_transpose_roundtrip(seed):
    a = gen.generate_csr(50, 66, 400, seed=seed)
    t = sp.transpose(a)
    tt = sp.transpose(t)
    np.testing.assert_allclose(np.asarray(tt.todense()),
                               np.asarray(a.todense()), rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_sweep_trsv(seed, uplo):
    m = 120
    L = gen.generate_triangular_csr(m, seed=seed,
                                    lower=(uplo == "lower"))
    b = gen.generate_vector(m, seed=seed + 300)
    x = sp.triangular_solve(L, b, uplo=uplo)
    residual = np.abs(np.asarray(L.todense()) @ np.asarray(x)
                      - np.asarray(b)).max()
    assert residual < 1e-3


@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_opt_plan_paths(seed):
    """Sweep the plan chooser across pattern families: every (pattern,
    op) pair must route through its cached plan and match the dense
    oracle (sell / dia selection)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    cases = [
        gen.generate_csr(1500, 1500, 9000, seed=seed),          # sell
        gen.generate_rmat_csr(1024, 1024 * 16, seed=seed),      # sell
        gen.generate_banded_csr(640, 640, 7, seed=seed),        # dia
        gen.generate_csr(900, 700, 5000, seed=seed + 7),        # rect
    ]
    for a in cases:
        m, n = a.shape
        ao = sp.matrix_opt(a)
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(sp.multiply(ao, jnp.asarray(x)))
        assert_close(y, np.asarray(a.todense()) @ x, factor=256,
                     abs_floor=1e-2)
        B = rng.standard_normal((n, 6)).astype(np.float32)
        C = np.asarray(sp.multiply(ao, jnp.asarray(B)))
        assert_close(C, np.asarray(a.todense()) @ B, factor=256,
                     abs_floor=1e-2)
