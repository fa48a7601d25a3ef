"""Regression tests for the round-1 code-review findings."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import spblas_tpu as sp
from spblas_tpu.utils import generate as gen
from tests.util import assert_close


def test_conj_of_scaled_conjugates_alpha():
    """conj(alpha * A) must equal conj(alpha) * conj(A)."""
    a = gen.generate_csr(20, 20, 80, seed=0, complex_=True)
    x = jnp.asarray(gen.generate_vector(20, seed=1, complex_=True))
    y = sp.multiply(sp.conjugated(sp.scaled(1j, a)), x)
    expected = np.conj(1j * np.asarray(a.todense())) @ np.asarray(x)
    assert_close(np.asarray(y), expected, factor=256)


def test_scaled_inside_and_outside_conjugation():
    a = gen.generate_csr(15, 15, 60, seed=2, complex_=True)
    x = jnp.asarray(gen.generate_vector(15, seed=3, complex_=True))
    v = sp.scaled(2.0 + 1j, sp.conjugated(sp.scaled(3j, a)))
    y = sp.multiply(v, x)
    expected = ((2.0 + 1j) * np.conj(3j)
                * np.conj(np.asarray(a.todense()))) @ np.asarray(x)
    scale = np.abs(expected).max()
    np.testing.assert_allclose(np.asarray(y), expected, rtol=1e-4,
                               atol=1e-5 * scale)


def test_wide_matrix_band_plan_no_crash():
    """Wide matrices (n >> m) must not crash the chosen plan with a
    negative pad."""
    from spblas_tpu.kernels import plans
    rng = np.random.default_rng(4)
    dense = np.zeros((128, 4096), np.float32)
    dense[:, :128] = rng.standard_normal((128, 128))
    from spblas_tpu.formats.csr import CSR
    a = CSR.from_dense(dense)
    kind, plan = plans.build_matvec_plan(a)
    x = rng.standard_normal(4096).astype(np.float32)
    y = plans.plan_spmv((kind, plan), jnp.asarray(x))
    assert_close(np.asarray(y), dense @ x, factor=1024)


def test_spgemm_fill_small_user_capacity_raises():
    a = gen.generate_csr(20, 20, 60, seed=5)
    info = sp.multiply_compute(a, a)
    small = gen.generate_csr(20, 20, 2, seed=6, capacity=2)
    with pytest.raises(RuntimeError):
        sp.multiply_fill(info, a, a, c=small)


def test_spgemm_chunked_honors_conjugation():
    from spblas_tpu import spgemm_chunked
    a = gen.generate_csr(20, 20, 80, seed=7, complex_=True)
    b = gen.generate_csr(20, 20, 80, seed=8, complex_=True)
    c = spgemm_chunked(sp.conjugated(a), b, rows_per_chunk=7)
    expected = np.conj(np.asarray(a.todense())) @ np.asarray(b.todense())
    assert_close(np.asarray(c.todense()), expected, factor=256)


def test_bsr_spgemm_empty_product():
    from spblas_tpu.formats.bsr import BSR
    from spblas_tpu.kernels.bsr import bsr_spgemm
    za = BSR.from_dense(np.zeros((32, 256), np.float32), (8, 128))
    zb = BSR.from_dense(np.zeros((256, 256), np.float32), (128, 128))
    c = bsr_spgemm(za, zb)
    assert int(c.nnz_blocks) == 0
    np.testing.assert_array_equal(np.asarray(c.todense()), 0)


def test_matrix_opt_dense_spmv():
    dense = gen.generate_gaussian(30, 40, seed=9)
    x = jnp.asarray(gen.generate_vector(40, seed=10))
    y = sp.multiply(sp.matrix_opt(dense), x)
    assert_close(np.asarray(y), np.asarray(dense) @ np.asarray(x),
                 factor=256)


def test_add_compute_honors_user_capacity():
    a = gen.generate_csr(20, 20, 60, seed=11)
    b = gen.generate_csr(20, 20, 50, seed=12)
    info = sp.add_inspect(a, b)
    big = gen.generate_csr(20, 20, 10, seed=13,
                           capacity=max(256, info.result_nnz))
    c = sp.add_compute(info, a, b, c=big)
    assert c.capacity == big.capacity
    small = gen.generate_csr(20, 20, 2, seed=14, capacity=2)
    with pytest.raises(RuntimeError):
        sp.add_compute(info, a, b, c=small)


def test_unit_diag_ignores_stored_diagonal():
    """diag='unit' must treat the diagonal as 1 even when diagonal
    entries are stored (triangular_types.hpp: entries are not read)."""
    from spblas_tpu.formats.csr import CSR
    rng = np.random.default_rng(20)
    m = 37
    dense = np.tril(rng.standard_normal((m, m)).astype(np.float32) * 0.1)
    np.fill_diagonal(dense, rng.uniform(2.0, 3.0, m))   # stored, ignored
    L = CSR.from_dense(dense)
    b = rng.standard_normal(m).astype(np.float32)
    x = sp.triangular_solve(L, jnp.asarray(b), uplo="lower", diag="unit")
    unit_dense = dense.copy()
    np.fill_diagonal(unit_dense, 1.0)
    np.testing.assert_allclose(unit_dense @ np.asarray(x), b,
                               rtol=1e-4, atol=1e-4)


def test_dist_unit_diag_ignores_stored_diagonal():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from spblas_tpu.parallel import (dist_triangular_solve,
                                     dist_triangular_solve_inspect,
                                     make_row_mesh)
    from spblas_tpu.formats.csr import CSR
    mesh = make_row_mesh(8)
    rng = np.random.default_rng(21)
    m = 64
    dense = np.tril(rng.standard_normal((m, m)).astype(np.float32) * 0.1)
    np.fill_diagonal(dense, rng.uniform(2.0, 3.0, m))
    L = CSR.from_dense(dense)
    plan = dist_triangular_solve_inspect(L, mesh, uplo="lower",
                                         diag="unit")
    b = rng.standard_normal(m).astype(np.float32)
    bp = jax.device_put(
        jnp.asarray(np.pad(b, (0, 8 * plan.mloc - m))),
        NamedSharding(mesh, P("rows")))
    x = np.asarray(dist_triangular_solve(plan, bp, mesh))[:m]
    unit_dense = dense.copy()
    np.fill_diagonal(unit_dense, 1.0)
    np.testing.assert_allclose(unit_dense @ x, b, rtol=1e-4, atol=1e-4)
