"""Autodiff through sparse ops — a capability the C++
reference cannot offer.  The jnp-based numeric paths (gather + segment
reductions) are differentiable by construction; these tests pin that
down against dense-oracle gradients."""

import jax
import jax.numpy as jnp
import numpy as np

import spblas_tpu as sp
from spblas_tpu.utils import generate as gen
from tests.util import assert_close


def test_grad_spmv_wrt_x():
    a = gen.generate_csr(30, 40, 200, seed=0)
    x = jnp.asarray(gen.generate_vector(40, seed=1))

    def loss(x):
        return jnp.sum(sp.spmv(a, x) ** 2)

    g = jax.grad(loss)(x)
    dense = np.asarray(a.todense())

    def dense_loss(x):
        return np.sum((dense @ x) ** 2)

    eps = 1e-2
    for i in [0, 7, 39]:
        e = np.zeros(40, np.float32)
        e[i] = eps
        fd = (dense_loss(np.asarray(x) + e)
              - dense_loss(np.asarray(x) - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), fd, rtol=2e-2)


def test_grad_spmv_wrt_values():
    import dataclasses
    a = gen.generate_csr(20, 20, 100, seed=2)
    x = jnp.asarray(gen.generate_vector(20, seed=3))
    y_bar = jnp.asarray(gen.generate_vector(20, seed=4))

    def loss(values):
        a2 = dataclasses.replace(a, values=values)
        return jnp.sum(sp.spmv(a2, x) * y_bar)

    g = np.asarray(jax.grad(loss)(a.values))
    # d(y_bar . A x)/dA[i,j] = y_bar[i] x[j] → per entry e: y_bar[r] x[c]
    nnz = int(a.nnz)
    rows = np.asarray(a.row_ids())[:nnz]
    cols = np.asarray(a.colind)[:nnz]
    expected = np.asarray(y_bar)[rows] * np.asarray(x)[cols]
    assert_close(g[:nnz], expected, factor=256)


def test_grad_spmm():
    a = gen.generate_csr(15, 25, 120, seed=5)
    b = jnp.asarray(gen.generate_gaussian(25, 8, seed=6))

    def loss(b):
        return jnp.sum(sp.spmm(a, b) ** 2)

    g = np.asarray(jax.grad(loss)(b))
    dense = np.asarray(a.todense())
    expected = 2 * dense.T @ (dense @ np.asarray(b))
    assert_close(g, expected, factor=1024)


def test_grad_spgemm_numeric():
    """The SpGEMM numeric phase (fixed structure) differentiates w.r.t.
    operand values — gradient flow through the reuse hot path."""
    import dataclasses
    a = gen.generate_csr(12, 12, 60, seed=7)
    b = gen.generate_csr(12, 12, 60, seed=8)
    info = sp.multiply_compute(a, b)

    def loss(av):
        a2 = dataclasses.replace(a, values=av)
        c = sp.multiply_fill(info, a2, b)
        return jnp.sum(c.values ** 2)

    g = jax.grad(loss)(a.values)
    assert np.isfinite(np.asarray(g)).all()
    # finite-difference spot check on one live entry
    eps = 1e-2
    v0 = np.asarray(a.values)
    e = np.zeros_like(v0)
    e[0] = eps
    fd = (float(loss(jnp.asarray(v0 + e)))
          - float(loss(jnp.asarray(v0 - e)))) / (2 * eps)
    np.testing.assert_allclose(float(g[0]), fd, rtol=5e-2, atol=1e-3)


def test_grad_spgemm_state_numeric():
    """jax.grad through the reuse numeric (SpgemmState) with new values
    matches a finite difference."""
    import dataclasses
    a = gen.generate_csr(24, 24, 120, seed=7)
    b = gen.generate_csr(24, 24, 120, seed=8)
    state = sp.SpgemmState()
    sp.multiply_symbolic_compute(state, a, b)

    def loss(av):
        a2 = dataclasses.replace(a, values=av)
        c = sp.multiply_numeric(state, a2, b)
        return jnp.sum(c.values ** 2)

    g = jax.grad(loss)(a.values)
    assert np.isfinite(np.asarray(g)).all()
    eps = 1e-2
    v0 = np.asarray(a.values)
    e = np.zeros_like(v0)
    e[0] = eps
    fd = (float(loss(jnp.asarray(v0 + e)))
          - float(loss(jnp.asarray(v0 - e)))) / (2 * eps)
    np.testing.assert_allclose(float(g[0]), fd, rtol=5e-2, atol=1e-3)


def test_grad_triangular_solve():
    L = gen.generate_triangular_csr(30, seed=9, lower=True)
    b = jnp.asarray(gen.generate_vector(30, seed=10))
    info = sp.triangular_solve_inspect(L, uplo="lower")

    def loss(b):
        return jnp.sum(sp.triangular_solve(L, b, uplo="lower",
                                           info=info) ** 2)

    g = np.asarray(jax.grad(loss)(b))
    dense = np.asarray(L.todense()).astype(np.float64)
    inv = np.linalg.inv(dense)
    expected = 2 * inv.T @ inv @ np.asarray(b, np.float64)
    np.testing.assert_allclose(g, expected.astype(np.float32),
                               rtol=1e-3, atol=1e-4)


def test_grad_band_spmv():
    """Autodiff of the distributed band sweep (plain jnp panels + halo
    ppermutes) gives the dense adjoint dx = 2 A^T A x."""
    from spblas_tpu.parallel import (dist_band_spmv, make_row_mesh,
                                     partition_band, partition_band_vector)
    from spblas_tpu.utils.generate import generate_banded_csr
    m = 512
    mesh = make_row_mesh(2)
    a = generate_banded_csr(m, m, 11, seed=0)
    plan = partition_band(a, mesh)
    dense = np.asarray(a.todense())
    x = np.random.default_rng(1).standard_normal(m).astype(np.float32)
    xd = partition_band_vector(jnp.asarray(x), plan, mesh)

    def loss(v):
        return jnp.sum(dist_band_spmv(plan, v, mesh) ** 2)

    gx = np.asarray(jax.grad(loss)(xd))[:m]
    exp_dx = 2 * dense.T @ (dense @ x)
    np.testing.assert_allclose(gx, exp_dx, rtol=1e-4, atol=1e-3)


def test_grad_through_matrix_opt_plan_path():
    """grad/vmap over an optimized-matrix multiply differentiate through
    the cached SELL plan."""
    a = gen.generate_csr(800, 800, 6000, seed=4)
    ao = sp.matrix_opt(a)
    x = jnp.asarray(np.random.default_rng(0)
                    .standard_normal(800).astype(np.float32))

    def loss(xv):
        return jnp.sum(sp.multiply(ao, xv) ** 2)

    g = jax.grad(loss)(x)
    e = jnp.zeros_like(x).at[3].set(1e-3)
    fd = (loss(x + e) - loss(x - e)) / 2e-3
    np.testing.assert_allclose(float(g[3]), float(fd), rtol=2e-2,
                               atol=1e-2)
    # vmap over rhs batches
    xb = jnp.stack([x, x * 2])
    yb = jax.vmap(lambda v: sp.multiply(ao, v))(xb)
    assert yb.shape == (2, 800)
