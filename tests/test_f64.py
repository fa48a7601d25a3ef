"""double-precision policy tests.

The reference templates every algorithm over ``double``
(include/spblas/views/csr_view.hpp:12-16; test/gtest/util.hpp:7-23's
tolerance model handles doubles).  Policy here:

  * x64 disabled (jax default): container constructors WARN loudly (or
    raise under SPBLAS_STRICT_DTYPE=1) instead of silently narrowing.
  * x64 enabled: every path runs genuinely in f64 and the
    f64 oracle suites below hold at f64 tolerances (64*eps_f64 —
    ~1e-14 relative, unreachable by an f32 path).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spblas_tpu import (CSR, add, multiply, multiply_compute,
                        multiply_fill, scaled, spmv, transpose,
                        triangular_solve, matrix_opt)
from spblas_tpu.utils import generate as gen
from tests.util import DIMS, assert_close, csr_entries, dense_from_csr


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def _f64_csr(m, n, nnz, seed=0):
    return gen.generate_csr(m, n, nnz, seed=seed, dtype=np.float64)


# ------------------------------------------------------------------ #
# downcast policy (x64 off)
# ------------------------------------------------------------------ #

def test_f64_downcast_warns():
    vals = np.array([1.0, 2.0], dtype=np.float64)
    with pytest.warns(UserWarning, match="narrowed to 32 bits"):
        a = CSR.from_arrays(vals, [0, 1, 2], [0, 1], (2, 2), nnz=2)
    assert a.dtype == jnp.float32


def test_f64_downcast_strict_raises(monkeypatch):
    monkeypatch.setenv("SPBLAS_STRICT_DTYPE", "1")
    vals = np.array([1.0], dtype=np.float64)
    with pytest.raises(TypeError, match="narrowed to 32 bits"):
        CSR.from_arrays(vals, [0, 1], [0], (1, 1), nnz=1)


def test_f32_no_warning(recwarn):
    vals = np.array([1.0, 2.0], dtype=np.float32)
    CSR.from_arrays(vals, [0, 1, 2], [0, 1], (2, 2), nnz=2)
    assert not [w for w in recwarn if "narrowed" in str(w.message)]


# ------------------------------------------------------------------ #
# f64 oracle suites (x64 on) — bounds at 64*eps_f64 prove the whole
# path stayed in double precision
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("m,n,nnz", DIMS)
def test_f64_spmv(x64, m, n, nnz):
    a = _f64_csr(m, n, nnz)
    assert a.dtype == jnp.float64
    x = gen.generate_vector(n, seed=1, dtype=np.float64)
    y = spmv(a, x)
    assert y.dtype == jnp.float64
    assert_close(y, dense_from_csr(a) @ x)


def test_f64_spmv_optimized_plan(x64):
    # the plan chooser must keep f64 on a dtype-preserving path
    m, n, nnz = 400, 400, 4000
    a = _f64_csr(m, n, nnz)
    x = gen.generate_vector(n, seed=2, dtype=np.float64)
    y = spmv(matrix_opt(a), x)
    assert y.dtype == jnp.float64
    assert_close(y, dense_from_csr(a) @ x)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_f64_spmm(x64, k):
    m, n, nnz = 300, 200, 2500
    a = _f64_csr(m, n, nnz)
    b = gen.generate_dense(n, k, seed=3, dtype=np.float64)
    c = multiply(a, jnp.asarray(b))
    assert c.dtype == jnp.float64
    assert_close(c, dense_from_csr(a) @ b)


def test_f64_spgemm_two_phase(x64):
    m, k, n = 120, 90, 110
    a = _f64_csr(m, k, 900, seed=4)
    b = _f64_csr(k, n, 800, seed=5)
    info = multiply_compute(a, b)
    c = multiply_fill(info, a, b)
    assert c.dtype == jnp.float64
    expected = dense_from_csr(a) @ dense_from_csr(b)
    got = np.zeros((m, n))
    for (i, j), v in csr_entries(c).items():
        got[i, j] += v
    assert_close(got, expected)


def test_f64_triangular_solve(x64):
    m = 300
    a = gen.generate_triangular_csr(m, seed=6, lower=True,
                                    dtype=np.float64)
    b = gen.generate_vector(m, seed=7, dtype=np.float64)
    x = triangular_solve(a, b, uplo="lower", diag="explicit")
    assert x.dtype == jnp.float64
    # residual check at f64 tolerance
    assert_close(dense_from_csr(a) @ np.asarray(x), b, factor=512)


def test_f64_add_transpose_scaled(x64):
    m, n = 150, 130
    a = _f64_csr(m, n, 1200, seed=8)
    b = _f64_csr(m, n, 1100, seed=9)
    c = add(a, b)
    assert c.dtype == jnp.float64
    expected = dense_from_csr(a) + dense_from_csr(b)
    got = np.zeros((m, n))
    for (i, j), v in csr_entries(c).items():
        got[i, j] += v
    assert_close(got, expected)

    at = transpose(a)
    assert at.values.dtype == jnp.float64
    got_t = np.zeros((n, m))
    for (i, j), v in csr_entries(at).items():
        got_t[i, j] += v
    assert_close(got_t, dense_from_csr(a).T)

    x = gen.generate_vector(n, seed=10, dtype=np.float64)
    y = spmv(scaled(2.5, a), x)
    assert y.dtype == jnp.float64
    assert_close(y, 2.5 * (dense_from_csr(a) @ x))


# ------------------------------------------------------------------ #
# x64-mode tracing of f32 problems
# ------------------------------------------------------------------ #
# With x64 on, an f32 problem must stay f32 end to end: Python scalars
# and index arithmetic may widen, but no float64 value may appear on the
# numeric path (it would double the bytes moved and change results).


def _all_dtypes(jaxpr, out):
    """Collect aval dtypes of every var in every eqn, recursing through
    sub-jaxprs."""
    for eqn in jaxpr.eqns:
        for v in list(eqn.invars) + list(eqn.outvars):
            if hasattr(v.aval, "dtype"):
                out.append(v.aval.dtype)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            _all_dtypes(sub, out)
    return out


def test_dia_f32_under_x64(x64):
    """f32 DIA SpMV traced with x64 on holds no float64 value and keeps
    f32 numerics."""
    from spblas_tpu.kernels.dia import build_dia_plan, dia_spmv

    a = gen.generate_banded_csr(512, 512, 3, seed=0)
    plan = build_dia_plan(a)
    x = jnp.ones((512,), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda v: dia_spmv(plan, v))(x)
    dts = _all_dtypes(jaxpr.jaxpr, [])
    assert dts and not any(d == jnp.float64 for d in dts)
    y = dia_spmv(plan, x)
    assert y.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(y, np.float64),
                               dense_from_csr(a) @ np.ones(512),
                               rtol=1e-5, atol=1e-5)


def test_sell_bsr_f32_under_x64(x64):
    """Same invariant over the SELL plan and the BSR block kernel."""
    from spblas_tpu.formats.bsr import BSR
    from spblas_tpu.kernels.bsr import bsr_spmv
    from spblas_tpu.kernels.sell import build_sell_plan, sell_spmv

    g = gen.generate_csr(1024, 1024, 8000, seed=2)
    splan = build_sell_plan(g)
    xr = jnp.ones((1024,), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda v: sell_spmv(splan, v))(xr)
    assert not any(d == jnp.float64 for d in _all_dtypes(jaxpr.jaxpr, []))
    assert sell_spmv(splan, xr).dtype == jnp.float32

    dense = np.zeros((64, 256), np.float32)
    dense[8:24, 128:] = 1.0
    b = BSR.from_dense(dense, (8, 128))
    xb = jnp.ones((256,), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda v: bsr_spmv(b, v))(xb)
    assert not any(d == jnp.float64 for d in _all_dtypes(jaxpr.jaxpr, []))
    np.testing.assert_allclose(np.asarray(bsr_spmv(b, xb)), dense @ np.ones(256))
