"""Optimized-plan kernels: ELL and DIA SpMV/SpMM vs the generic path,
and plan selection through matrix_opt."""

import numpy as np
import pytest

import spblas_tpu as sp
from spblas_tpu.kernels import dia, ell, plans
from spblas_tpu.utils import generate as gen
from tests.util import assert_close, dense_from_csr


def test_ell_plan_spmv():
    a = gen.generate_csr(100, 80, 800, seed=0)
    x = gen.generate_vector(80, seed=1)
    plan = ell.build_ell_plan(a)
    y = ell.ell_spmv(plan, x)
    assert_close(np.asarray(y), dense_from_csr(a) @ x)


def test_ell_plan_spmm():
    a = gen.generate_csr(60, 50, 500, seed=2)
    b = gen.generate_dense(50, 16, seed=3)
    plan = ell.build_ell_plan(a)
    c = ell.ell_spmm(plan, b)
    assert_close(np.asarray(c), dense_from_csr(a) @ b, abs_floor=1e-3)


def test_ell_refresh_values():
    a = gen.generate_csr(40, 40, 300, seed=4)
    x = gen.generate_vector(40, seed=5)
    plan = ell.build_ell_plan(a)
    a2 = a.update(values=np.asarray(a.values) * 3)
    plan2 = plan.refresh_values(a2.values)
    assert_close(np.asarray(ell.ell_spmv(plan2, x)),
                 3 * (dense_from_csr(a) @ x))


def test_dia_plan_banded():
    a = gen.generate_banded_csr(200, 200, bandwidth=9, seed=6)
    x = gen.generate_vector(200, seed=7)
    assert dia.dia_fill_fraction(a) > 0.9
    plan = dia.build_dia_plan(a)
    y = dia.dia_spmv(plan, x)
    assert_close(np.asarray(y), dense_from_csr(a) @ x, abs_floor=1e-4)
    b = gen.generate_dense(200, 8, seed=8)
    c = dia.dia_spmm(plan, b)
    assert_close(np.asarray(c), dense_from_csr(a) @ b, abs_floor=1e-2)


def test_dia_rectangular():
    a = gen.generate_banded_csr(50, 70, bandwidth=5, seed=9)
    x = gen.generate_vector(70, seed=10)
    plan = dia.build_dia_plan(a)
    assert_close(np.asarray(dia.dia_spmv(plan, x)), dense_from_csr(a) @ x,
                 abs_floor=1e-4)


def test_plan_chooser():
    banded = gen.generate_banded_csr(128, 128, bandwidth=7, seed=11)
    kind, _ = plans.build_matvec_plan(banded)
    assert kind == "dia"
    scattered = gen.generate_csr(100, 100, 400, seed=12)
    kind, _ = plans.build_matvec_plan(scattered)
    assert kind == "sell"


def test_matrix_opt_uses_plan():
    a = gen.generate_banded_csr(64, 64, bandwidth=5, seed=13)
    x = gen.generate_vector(64, seed=14)
    opt = sp.matrix_opt(a)
    y = sp.multiply(opt, x)
    assert_close(np.asarray(y), dense_from_csr(a) @ x, abs_floor=1e-4)
    assert "plan" in opt._plans  # cached after first use
    b = gen.generate_dense(64, 8, seed=15)
    c = sp.multiply(opt, b)
    assert_close(np.asarray(c), dense_from_csr(a) @ b, abs_floor=1e-2)


def test_band_plan_spmv_spmm():
    """Banded matrices take the DIA plan for both SpMV and SpMM, from
    one cached plan."""
    import jax.numpy as jnp
    a = gen.generate_banded_csr(300, 300, 33, seed=5)
    opt = sp.matrix_opt(a)
    dense = dense_from_csr(a)
    x = np.random.default_rng(6).standard_normal(300).astype(np.float32)
    y = sp.multiply(opt, jnp.asarray(x))
    assert plans.optimized_plan(opt)[0] == "dia"
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=1e-4,
                               atol=1e-4)
    b = np.random.default_rng(7).standard_normal((300, 32)).astype(
        np.float32)
    c = sp.multiply(opt, jnp.asarray(b))
    assert list(opt._plans) == ["plan"]
    np.testing.assert_allclose(np.asarray(c), dense @ b, rtol=1e-4,
                               atol=1e-4)


def test_dia_plan_bf16_storage_error_model():
    """bf16 diagonal storage halves the streamed matrix bytes.

    Values are rounded once to bf16 (rel err <= 2^-9 per entry) and the
    accumulation runs in f32, so |y_bf16 - y| <= 2^-9 * sum_j |a_ij x_j|
    entrywise (plus f32 accumulation dust); f32 storage stays far
    inside that envelope, pinning the error to storage."""
    import jax.numpy as jnp
    from spblas_tpu.formats.csr import CSR
    m, bw = 1024, 65
    a = gen.generate_banded_csr(m, m, bw, seed=11)
    dense = dense_from_csr(a).astype(np.float64)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(m).astype(np.float32)
    y_ref = dense @ x.astype(np.float64)
    bound = (2.0 ** -9) * (np.abs(dense) @ np.abs(x)) + 1e-5 * np.abs(
        y_ref).max()
    a16 = CSR(values=a.values.astype(jnp.bfloat16), rowptr=a.rowptr,
              colind=a.colind, nnz=a.nnz, shape=a.shape)
    y16 = np.asarray(dia.dia_spmv(dia.build_dia_plan(a16),
                                  jnp.asarray(x)), np.float64)
    err16 = np.abs(y16 - y_ref)
    assert (err16 <= bound).all(), (err16 / bound).max()
    y32 = np.asarray(dia.dia_spmv(dia.build_dia_plan(a), jnp.asarray(x)),
                     np.float64)
    assert np.abs(y32 - y_ref).max() <= bound.max() / 20


def test_band_plan_rectangular_guard():
    """A rectangular banded matrix (n < m) keeps its DIA plan exact."""
    import jax.numpy as jnp
    a = gen.generate_banded_csr(200, 160, 9, seed=8)
    kind, plan = plans.build_matvec_plan(a)
    assert kind == "dia"
    x = np.random.default_rng(9).standard_normal(160).astype(np.float32)
    y = plans.plan_spmv((kind, plan), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense_from_csr(a) @ x,
                               rtol=1e-4, atol=1e-4)


def test_bsr_plan_chooser_block_structured():
    """A block-structured CSR matrix takes the general SELL plan (block
    operands are served by BSR containers, kernels/bsr.py) and matches
    the dense oracle for SpMV and SpMM."""
    import jax.numpy as jnp
    from spblas_tpu.formats.csr import CSR

    rng = np.random.default_rng(0)
    dense = np.zeros((64, 512), np.float32)
    for _ in range(10):
        i, j = rng.integers(8), rng.integers(4)
        dense[i*8:(i+1)*8, j*128:(j+1)*128] = rng.standard_normal((8, 128))
    a = CSR.from_dense(dense)
    kind, plan = plans.build_matvec_plan(a)
    assert kind == "sell"
    x = rng.standard_normal(512).astype(np.float32)
    y = plans.plan_spmv((kind, plan), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=1e-4,
                               atol=1e-4)
    b = rng.standard_normal((512, 128)).astype(np.float32)
    c = plans.plan_spmm((kind, plan), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(c), dense @ b, rtol=1e-3,
                               atol=1e-3)


def test_band_power_iterations():
    """A^5 x through a cached plan inside one jitted fori chain."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    m = 700
    a = gen.generate_banded_csr(m, m, 11, seed=0)
    a = dataclasses.replace(a, values=a.values / jnp.float32(11.0))
    opt = sp.matrix_opt(a)
    dense = dense_from_csr(a)
    x = np.random.default_rng(1).standard_normal(m).astype(np.float32)
    y = jax.jit(lambda v: jax.lax.fori_loop(
        0, 5, lambda _, u: sp.multiply(opt, u), v))(jnp.asarray(x))
    exp = x.copy()
    for _ in range(5):
        exp = dense @ exp
    np.testing.assert_allclose(np.asarray(y), exp, rtol=1e-4, atol=1e-5)


def test_plan_spmm_large_b():
    """A wide dense operand through the DIA plan matches the oracle."""
    import jax.numpy as jnp
    a = gen.generate_banded_csr(2048, 2048, 17, seed=20)
    kind, plan = plans.build_matvec_plan(a)
    assert kind == "dia"
    b = np.random.default_rng(21).standard_normal((2048, 1024)).astype(
        np.float32)
    c = plans.plan_spmm((kind, plan), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(c), dense_from_csr(a) @ b,
                               rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------------ #
# the chooser's kind and result for every structure
# ------------------------------------------------------------------ #

_STRUCTURES = {
    "banded": (lambda: gen.generate_banded_csr(500, 500, 9, seed=30),
               "dia"),
    "banded_wide_rect": (lambda: gen.generate_banded_csr(
        300, 500, 7, seed=31), "dia"),
    "stencil2d": (lambda: gen.generate_stencil_csr((20, 25)), "dia"),
    "stencil3d": (lambda: gen.generate_stencil_csr((8, 9, 10)), "dia"),
    "fem_graph": (lambda: gen.generate_fem_graph_csr(20, 20, seed=32),
                  "dia"),
    "uniform": (lambda: gen.generate_csr(400, 400, 4000, seed=33),
                "sell"),
    "uniform_rect": (lambda: gen.generate_csr(300, 700, 3000, seed=34),
                     "sell"),
    "rmat_power_law": (lambda: gen.generate_rmat_csr(512, 512 * 12,
                                                     seed=35), "sell"),
    "powerlaw_cluster": (lambda: gen.generate_powerlaw_cluster_csr(
        300, attach=4, seed=36), "sell"),
    "starved": (lambda: gen.generate_csr(2048, 2048, 256, seed=37),
                "sell"),
    "empty_rows": (lambda: gen.generate_dcsr(500, 500, 600, seed=38),
                   "sell"),
    "block_chain_lower": (lambda: gen.generate_block_chain_lower(
        512, block=32, deg=3, seed=39), "sell"),
    "complex_banded": (lambda: gen.generate_banded_csr(
        256, 256, 5, seed=40, dtype=np.complex64), "dia"),
    "complex_uniform": (lambda: gen.generate_csr(
        256, 256, 2000, seed=41, complex_=True), "sell"),
}


@pytest.mark.parametrize("name", sorted(_STRUCTURES))
def test_chooser_kind_and_result(name):
    import jax.numpy as jnp
    from spblas_tpu.formats.convert import to_csr
    build, expect = _STRUCTURES[name]
    a = to_csr(build())
    kind, plan = plans.build_matvec_plan(a)
    assert kind == expect
    dense = dense_from_csr(a)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, a.shape[1]).astype(dense.dtype)
    y = plans.plan_spmv((kind, plan), jnp.asarray(x))
    assert_close(np.asarray(y), dense @ x, abs_floor=1e-3)
    b = rng.uniform(-1, 1, (a.shape[1], 3)).astype(dense.dtype)
    c = plans.plan_spmm((kind, plan), jnp.asarray(b))
    assert_close(np.asarray(c), dense @ b, abs_floor=1e-3)
