"""Round-4 review regressions (ops/formats batch): dtype handling on
the plan paths, capacity/flag validation, container padding
invariants."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

import spblas_tpu as sp
from spblas_tpu.formats.coo import COO
from spblas_tpu.formats.csr import CSR
from spblas_tpu.kernels import plans as _plans
from spblas_tpu.utils import generate as gen
from tests.util import assert_close, dense_from_csr


@pytest.fixture
def x64():
    import jax
    with jax.enable_x64(True):
        yield


def test_optimized_spmv_complex_x_takes_base_path():
    """A real-f32 matrix_opt plan must not truncate a complex operand:
    the plan's arithmetic promotes to complex."""
    a = gen.generate_csr(512, 512, 4000, seed=0)
    ao = sp.matrix_opt(a)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(512)
         + 1j * rng.standard_normal(512)).astype(np.complex64)
    y = np.asarray(sp.multiply(ao, jnp.asarray(x)))
    want = dense_from_csr(a).astype(np.complex64) @ x
    assert y.dtype == np.complex64
    assert_close(y, want, factor=256, abs_floor=1e-3)


def test_optimized_spmm_f64_b_takes_base_path(x64):
    a = gen.generate_csr(300, 300, 2500, seed=2)
    ao = sp.matrix_opt(a)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((300, 4))
    c = np.asarray(sp.multiply(ao, jnp.asarray(b)))
    assert c.dtype == np.float64
    assert_close(c, dense_from_csr(a).astype(np.float64) @ b, factor=256)


def test_spgemm_fill_complex_alpha_correct():
    """fill with scaled(1j, a) keeps the imaginary part."""
    a = gen.generate_csr(200, 200, 1500, seed=4)
    info = sp.multiply_compute(a, a)
    c = sp.multiply_fill(info, sp.scaled(1j, a), a)
    want = 1j * (dense_from_csr(a).astype(np.complex64)
                 @ dense_from_csr(a).astype(np.complex64))
    got = np.asarray(c.todense())
    assert got.dtype == np.complex64
    assert_close(got, want, factor=256, abs_floor=1e-2)


def test_spgemm_fill_with_capacity_operand_correct():
    """A with_capacity'd operand (same sparsity, legal) fills the same
    product."""
    a = gen.generate_csr(200, 200, 1500, seed=5)
    info = sp.multiply_compute(a, a)
    ref = np.asarray(sp.multiply_fill(info, a, a).todense())
    a2 = a.with_capacity(2 * a.capacity)
    got = np.asarray(sp.multiply_fill(info, a2, a).todense())
    assert_close(got, ref, factor=64)


def test_symbolic_fill_capacity_overflow_raises():
    a = gen.generate_csr(100, 100, 800, seed=6)
    state = sp.SpgemmState()
    info = state.symbolic_compute(a, a)
    small = CSR.from_arrays(
        np.zeros(4, np.float32), np.zeros(101, np.int64),
        np.zeros(4, np.int32), (100, 100), nnz=4)
    with pytest.raises(RuntimeError, match="capacity"):
        state.symbolic_fill(a, a, c=small)
    # the state must not have been corrupted by the failed call
    c = state.numeric(a, a)
    assert int(c.nnz) == info.result_nnz


def test_triangular_solve_info_flag_mismatch_raises():
    L = gen.generate_triangular_csr(150, seed=7, lower=True)
    info = sp.triangular_solve_inspect(L, uplo="lower")
    b = gen.generate_vector(150, seed=8)
    with pytest.raises(ValueError, match="uplo"):
        sp.triangular_solve(L, b, uplo="upper", info=info)
    with pytest.raises(ValueError, match="diag"):
        sp.triangular_solve(L, b, uplo="lower", diag="unit", info=info)


def test_multiply_dense_times_coo():
    a = np.random.default_rng(9).standard_normal((40, 50)).astype(
        np.float32)
    b_csr = gen.generate_csr(50, 30, 400, seed=10)
    from spblas_tpu.formats.convert import to_coo
    b = to_coo(b_csr)
    got = np.asarray(sp.multiply(jnp.asarray(a), b))
    want = a @ dense_from_csr(b_csr)
    assert_close(got, want, factor=256)


def test_multiply_inspect_dense_matrix_vector():
    info = sp.multiply_inspect(jnp.ones((4, 4)), jnp.ones(4))
    assert info.result_shape == (4,)


def test_coo_from_arrays_stale_tail_is_canonicalized():
    """Caller-supplied oversized buffers with stale tails must not
    contribute to COO numerics (no entry mask on the base path)."""
    rng = np.random.default_rng(11)
    m = 64
    vals = rng.standard_normal(16).astype(np.float32)
    rows = np.sort(rng.integers(0, m, 16)).astype(np.int32)
    cols = rng.integers(0, m, 16).astype(np.int32)
    # oversize the buffers and poison the tails
    vb = np.concatenate([vals, np.full(8, 99.0, np.float32)])
    rb = np.concatenate([rows, np.full(8, 3, np.int32)])
    cb = np.concatenate([cols, np.full(8, 5, np.int32)])
    a = COO.from_arrays(vb, rb, cb, (m, m), nnz=16)
    a.validate()
    x = rng.standard_normal(m).astype(np.float32)
    y = np.asarray(sp.multiply(a, jnp.asarray(x)))
    want = np.zeros(m, np.float32)
    np.add.at(want, rows, vals * x[cols])
    assert_close(y, want, factor=256)


def test_csc_to_coo_delegates_to_canonical_conversion():
    from spblas_tpu.formats.coo import csc_to_coo
    from spblas_tpu.formats.convert import to_csc
    a = gen.generate_csr(30, 40, 200, seed=12)
    coo = csc_to_coo(to_csc(a))
    coo.validate()
    np.testing.assert_allclose(np.asarray(coo.todense()),
                               dense_from_csr(a), rtol=1e-6)


def test_dia_wide_rectangular():
    """Wide rectangular (n >> m) diagonal matrices: x is sized by n, not
    m, and the DIA padding must not go negative."""
    from spblas_tpu.kernels.dia import build_dia_plan, dia_spmv
    m, n = 128, 100_000
    vals = np.arange(1, m + 1, dtype=np.float32)
    a = CSR.from_arrays(vals, np.arange(m + 1, dtype=np.int64),
                        np.arange(m, dtype=np.int32), (m, n), nnz=m)
    plan = build_dia_plan(a)
    x = np.random.default_rng(13).standard_normal(n).astype(np.float32)
    y = np.asarray(dia_spmv(plan, jnp.asarray(x)))
    assert_close(y, vals * x[:m], factor=64)


def test_solve_python_fallback_levels(monkeypatch):
    """Without the native library the numpy level scheduler drives the
    same ragged sweep, on deep level chains."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spl
    from spblas_tpu import native
    monkeypatch.setattr(native, "get_lib", lambda: None)
    rng = np.random.default_rng(14)
    m = 1500
    A = sps.random(m, m, density=0.01,
                   random_state=np.random.RandomState(7),
                   format="csr", dtype=np.float64)
    A = sps.tril(A, k=-1).tocsr()
    diag = np.abs(A).sum(axis=1).A1 + 1.0
    A = (A + sps.diags(diag)).tocsr()
    A.sum_duplicates()
    L = CSR.from_arrays(A.data.astype(np.float32), A.indptr, A.indices,
                        (m, m))
    info = sp.triangular_solve_inspect(L, uplo="lower")
    assert info.plan.num_levels > 10
    b = rng.standard_normal(m).astype(np.float32)
    xs = np.asarray(sp.triangular_solve(L, jnp.asarray(b), uplo="lower",
                                        info=info))
    want = spl.spsolve_triangular(A, b.astype(np.float64), lower=True)
    err = np.abs(xs - want).max() / (np.abs(want).max() + 1)
    assert err < 1e-4, err


def test_power_method_f64_and_complex(x64):
    from spblas_tpu.solvers import power_method
    a = gen.generate_csr(60, 60, 500, seed=15, dtype=np.float64)
    res = power_method(a, 60, iters=30)
    assert res.eigenvector.dtype == jnp.float64
    d = dense_from_csr(a).astype(np.float64)
    lam_ref = np.max(np.abs(np.linalg.eigvals(d)))
    assert abs(abs(float(res.eigenvalue)) - lam_ref) / lam_ref < 0.1


def test_plan_keeps_complex128_operand(x64):
    """An f32 DIA plan applied to a complex128 operand returns
    complex128 at f64 accuracy (no narrowing anywhere)."""
    a = gen.generate_banded_csr(300, 300, 7, seed=16)
    ao = sp.matrix_opt(a)
    rng = np.random.default_rng(17)
    x = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    y = np.asarray(sp.multiply(ao, jnp.asarray(x)))
    assert _plans.optimized_plan(ao)[0] == "dia"
    assert y.dtype == np.complex128
    assert_close(y, dense_from_csr(a).astype(np.float64) @ x)


def test_matrix_market_complex_roundtrip(tmp_path):
    import dataclasses
    from spblas_tpu.utils.io import load_matrix_market, \
        save_matrix_market
    rng = np.random.default_rng(18)
    a = gen.generate_csr(40, 40, 300, seed=19)
    vi = rng.standard_normal(a.values.shape[0]).astype(np.float32)
    vi[int(a.nnz):] = 0.0
    ac = dataclasses.replace(a, values=jnp.asarray(
        (np.asarray(a.values) + 1j * vi).astype(np.complex64)))
    p = str(tmp_path / "cx.mtx")
    save_matrix_market(p, ac)
    back = load_matrix_market(p)
    assert np.issubdtype(back.dtype, np.complexfloating)
    np.testing.assert_allclose(np.asarray(back.todense()),
                               np.asarray(ac.todense()), rtol=1e-5,
                               atol=1e-5)


def test_paned_empty_panel_flagging():
    """A matrix whose rows past the first 1024 are all empty: the SELL
    plan's zero-degree rows read its appended zero row, so they come out
    exactly 0 and nothing is NaN-poisoned."""
    rng = np.random.default_rng(20)
    m = n = 4096
    rows = np.sort(rng.integers(0, 1024, 3000)).astype(np.int64)
    cols = rng.integers(0, n, 3000).astype(np.int32)
    import scipy.sparse as sps
    A = sps.coo_matrix((rng.standard_normal(3000).astype(np.float32),
                        (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    a = CSR.from_arrays(A.data, A.indptr, A.indices, (m, n))
    kind, plan = _plans.build_matvec_plan(a)
    assert kind == "sell"
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(_plans.plan_spmv((kind, plan), jnp.asarray(x)))[:m]
    assert np.all(np.isfinite(y))
    assert np.abs(y[1024:]).max() == 0.0
    assert_close(y, A @ x, factor=256, abs_floor=1e-4)
