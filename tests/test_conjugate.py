"""Complex / conjugated-view coverage across ops — mirrors the
reference's conjugate_test.cpp (256·eps tolerance there; CPU f32 complex
here uses the same widened factor)."""

import numpy as np
import pytest

import spblas_tpu as sp
from spblas_tpu.utils.generate import (generate_csr, generate_dense,
                                       generate_vector)
from tests.util import assert_close

FACTOR = 256


def _cx(m, n, nnz, seed):
    return generate_csr(m, n, nnz, seed=seed, complex_=True)


def test_conjugated_identity_for_real():
    a = generate_csr(10, 10, 30, seed=0)
    assert sp.conjugated(a) is a          # real → identity (impl:12-28)


def test_double_conjugation_cancels():
    a = _cx(10, 10, 30, seed=0)
    v = sp.conjugated(sp.conjugated(a))
    assert v is a


def test_spmv_conjugated():
    a = _cx(60, 50, 400, seed=1)
    x = generate_vector(50, seed=2, complex_=True)
    y = sp.multiply(sp.conjugated(a), x)
    expected = np.conj(np.asarray(a.todense())) @ np.asarray(x)
    assert_close(np.asarray(y), expected, factor=FACTOR)


def test_spmv_scaled_conjugated():
    a = _cx(40, 40, 300, seed=3)
    x = generate_vector(40, seed=4, complex_=True)
    alpha = 1.5 - 0.5j
    y = sp.multiply(sp.scaled(alpha, sp.conjugated(a)), x)
    expected = alpha * (np.conj(np.asarray(a.todense())) @ np.asarray(x))
    assert_close(np.asarray(y), expected, factor=FACTOR)


def test_spmm_conjugated():
    a = _cx(30, 40, 250, seed=5)
    b = generate_dense(40, 16, seed=6, complex_=True)
    c = sp.multiply(sp.conjugated(a), b)
    expected = np.conj(np.asarray(a.todense())) @ np.asarray(b)
    assert_close(np.asarray(c), expected, factor=FACTOR)


def test_spgemm_conjugated():
    a = _cx(30, 30, 200, seed=7)
    b = _cx(30, 30, 200, seed=8)
    c = sp.multiply(sp.conjugated(a), sp.conjugated(b))
    expected = np.conj(np.asarray(a.todense())) @ \
        np.conj(np.asarray(b.todense()))
    assert_close(np.asarray(c.todense()), expected, factor=FACTOR)


def test_add_conjugated():
    a = _cx(25, 35, 200, seed=9)
    b = _cx(25, 35, 180, seed=10)
    info = sp.add_inspect(a, sp.conjugated(b))
    c = sp.add_compute(info, a, sp.conjugated(b))
    expected = np.asarray(a.todense()) + np.conj(np.asarray(b.todense()))
    assert_close(np.asarray(c.todense()), expected, factor=FACTOR)


def test_conjugate_transpose_is_adjoint():
    a = _cx(20, 30, 150, seed=11)
    x = generate_vector(20, seed=12, complex_=True)
    y = sp.multiply(sp.conjugated(sp.transposed(a)), x)
    expected = np.conj(np.asarray(a.todense())).T @ np.asarray(x)
    assert_close(np.asarray(y), expected, factor=FACTOR)


def test_complex_matrix_opt_plan_is_complex_safe():
    """Complex banded matrices take the dtype-preserving DIA plan."""
    from spblas_tpu.kernels import plans
    from spblas_tpu.utils.generate import generate_banded_csr
    import numpy as np
    a = generate_banded_csr(128, 128, 5, seed=0, dtype=np.complex64)
    kind, plan = plans.build_matvec_plan(a)
    assert kind == "dia"
    import jax.numpy as jnp
    x = (np.random.default_rng(1).standard_normal(128)
         + 1j * np.random.default_rng(2).standard_normal(128)
         ).astype(np.complex64)
    y = plans.plan_spmv((kind, plan), jnp.asarray(x))
    assert y.dtype == jnp.complex64
    expected = np.asarray(a.todense()) @ x
    assert_close(np.asarray(y), expected, factor=FACTOR)


def test_complex_banded_band_cx_plan():
    """complex64 banded matrices keep one complex DIA plan for SpMV and
    SpMM and match the dense oracle."""
    import numpy as np
    import jax.numpy as jnp
    import spblas_tpu as sp
    from spblas_tpu.kernels import plans
    from spblas_tpu.utils import generate as gen
    from tests.util import assert_close

    a = gen.generate_banded_csr(512, 512, 9, seed=11,
                                dtype=np.complex64)
    opt = sp.matrix_opt(a)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)
         ).astype(np.complex64)
    y = np.asarray(sp.multiply(opt, jnp.asarray(x)))
    assert plans.optimized_plan(opt)[0] == "dia"
    want = np.asarray(a.todense()) @ x
    assert_close(y, want, factor=256, abs_floor=1e-2)

    b = (rng.standard_normal((512, 8)) + 1j * rng.standard_normal((512, 8))
         ).astype(np.complex64)
    c = np.asarray(sp.multiply(opt, jnp.asarray(b)))
    wantc = np.asarray(a.todense()) @ b
    assert_close(c, wantc, factor=256, abs_floor=1e-2)
