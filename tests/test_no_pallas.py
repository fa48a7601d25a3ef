"""Every public op's traced program is plain XLA: no ``pallas_call`` and
no host callback anywhere in its jaxpr (sub-jaxprs included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spblas_tpu as sp
from spblas_tpu import parallel as par
from spblas_tpu.formats.bsr import BSR
from spblas_tpu.utils import generate as gen

from chip_smoke import forbidden_primitives


def _bsr():
    dense = np.zeros((32, 64), np.float32)
    dense[:8, 16:32] = 1.0
    dense[16:24, :16] = 2.0
    return BSR.from_dense(dense, (8, 16))


def _cases():
    a = gen.generate_csr(200, 200, 1500, seed=0)
    band = gen.generate_banded_csr(300, 300, 9, seed=1)
    L = gen.generate_triangular_csr(150, seed=2)
    x = jnp.ones((200,), jnp.float32)
    b = jnp.ones((200, 4), jnp.float32)
    info_c = sp.multiply_compute(a, a)
    info_t = sp.triangular_solve_inspect(L, uplo="lower")
    info_a = sp.add_inspect(a, a)
    ao, bo = sp.matrix_opt(a), sp.matrix_opt(band)
    bs = _bsr()
    bs2 = BSR.from_dense(np.ones((64, 16), np.float32), (16, 8))
    mesh = par.make_row_mesh(2)
    bplan = par.partition_band(band, mesh)
    bv = par.partition_band_vector(jnp.ones((300,), jnp.float32), bplan,
                                   mesh)
    d = par.partition_csr(a, mesh)
    xd = par.partition_vector(x, d, mesh)
    return {
        "spmv_csr": (lambda v: sp.multiply(a, v), (x,)),
        "spmv_sell": (lambda v: sp.multiply(ao, v), (x,)),
        "spmv_dia": (lambda v: sp.multiply(bo, v),
                     (jnp.ones((300,), jnp.float32),)),
        "spmm_sell": (lambda v: sp.multiply(ao, v), (b,)),
        "spmm_csr": (lambda v: sp.multiply(a, v), (b,)),
        "spgemm_fill": (lambda av: sp.multiply_fill(info_c, av, a), (a,)),
        "sptrsv": (lambda bb: sp.triangular_solve(L, bb, info=info_t),
                   (jnp.ones((150,), jnp.float32),)),
        "add": (lambda av: sp.add_compute(info_a, av, a), (a,)),
        "transpose": (lambda av: sp.transpose(av), (a,)),
        "bsr_spmv": (lambda v: sp.multiply(bs, v),
                     (jnp.ones((64,), jnp.float32),)),
        "bsr_spgemm": (lambda: sp.multiply(bs, bs2), ()),
        "dist_band_spmv": (lambda v: par.dist_band_spmv(bplan, v, mesh),
                           (bv,)),
        "dist_spmv": (lambda v: par.dist_spmv(d, v, mesh), (xd,)),
    }


_NAMES = ["spmv_csr", "spmv_sell", "spmv_dia", "spmm_sell", "spmm_csr",
          "spgemm_fill", "sptrsv", "add", "transpose", "bsr_spmv",
          "bsr_spgemm", "dist_band_spmv", "dist_spmv"]


@pytest.mark.parametrize("name", _NAMES)
def test_op_jaxpr_has_no_pallas_or_callback(name):
    fn, args = _cases()[name]
    closed = jax.make_jaxpr(fn)(*args)
    assert closed.jaxpr.eqns, "traced program is empty"
    assert forbidden_primitives(closed.jaxpr) == set()


def test_forbidden_primitives_finds_callbacks_in_subjaxprs():
    """The checker itself: a host callback nested inside jit and a
    while loop is found."""
    def f(x):
        def body(_, v):
            return jax.pure_callback(lambda u: u, v, v)
        return jax.jit(lambda y: jax.lax.fori_loop(0, 2, body, y))(x)
    closed = jax.make_jaxpr(f)(jnp.ones(3))
    assert forbidden_primitives(closed.jaxpr) == {"pure_callback"}
