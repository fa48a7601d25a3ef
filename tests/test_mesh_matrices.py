"""Mesh-family generators + the chooser's DIA rung (realistic
SuiteSparse-class structure)."""

import numpy as np

import jax.numpy as jnp

from spblas_tpu import spmv
from spblas_tpu.kernels import plans as _plans
from spblas_tpu.utils import generate as gen
from tests.util import assert_close, dense_from_csr


def test_stencil_2d_structure():
    a = gen.generate_stencil_csr((20, 30))
    m = 600
    assert a.shape == (m, m)
    d = dense_from_csr(a)
    # symmetric pattern, 5-point: interior rows have degree 5
    assert ((d != 0) == (d.T != 0)).all()
    deg = (d != 0).sum(axis=1)
    assert deg.max() == 5 and deg.min() == 3
    # row 0 couples to (0,1) and (1,0)
    assert d[0, 1] != 0 and d[0, 30] != 0 and d[0, 2] == 0


def test_stencil_3d_structure():
    a = gen.generate_stencil_csr((5, 6, 7))
    d = dense_from_csr(a)
    deg = (d != 0).sum(axis=1)
    assert deg.max() == 7 and deg.min() == 4
    assert ((d != 0) == (d.T != 0)).all()


def test_fem_graph_structure():
    a = gen.generate_fem_graph_csr(15, 12, seed=3)
    d = dense_from_csr(a)
    assert ((d != 0) == (d.T != 0)).all()
    deg = (d != 0).sum(axis=1) - 1          # off-diagonal degree
    assert deg.max() >= 6 and deg.min() >= 2
    # diagonal dominance by construction
    assert (np.abs(np.diag(d)) >= deg).all()


def test_stencil_spmv_oracle():
    a = gen.generate_stencil_csr((25, 25))
    x = gen.generate_vector(625, seed=1)
    y = spmv(a, jnp.asarray(x))
    assert_close(np.asarray(y), dense_from_csr(a) @ x, factor=64,
                 abs_floor=1e-4)


def test_fem_spmv_oracle():
    a = gen.generate_fem_graph_csr(20, 25, seed=2)
    x = gen.generate_vector(500, seed=3)
    y = spmv(a, jnp.asarray(x))
    assert_close(np.asarray(y), dense_from_csr(a) @ x, factor=64,
                 abs_floor=1e-4)


def test_chooser_dia_rung():
    # a wide 5-point stencil is DIA fill 1.0 though far from narrow-band:
    # the chooser must pick DIA, not fall through to SELL
    a = gen.generate_stencil_csr((60, 60))
    kind, plan = _plans.build_matvec_plan(a)
    assert kind == "dia"
    x = gen.generate_vector(3600, seed=4)
    y = np.asarray(_plans.plan_spmv((kind, plan), jnp.asarray(x)))
    assert_close(y, dense_from_csr(a) @ x, factor=64, abs_floor=1e-4)


def test_dia_stacked_reduction_oracle():
    # the DIA stacked reduction against the oracle, on 2D/3D stencils
    # (offsets far apart) and a contiguous band
    from spblas_tpu.kernels.dia import build_dia_plan, dia_spmv
    for a in (gen.generate_stencil_csr((40, 50), seed=1),
              gen.generate_stencil_csr((9, 10, 11), seed=2),
              gen.generate_banded_csr(3000, 3000, 9, seed=3)):
        plan = build_dia_plan(a)
        x = gen.generate_vector(a.shape[1], seed=4)
        y = np.asarray(dia_spmv(plan, jnp.asarray(x)))
        assert_close(y, dense_from_csr(a) @ x, factor=64, abs_floor=1e-3)


def test_powerlaw_cluster_structure_and_spmv():
    """Holme-Kim scale-free + clustered generator: symmetric values,
    power-law degree tail, connected growth."""
    a = gen.generate_powerlaw_cluster_csr(400, attach=5, p_tri=0.5,
                                          seed=2)
    d = dense_from_csr(a)
    np.testing.assert_allclose(d, d.T)           # numerically symmetric
    deg = (d != 0).sum(axis=1)
    assert deg.min() >= 5                        # every node attached
    assert deg.max() >= 4 * deg.mean()           # heavy tail
    x = np.asarray(gen.generate_vector(400, seed=3))
    y = spmv(a, jnp.asarray(x))
    assert_close(np.asarray(y), d @ x)
