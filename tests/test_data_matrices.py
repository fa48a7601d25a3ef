"""Checked-in benchmark matrices (data/*.mtx.gz) load through the full
Matrix Market IO path and match their generators (the benchmark must
exercise `load_matrix_market` end-to-end; with no network the files are
generator exports, so equality against the generator is the integrity
check)."""

import os

import numpy as np
import pytest

from spblas_tpu.utils.io import load_matrix_market

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def _gen(name):
    from spblas_tpu.utils.generate import (generate_fem_graph_csr,
                                           generate_powerlaw_cluster_csr,
                                           generate_rmat_csr,
                                           generate_stencil_csr)
    return {
        "fem2d_128": lambda: generate_fem_graph_csr(128, 128, seed=9),
        "stencil3d_32": lambda: generate_stencil_csr((32, 32, 32)),
        "rmat_32k": lambda: generate_rmat_csr(32768, 32768 * 16, seed=5),
        "fem2d_512": lambda: generate_fem_graph_csr(512, 512, seed=7),
        "powerlaw_64k": lambda: generate_powerlaw_cluster_csr(
            65_536, attach=8, p_tri=0.5, seed=7),
    }[name]()


@pytest.mark.parametrize("name", ["fem2d_128", "stencil3d_32",
                                  "rmat_32k", "fem2d_512",
                                  "powerlaw_64k"])
def test_checked_in_matrix_matches_generator(name):
    a = _gen(name)
    b = load_matrix_market(os.path.join(DATA, name + ".mtx.gz"))
    assert b.shape == a.shape
    na, nb = int(a.nnz), int(b.nnz)
    assert na == nb
    np.testing.assert_array_equal(np.asarray(a.rowptr)[: a.shape[0] + 1],
                                  np.asarray(b.rowptr)[: a.shape[0] + 1])
    np.testing.assert_array_equal(np.asarray(a.colind)[:na],
                                  np.asarray(b.colind)[:nb])
    np.testing.assert_allclose(np.asarray(a.values)[:na],
                               np.asarray(b.values)[:nb], rtol=1e-6)


def test_loaded_matrix_spmv_oracle():
    """SpMV through the chooser on a loaded file matches the dense
    oracle (the IO -> plan -> kernel path end-to-end)."""
    from spblas_tpu.kernels import plans as _plans
    from tests.util import assert_close, dense_from_csr

    a = load_matrix_market(os.path.join(DATA, "fem2d_128.mtx.gz"))
    kind, plan = _plans.build_matvec_plan(a)
    m, n = a.shape
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    import jax.numpy as jnp
    y = np.asarray(_plans.plan_spmv((kind, plan), jnp.asarray(x)))
    assert_close(y, dense_from_csr(a) @ x, abs_floor=1e-3)


@pytest.mark.parametrize("name,kind", [
    ("fem2d_128", "dia"), ("fem2d_512", "dia"), ("stencil3d_32", "dia"),
    ("rmat_32k", "sell"), ("powerlaw_64k", "sell")])
def test_chooser_kind_per_data_matrix(name, kind):
    """Each checked-in matrix takes the plan its structure calls for,
    and the plan's SpMV matches scipy on the raw arrays."""
    import jax.numpy as jnp
    import scipy.sparse as sps
    from spblas_tpu.kernels import plans as _plans
    from tests.util import assert_close

    a = load_matrix_market(os.path.join(DATA, name + ".mtx.gz"))
    got_kind, plan = _plans.build_matvec_plan(a)
    assert got_kind == kind
    nnz = int(a.nnz)
    ref = sps.csr_matrix((np.asarray(a.values)[:nnz].astype(np.float64),
                          np.array(a.colind)[:nnz],
                          np.asarray(a.rowptr)), shape=a.shape)
    x = np.random.default_rng(4).standard_normal(a.shape[1]).astype(
        np.float32)
    y = np.asarray(_plans.plan_spmv((got_kind, plan), jnp.asarray(x)))
    assert_close(y, (ref @ x.astype(np.float64)).astype(np.float32),
                 abs_floor=1e-3)
