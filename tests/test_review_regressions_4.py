"""Round-4 review regressions (distributed batch): mesh-size guards,
chooser dtype handling, flag validation, scalar promotion, dtype
parity."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spblas_tpu.parallel import (dist_add, dist_band_spmv,
                                 dist_sell_spmm, dist_spmv,
                                 dist_triangular_solve_inspect,
                                 make_row_mesh, partition_band,
                                 partition_band_vector, partition_csr,
                                 partition_rowblock, partition_sell,
                                 partition_spmm, partition_spmv,
                                 partition_vector)
from spblas_tpu.utils import generate as gen
from tests.util import assert_close, dense_from_csr


def test_mesh_size_mismatch_raises():
    """Running a p=8 partition on a 4-device mesh silently dropped half
    the matrix (kernels read [0] of the (2, ...) local slice)."""
    mesh8 = make_row_mesh(8)
    mesh4 = make_row_mesh(4, devices=jax.devices()[:4])
    a = gen.generate_csr(64, 64, 400, seed=0)
    d = partition_csr(a, mesh8)
    x8 = partition_vector(jnp.ones((64,), jnp.float32), d, mesh8)
    with pytest.raises(ValueError, match="partitioned for p=8"):
        dist_spmv(d, x8, mesh4)
    sp8 = partition_sell(a, mesh8)
    with pytest.raises(ValueError, match="partitioned for p=8"):
        dist_sell_spmm(sp8, jnp.ones((sp8.p * sp8.nloc, 2), jnp.float32),
                       mesh4)
    ab = gen.generate_banded_csr(1024, 1024, 5, seed=1)
    bp = partition_band(ab, mesh8)
    xb = partition_band_vector(jnp.ones((1024,), jnp.float32), bp, mesh8)
    with pytest.raises(ValueError, match="partitioned for p=8"):
        dist_band_spmv(bp, xb, mesh4)
    ar8 = partition_rowblock(a, mesh8)
    ar4 = partition_rowblock(a, mesh4)
    with pytest.raises(ValueError, match="partitioned"):
        dist_add(ar8, ar4, mesh8)


def test_dist_chooser_dtype_gate():
    """complex64 matrices take the dtype-preserving gather blocks by
    default and come out numerically right."""
    mesh = make_row_mesh(8)
    a = gen.generate_csr(256, 256, 2000, seed=2)
    rng = np.random.default_rng(3)
    vi = rng.standard_normal(a.values.shape[0]).astype(np.float32)
    vi[int(a.nnz):] = 0.0
    ac = dataclasses.replace(a, values=jnp.asarray(
        (np.asarray(a.values) + 1j * vi).astype(np.complex64)))
    kind, plan = partition_spmv(ac, mesh)
    assert kind == "csr", kind
    kind2, _ = partition_spmm(ac, mesh)
    assert kind2 == "csr", kind2
    # ...and the csr path is numerically right for complex
    from spblas_tpu.parallel import dist_plan_spmv, partition_spmv_vector
    x = jnp.asarray((rng.standard_normal(256)
                     + 1j * rng.standard_normal(256)).astype(np.complex64))
    xv = partition_spmv_vector((kind, plan), x, mesh)
    y = np.asarray(dist_plan_spmv((kind, plan), xv, mesh))[:256]
    want = dense_from_csr(ac) @ np.asarray(x)
    assert_close(y, want, factor=256, abs_floor=1e-3)


def test_dist_trsv_rejects_bad_diag():
    mesh = make_row_mesh(8)
    L = gen.generate_triangular_csr(128, seed=4, lower=True)
    with pytest.raises(ValueError, match="diag"):
        dist_triangular_solve_inspect(L, mesh, diag="implicit")


def test_dist_band_output_dtype_matches_serial():
    """The band kind promotes like the single-device plans:
    result_type(panels, x), so a bf16 operand gives f32."""
    mesh = make_row_mesh(8)
    ab = gen.generate_banded_csr(1024, 1024, 5, seed=5)
    bp = partition_band(ab, mesh)
    xb = partition_band_vector(
        jnp.ones((1024,), jnp.bfloat16), bp, mesh)
    y = dist_band_spmv(bp, xb, mesh)
    assert y.dtype == jnp.float32


def test_dist_add_complex_alpha_promotes():
    mesh = make_row_mesh(8)
    a = gen.generate_csr(64, 64, 300, seed=6)
    b = gen.generate_csr(64, 64, 280, seed=7)
    ar = partition_rowblock(a, mesh)
    br = partition_rowblock(b, mesh)
    c = dist_add(ar, br, mesh, alpha=1j, beta=1.0)
    assert jnp.issubdtype(c.values.dtype, jnp.complexfloating)
    got = np.zeros((64, 64), np.complex64)
    # assemble from row blocks
    vals = np.asarray(c.values)
    cols = np.asarray(c.colind)
    rptr = np.asarray(c.rowptr)
    mloc = c.mloc
    for d in range(vals.shape[0]):
        for rl in range(mloc):
            g = d * mloc + rl
            if g >= 64:
                break
            for k in range(rptr[d, rl], rptr[d, rl + 1]):
                got[g, cols[d, k]] += vals[d, k]
    want = 1j * dense_from_csr(a) + dense_from_csr(b)
    assert_close(got, want, factor=256, abs_floor=1e-4)
