"""Distributed-layer tests on the faked 8-device CPU mesh.

What the reference cannot test (it has no distribution, SURVEY.md §2.6):
partition round-trips, ring vs all-gather SpMV equivalence, distributed
SpMM, and the host-planned / device-executed distributed SpGEMM — all
checked against the same dense oracles as the serial suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spblas_tpu import CSR
from spblas_tpu.parallel import (
    DistCSR, assemble_csr, dist_spgemm, dist_spgemm_compute,
    dist_spgemm_numeric, dist_spmm, dist_spmv, gather_result,
    make_row_mesh, partition_csr, partition_rowblock, partition_vector,
    to_local_csr,
)
from spblas_tpu.utils.generate import generate_csr
from tests.util import assert_close

DIMS = [(64, 64, 512), (100, 40, 770), (40, 100, 771), (1000, 100, 100)]


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must fake 8 CPU devices"
    return make_row_mesh(8)


@pytest.mark.parametrize("m,n,nnz", DIMS)
def test_partition_roundtrip(mesh, m, n, nnz):
    a = generate_csr(m, n, nnz, seed=1)
    d = partition_csr(a, mesh)
    back = to_local_csr(d)
    np.testing.assert_allclose(np.asarray(back.todense()),
                               np.asarray(a.todense()), rtol=1e-6)


@pytest.mark.parametrize("m,n,nnz", DIMS)
def test_rowblock_roundtrip(mesh, m, n, nnz):
    a = generate_csr(m, n, nnz, seed=2)
    rb = partition_rowblock(a, mesh)
    back = assemble_csr(rb)
    np.testing.assert_allclose(np.asarray(back.todense()),
                               np.asarray(a.todense()), rtol=1e-6)


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
@pytest.mark.parametrize("m,n,nnz", DIMS)
def test_dist_spmv(mesh, strategy, m, n, nnz):
    a = generate_csr(m, n, nnz, seed=3)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(n).astype(np.float32)
    d = partition_csr(a, mesh)
    xd = partition_vector(x, d, mesh)
    y = gather_result(dist_spmv(d, xd, mesh, strategy=strategy), d)
    expected = np.asarray(a.todense()) @ x
    assert_close(np.asarray(y), expected)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_dist_spmm(mesh, k):
    m, n, nnz = 100, 80, 900
    a = generate_csr(m, n, nnz, seed=4)
    rng = np.random.default_rng(8)
    b = rng.standard_normal((n, k)).astype(np.float32)
    d = partition_csr(a, mesh)
    bd = partition_vector(b, d, mesh)
    c = gather_result(dist_spmm(d, bd, mesh), d)
    expected = np.asarray(a.todense()) @ b
    # distributed reduction order differs from the numpy oracle's
    assert_close(np.asarray(c), expected, factor=1024)


@pytest.mark.parametrize("m,k,n,nnz_a,nnz_b", [
    (64, 64, 64, 512, 512),
    (100, 40, 70, 600, 500),
    (33, 57, 41, 300, 700),
])
def test_dist_spgemm(mesh, m, k, n, nnz_a, nnz_b):
    a = generate_csr(m, k, nnz_a, seed=5)
    b = generate_csr(k, n, nnz_b, seed=6)
    c = assemble_csr(dist_spgemm(a, b, mesh))
    expected = np.asarray(a.todense()) @ np.asarray(b.todense())
    assert_close(np.asarray(c.todense()), expected)


def test_dist_spgemm_numeric_reuse(mesh):
    """New values, same sparsity → plan reuse must track (the distributed
    analogue of rocSPARSE multiply_numeric)."""
    m = k = n = 64
    a = generate_csr(m, k, 500, seed=9)
    b = generate_csr(k, n, 500, seed=10)
    ar = partition_rowblock(a, mesh)
    br = partition_rowblock(b, mesh)
    plan = dist_spgemm_compute(ar, br, mesh)
    c1 = assemble_csr(dist_spgemm_numeric(plan, ar, br, mesh))
    expected1 = np.asarray(a.todense()) @ np.asarray(b.todense())
    assert_close(np.asarray(c1.todense()), expected1)

    import dataclasses
    a2 = dataclasses.replace(ar, values=ar.values * 2.0)
    c2 = assemble_csr(dist_spgemm_numeric(plan, a2, br, mesh))
    assert_close(np.asarray(c2.todense()), 2.0 * expected1)


def test_ring_matches_allgather(mesh):
    m, n, nnz = 256, 256, 4000
    a = generate_csr(m, n, nnz, seed=11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(n).astype(np.float32)
    d = partition_csr(a, mesh)
    xd = partition_vector(x, d, mesh)
    y_ring = np.asarray(dist_spmv(d, xd, mesh, strategy="ring"))
    y_ag = np.asarray(dist_spmv(d, xd, mesh, strategy="allgather"))
    np.testing.assert_allclose(y_ring, y_ag, rtol=1e-5, atol=1e-5)


def test_dist_band_spmv(mesh):
    """Halo-exchange banded SpMV (the north-star distributed config)."""
    from spblas_tpu.parallel import (partition_band, dist_band_spmv,
                                     partition_band_vector)
    from spblas_tpu.utils.generate import generate_banded_csr
    m = 8 * 1024 * 2
    a = generate_banded_csr(m, m, 65, seed=0)
    plan = partition_band(a, mesh)
    x = np.random.default_rng(1).standard_normal(m).astype(np.float32)
    xd = partition_band_vector(x, plan, mesh)
    y = np.asarray(dist_band_spmv(plan, xd, mesh))[:m]
    nnz = int(a.nnz)
    rowptr = np.asarray(a.rowptr)
    cols = np.asarray(a.colind)[:nnz]
    vals = np.asarray(a.values)[:nnz]
    rows = np.repeat(np.arange(m), np.diff(np.minimum(rowptr, nnz)))
    exp = np.zeros(m, np.float32)
    np.add.at(exp, rows, vals * x[cols])
    assert_close(y, exp, factor=1024)


def test_dist_band_rejects_wide_band(mesh):
    from spblas_tpu.parallel import partition_band
    from spblas_tpu.utils.generate import generate_banded_csr
    # h = 2048 exceeds the 1024 local rows per device on an 8-way mesh
    a = generate_banded_csr(4096, 4096, 4097, seed=0)
    with pytest.raises(ValueError):
        partition_band(a, mesh)


def test_dist_band_spmm(mesh):
    from spblas_tpu.parallel import (partition_band, dist_band_spmm,
                                     partition_band_vector)
    from spblas_tpu.utils.generate import generate_banded_csr
    m, k = 8 * 1024, 16
    a = generate_banded_csr(m, m, 33, seed=2)
    plan = partition_band(a, mesh)
    b = np.random.default_rng(3).standard_normal((m, k)).astype(np.float32)
    bd = partition_band_vector(b, plan, mesh)
    c = np.asarray(dist_band_spmm(plan, bd, mesh))[:m]
    nnz = int(a.nnz)
    rowptr = np.asarray(a.rowptr)
    cols = np.asarray(a.colind)[:nnz]
    vals = np.asarray(a.values)[:nnz]
    rows = np.repeat(np.arange(m), np.diff(np.minimum(rowptr, nnz)))
    exp = np.zeros((m, k), np.float32)
    np.add.at(exp, rows, vals[:, None] * b[cols])
    assert_close(c, exp, factor=1024)


def test_dist_add(mesh):
    from spblas_tpu.parallel import dist_add
    a = generate_csr(100, 80, 700, seed=20)
    b = generate_csr(100, 80, 600, seed=21)
    c = assemble_csr(dist_add(a, b, mesh))
    expected = np.asarray(a.todense()) + np.asarray(b.todense())
    assert_close(np.asarray(c.todense()), expected)


def test_dist_add_scaled_numeric_reuse(mesh):
    from spblas_tpu.parallel import (dist_add_compute, dist_add_numeric,
                                     partition_rowblock)
    a = generate_csr(64, 64, 400, seed=22)
    b = generate_csr(64, 64, 300, seed=23)
    ar = partition_rowblock(a, mesh)
    br = partition_rowblock(b, mesh)
    plan = dist_add_compute(ar, br, mesh)
    c = assemble_csr(dist_add_numeric(plan, ar, br, mesh,
                                      alpha=2.0, beta=-1.0))
    expected = 2.0 * np.asarray(a.todense()) - np.asarray(b.todense())
    assert_close(np.asarray(c.todense()), expected)


@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_dist_triangular_solve(mesh, uplo):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from spblas_tpu.parallel import (dist_triangular_solve,
                                     dist_triangular_solve_inspect)
    from spblas_tpu.utils.generate import generate_triangular_csr
    m = 400
    L = generate_triangular_csr(m, seed=30, lower=(uplo == "lower"))
    plan = dist_triangular_solve_inspect(L, mesh, uplo=uplo)
    b = np.random.default_rng(31).standard_normal(m).astype(np.float32)
    bp = jax.device_put(
        jnp.asarray(np.pad(b, (0, 8 * plan.mloc - m))),
        NamedSharding(mesh, P("rows")))
    x = np.asarray(dist_triangular_solve(plan, bp, mesh))[:m]
    residual = np.abs(np.asarray(L.todense()) @ x - b).max()
    assert residual < 1e-4


def test_dist_unstructured_spmv_matches_dense():
    """Unstructured distributed SpMV (generic gather blocks, both
    strategies) — uniform, power-law and rectangular patterns."""
    import numpy as np
    import jax.numpy as jnp
    from spblas_tpu.parallel import (dist_spmv, make_row_mesh,
                                     partition_csr, partition_vector)
    from spblas_tpu.utils.generate import generate_csr, generate_rmat_csr
    from tests.util import assert_close, dense_from_csr

    mesh = make_row_mesh(8)
    for a in (generate_csr(4096, 4096, 40000, seed=1),
              generate_rmat_csr(4096, 4096 * 8, seed=2),
              generate_csr(3000, 2000, 20000, seed=3)):
        d = partition_csr(a, mesh)
        m, n = a.shape
        x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
        xp = partition_vector(jnp.asarray(x), d, mesh)
        for strategy in ("ring", "allgather"):
            y = np.asarray(dist_spmv(d, xp, mesh, strategy))[:m]
            assert_close(y, dense_from_csr(a) @ x, abs_floor=1e-2)


def test_dist_spmv_starved_matrix():
    """A starved matrix (most row blocks hold a handful of entries, many
    blocks none) through the distributed gather blocks."""
    from spblas_tpu.parallel import (dist_spmv, make_row_mesh,
                                     partition_csr, partition_vector)
    from spblas_tpu.utils.generate import generate_csr
    from tests.util import assert_close, dense_from_csr

    mesh = make_row_mesh(8)
    a = generate_csr(16384, 16384, 8192, seed=7)
    d = partition_csr(a, mesh)
    m, n = a.shape
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    xp = partition_vector(jnp.asarray(x), d, mesh)
    y = np.asarray(dist_spmv(d, xp, mesh, "allgather"))[:m]
    assert_close(y, dense_from_csr(a) @ x, abs_floor=1e-2)


def test_dist_sell_spmm_matches_dense():
    """Per-shard SELL plans under shard_map (unstructured distributed
    SpMM), including a hub-heavy pattern with wide buckets."""
    import numpy as np
    import jax.numpy as jnp
    from spblas_tpu.parallel import (make_row_mesh, partition_sell,
                                     dist_sell_spmm)
    from spblas_tpu.utils.generate import generate_csr, generate_rmat_csr
    from tests.util import assert_close, dense_from_csr

    mesh = make_row_mesh(8)
    for a in (generate_csr(2048, 2048, 16000, seed=4),
              generate_rmat_csr(2048, 2048 * 8, seed=5)):
        plan = partition_sell(a, mesh)
        m, n = a.shape
        B = np.random.default_rng(1).standard_normal((n, 12)).astype(
            np.float32)
        Bp = jnp.pad(jnp.asarray(B), ((0, plan.p * plan.nloc - n),
                                      (0, 0)))
        C = np.asarray(dist_sell_spmm(plan, Bp, mesh))[:m]
        assert_close(C, dense_from_csr(a) @ B, abs_floor=1e-2)


def test_partition_spmv_chooser_selects_and_matches():
    """The distributed matvec chooser: banded patterns on request ride
    the halo band pipeline, and the default is the generic gather
    blocks — all against the dense oracle."""
    from spblas_tpu.parallel import (dist_plan_spmv, make_row_mesh,
                                     partition_spmv,
                                     partition_spmv_vector)
    from spblas_tpu.utils.generate import generate_banded_csr, generate_csr
    from tests.util import assert_close, dense_from_csr

    mesh = make_row_mesh(8)
    cases = [
        (generate_csr(2048, 2048, 16000, seed=11), "csr"),
        (generate_banded_csr(2048, 2048, 9, seed=12), "band"),
        (generate_csr(2048, 2048, 16000, seed=11), None),  # default
    ]
    for a, prefer in cases:
        if prefer is None:
            kind, plan = partition_spmv(a, mesh)
            assert kind == "csr", "the default is the generic path"
        else:
            kind, plan = partition_spmv(a, mesh, prefer=prefer)
            assert kind == prefer
        m, n = a.shape
        x = np.random.default_rng(4).standard_normal(n).astype(
            np.float32)
        xp = partition_spmv_vector((kind, plan), x, mesh)
        y = np.asarray(dist_plan_spmv((kind, plan), xp, mesh))[:m]
        assert_close(y, dense_from_csr(a) @ x, abs_floor=1e-2)


def test_partition_spmm_chooser_selects_and_matches():
    """SpMM analogue of the distributed matvec chooser: band patterns
    ride the halo pipeline and unstructured ones the per-shard SELL
    buckets on request, and the default takes the generic gather blocks
    — all against the dense oracle."""
    from spblas_tpu.parallel import (dist_plan_spmm, make_row_mesh,
                                     partition_spmm,
                                     partition_spmm_operand)
    from spblas_tpu.utils.generate import generate_banded_csr, generate_csr
    from tests.util import assert_close, dense_from_csr

    mesh = make_row_mesh(8)
    k = 6
    cases = [
        (generate_csr(2048, 2048, 16000, seed=21), "sell"),
        (generate_banded_csr(2048, 2048, 9, seed=22), "band"),
        (generate_csr(2048, 2048, 16000, seed=21), None),  # default
    ]
    for a, prefer in cases:
        if prefer is None:
            kind, plan = partition_spmm(a, mesh)
            assert kind == "csr", "the default is the generic path"
        else:
            kind, plan = partition_spmm(a, mesh, prefer=prefer)
            assert kind == prefer
        m, n = a.shape
        B = np.random.default_rng(5).standard_normal((n, k)).astype(
            np.float32)
        Bp = partition_spmm_operand((kind, plan), B, mesh)
        C = np.asarray(dist_plan_spmm((kind, plan), Bp, mesh))[:m]
        assert_close(C, dense_from_csr(a) @ B, abs_floor=1e-2)


def test_dist_choosers_reject_unknown_kind():
    """The distributed choosers name their kinds; anything else raises
    (the ROUTE kind no longer exists)."""
    from spblas_tpu.parallel import (make_row_mesh, partition_spmm,
                                     partition_spmv)
    from spblas_tpu.utils.generate import generate_csr

    mesh = make_row_mesh(8)
    a = generate_csr(256, 256, 2000, seed=3)
    with pytest.raises(ValueError):
        partition_spmv(a, mesh, prefer="route")
    with pytest.raises(ValueError):
        partition_spmm(a, mesh, prefer="route")


@pytest.mark.parametrize("op", ["spmv", "spmm"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_dist_band_sweep_devices(p, op):
    """The halo band pipeline (jnp panel sweep + ppermute edges) on 1,
    2, 4 and 8 devices against the dense oracle."""
    from spblas_tpu.parallel import (dist_band_spmm, dist_band_spmv,
                                     make_row_mesh, partition_band,
                                     partition_band_vector)
    from spblas_tpu.utils.generate import generate_banded_csr
    from tests.util import assert_close, dense_from_csr

    mesh = make_row_mesh(p)
    m = 1500
    a = generate_banded_csr(m, m, 41, seed=40 + p)
    plan = partition_band(a, mesh)
    assert plan.p == p and plan.mloc % 128 == 0
    assert plan.width == 128 + 2 * 20
    rng = np.random.default_rng(p)
    v = rng.standard_normal((m,) if op == "spmv" else (m, 3)).astype(
        np.float32)
    vd = partition_band_vector(jnp.asarray(v), plan, mesh)
    fn = dist_band_spmv if op == "spmv" else dist_band_spmm
    y = np.asarray(fn(plan, vd, mesh))
    assert y.shape[0] == p * plan.mloc
    assert_close(y[:m], dense_from_csr(a) @ v, abs_floor=1e-3)
    assert not np.abs(y[m:]).any()
