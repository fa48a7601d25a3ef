"""Plan serialization round-trips (SURVEY.md §5.4)."""

import numpy as np

import spblas_tpu as sp
from spblas_tpu.kernels.dia import build_dia_plan, dia_spmv
from spblas_tpu.kernels.ell import build_ell_plan, ell_spmv
from spblas_tpu.utils.generate import generate_banded_csr, generate_csr, \
    generate_triangular_csr, generate_vector
from spblas_tpu.utils.serialize import load_plan, save_plan


def test_ell_plan_roundtrip(tmp_path):
    a = generate_csr(50, 60, 400, seed=0)
    x = generate_vector(60, seed=1)
    plan = build_ell_plan(a)
    p = str(tmp_path / "ell.npz")
    save_plan(p, plan)
    plan2 = load_plan(p)
    np.testing.assert_allclose(np.asarray(ell_spmv(plan2, x)),
                               np.asarray(ell_spmv(plan, x)))


def test_dia_plan_roundtrip(tmp_path):
    a = generate_banded_csr(64, 64, 3, seed=2)
    x = generate_vector(64, seed=3)
    plan = build_dia_plan(a)
    p = str(tmp_path / "dia.npz")
    save_plan(p, plan)
    plan2 = load_plan(p)
    assert plan2.offsets == plan.offsets
    np.testing.assert_allclose(np.asarray(dia_spmv(plan2, x)),
                               np.asarray(dia_spmv(plan, x)))


def test_trsv_plan_roundtrip(tmp_path):
    L = generate_triangular_csr(80, seed=4, lower=True)
    b = generate_vector(80, seed=5)
    info = sp.triangular_solve_inspect(L, uplo="lower")
    p = str(tmp_path / "trsv.npz")
    save_plan(p, info.plan)
    plan2 = load_plan(p)
    info2 = info.update(plan=plan2)
    x1 = sp.triangular_solve(L, b, uplo="lower", info=info)
    x2 = sp.triangular_solve(L, b, uplo="lower", info=info2)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2))


def test_spgemm_plan_roundtrip(tmp_path):
    a = generate_csr(40, 40, 300, seed=6)
    b = generate_csr(40, 40, 300, seed=7)
    info = sp.multiply_compute(a, b)
    p = str(tmp_path / "spgemm.npz")
    save_plan(p, info.plan)
    plan2 = load_plan(p)
    c1 = sp.multiply_fill(info, a, b)
    c2 = sp.multiply_fill(info.update(plan=plan2), a, b)
    np.testing.assert_allclose(np.asarray(c1.todense()),
                               np.asarray(c2.todense()))


def test_permuted_band_plan_roundtrip(tmp_path):
    """A SellPlan holds a TUPLE of bucket dataclasses: each flattens per
    index and the reloaded plan applies identically."""
    from spblas_tpu.kernels.sell import build_sell_plan, sell_spmv
    from spblas_tpu.utils.generate import generate_rmat_csr
    a = generate_rmat_csr(512, 512 * 8, seed=12)
    plan = build_sell_plan(a)
    assert len(plan.buckets) > 3, "fixture must span several buckets"
    p = str(tmp_path / "sell.npz")
    save_plan(p, plan)
    plan2 = load_plan(p)
    assert len(plan2.buckets) == len(plan.buckets)
    x = generate_vector(512, seed=13)
    np.testing.assert_array_equal(np.asarray(sell_spmv(plan2, x)),
                                  np.asarray(sell_spmv(plan, x)))


def test_band_and_bsr_spgemm_plan_roundtrip(tmp_path):
    from spblas_tpu.formats.bsr import BSR
    from spblas_tpu.kernels.bsr import bsr_spgemm_compute
    from spblas_tpu.parallel import (dist_band_spmv, make_row_mesh,
                                     partition_band, partition_band_vector)
    import jax.numpy as jnp
    mesh = make_row_mesh(2)
    a = generate_banded_csr(512, 512, 7, seed=14)
    plan = partition_band(a, mesh)
    p = str(tmp_path / "band.npz")
    save_plan(p, plan)
    plan2 = load_plan(p)
    assert (plan2.h, plan2.mloc, plan2.shape) == (plan.h, plan.mloc,
                                                  plan.shape)
    x = partition_band_vector(jnp.asarray(generate_vector(512, seed=15)),
                              plan, mesh)
    np.testing.assert_allclose(
        np.asarray(dist_band_spmv(plan, x, mesh)),
        np.asarray(dist_band_spmv(plan2, x, mesh)))
    rng = np.random.default_rng(16)
    da = np.zeros((32, 256), np.float32)
    da[:8, :128] = rng.standard_normal((8, 128))
    db = np.zeros((256, 256), np.float32)
    db[:128, :128] = rng.standard_normal((128, 128))
    bplan = bsr_spgemm_compute(BSR.from_dense(da, (8, 128)),
                               BSR.from_dense(db, (128, 128)))
    p2 = str(tmp_path / "bsg.npz")
    save_plan(p2, bplan)
    bplan2 = load_plan(p2)
    np.testing.assert_array_equal(np.asarray(bplan2.pair_a),
                                  np.asarray(bplan.pair_a))
    assert bplan2.nnzb_c == bplan.nnzb_c


def test_dist_sell_plan_roundtrip(tmp_path):
    """DistSellPlan holds tuples of bucket ARRAYS (one '/i' entry
    each)."""
    import jax.numpy as jnp
    from spblas_tpu.parallel import dist_sell_spmm, make_row_mesh, \
        partition_sell
    mesh = make_row_mesh(2)
    a = generate_csr(256, 256, 2000, seed=17)
    plan = partition_sell(a, mesh)
    p = str(tmp_path / "dsell.npz")
    save_plan(p, plan)
    plan2 = load_plan(p)
    assert len(plan2.bucket_values) == len(plan.bucket_values)
    b = jnp.asarray(np.random.default_rng(18).standard_normal(
        (plan.p * plan.nloc, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(dist_sell_spmm(plan2, b, mesh)),
        np.asarray(dist_sell_spmm(plan, b, mesh)))


def test_load_plan_missing_static_fields_use_defaults(tmp_path):
    """Plans saved before a static field existed load with the
    dataclass default: _rebuild must not KeyError on a missing static
    key."""
    import json
    a = generate_csr(60, 60, 400, seed=11)
    info = sp.multiply_compute(a, a)
    assert info.plan.has_d is False
    p = str(tmp_path / "spgemm_old.npz")
    save_plan(p, info.plan)
    with np.load(p, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    static = json.loads(str(payload["__static__"]))
    static.pop("has_d")
    payload["__static__"] = np.str_(json.dumps(static))
    np.savez(p, **payload)
    plan2 = load_plan(p)
    assert plan2.has_d is False
    c1 = sp.multiply_fill(info, a, a)
    c2 = sp.multiply_fill(info.update(plan=plan2), a, a)
    np.testing.assert_array_equal(np.asarray(c1.values),
                                  np.asarray(c2.values))


def test_dist_spgemm_engine_plan_roundtrip(tmp_path):
    """DistSpgemmPlan survives the npz round-trip and keeps producing
    oracle-correct numerics (reloaded arrays land unsharded; shard_map
    re-shards on entry)."""
    from spblas_tpu.parallel import (assemble_csr, dist_spgemm_compute,
                                     dist_spgemm_numeric, make_row_mesh,
                                     partition_rowblock)
    from tests.util import assert_close

    mesh = make_row_mesh(8)
    a = generate_csr(64, 64, 500, seed=21)
    ar = partition_rowblock(a, mesh)
    plan = dist_spgemm_compute(ar, ar, mesh)
    path = str(tmp_path / "dist_mul.npz")
    save_plan(path, plan)
    back = load_plan(path)
    assert back.result_nnz == plan.result_nnz
    c = assemble_csr(dist_spgemm_numeric(back, ar, ar, mesh))
    expected = np.asarray(a.todense()) @ np.asarray(a.todense())
    assert_close(np.asarray(c.todense()), expected, factor=256)
