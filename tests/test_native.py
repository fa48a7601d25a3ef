"""Native host-runtime tests: C++ inspectors vs numpy oracles, and
Matrix Market IO round-trips."""

import numpy as np
import pytest

from spblas_tpu import native
from spblas_tpu.utils.generate import generate_csr
from spblas_tpu.utils.io import load_matrix_market, save_matrix_market


def _np_csr(m, n, nnz, seed):
    a = generate_csr(m, n, nnz, seed=seed)
    return (np.asarray(a.rowptr).astype(np.int64),
            np.asarray(a.colind), np.asarray(a.values), int(a.nnz), a)


def test_native_lib_builds():
    assert native.get_lib() is not None, "C++ host runtime failed to build"


@pytest.mark.parametrize("m,n,nnz", [(50, 40, 300), (200, 200, 2000)])
def test_ell_geometry_parity(m, n, nnz):
    rowptr, colind, values, k, _ = _np_csr(m, n, nnz, seed=3)
    gather, cols, valid, w = native.ell_geometry(m, m, k, rowptr, colind)
    lengths = np.diff(np.minimum(rowptr, k))
    assert w == lengths.max()
    assert valid.sum() == k
    # every live slot points at its row's own entries, in order
    for i in range(m):
        lo = rowptr[i]
        L = lengths[i]
        np.testing.assert_array_equal(gather[i, :L], np.arange(lo, lo + L))
        np.testing.assert_array_equal(cols[i, :L], colind[lo:lo + L])
        assert not valid[i, L:].any()


def test_transpose_plan_parity():
    m, n, nnz = 60, 45, 500
    rowptr, colind, values, k, a = _np_csr(m, n, nnz, seed=4)
    t_rowptr, perm, t_colind = native.transpose_plan(m, n, k, rowptr,
                                                     colind)
    dense = np.asarray(a.todense())
    t_vals = values[perm]
    out = np.zeros((n, m), dtype=values.dtype)
    rows_t = np.repeat(np.arange(n), np.diff(t_rowptr))
    np.add.at(out, (rows_t, t_colind), t_vals)
    np.testing.assert_allclose(out, dense.T, rtol=1e-6)


def test_spgemm_symbolic_parity():
    m = k = n = 50
    ar, ac, _, ka, a = _np_csr(m, k, 400, seed=5)
    br, bc, _, kb, b = _np_csr(k, n, 400, seed=6)
    c_rowptr, total = native.spgemm_symbolic(m, n, ka, kb, ar, ac, br, bc)
    dense_c = (np.asarray(a.todense()) != 0).astype(np.int64) @ \
        (np.asarray(b.todense()) != 0).astype(np.int64)
    expected_counts = (dense_c != 0).sum(axis=1)
    np.testing.assert_array_equal(np.diff(c_rowptr), expected_counts)
    assert total == expected_counts.sum()


def test_level_schedule_chain():
    # bidiagonal lower: row i depends on i-1 → m levels
    m = 20
    rowptr = np.concatenate([[0], np.arange(1, m + 1) * 2 - 1]).astype(
        np.int64)
    cols = []
    for i in range(m):
        cols.extend([i - 1, i] if i else [0])
    colind = np.asarray(cols, np.int32)
    levels, diag, nl = native.level_schedule(
        m, int(rowptr[-1]), rowptr, colind, True, False)
    assert nl == m
    np.testing.assert_array_equal(levels, np.arange(m))


def test_level_schedule_diagonal_only():
    m = 16
    rowptr = np.arange(m + 1, dtype=np.int64)
    colind = np.arange(m, dtype=np.int32)
    levels, diag, nl = native.level_schedule(m, m, rowptr, colind, True,
                                             False)
    assert nl == 1
    assert (levels == 0).all()
    np.testing.assert_array_equal(diag, np.arange(m))


def test_level_schedule_missing_diag_raises():
    m = 3
    rowptr = np.array([0, 1, 2, 3], np.int64)
    colind = np.array([0, 0, 2], np.int32)  # row 1 has no diagonal
    with pytest.raises(ValueError):
        native.level_schedule(m, 3, rowptr, colind, True, False)
    levels, diag, nl = native.level_schedule(m, 3, rowptr, colind, True,
                                             True)
    assert diag[1] == -1


def test_matrix_market_roundtrip(tmp_path):
    a = generate_csr(30, 20, 150, seed=7)
    p = str(tmp_path / "a.mtx")
    save_matrix_market(p, a)
    b = load_matrix_market(p)
    np.testing.assert_allclose(np.asarray(b.todense()),
                               np.asarray(a.todense()), rtol=1e-6)


def test_matrix_market_symmetric(tmp_path):
    p = str(tmp_path / "s.mtx")
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write("3 3 4\n1 1 2.0\n2 1 -1.0\n3 2 0.5\n3 3 4.0\n")
    a = load_matrix_market(p)
    dense = np.asarray(a.todense())
    expected = np.array([[2.0, -1.0, 0.0],
                         [-1.0, 0.0, 0.5],
                         [0.0, 0.5, 4.0]], dtype=np.float32)
    np.testing.assert_allclose(dense, expected)


def test_matrix_market_pattern_and_dups(tmp_path):
    p = str(tmp_path / "p.mtx")
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        f.write("2 2 3\n1 1\n1 1\n2 2\n")
    a = load_matrix_market(p)
    dense = np.asarray(a.todense())
    np.testing.assert_allclose(dense, np.array([[2.0, 0], [0, 1.0]],
                                               dtype=np.float32))


def test_interop_bcoo_roundtrip():
    from spblas_tpu.utils.interop import from_bcoo, to_bcoo
    a = generate_csr(30, 25, 150, seed=8)
    back = from_bcoo(to_bcoo(a))
    np.testing.assert_allclose(np.asarray(back.todense()),
                               np.asarray(a.todense()))


def test_interop_scipy_roundtrip():
    pytest.importorskip("scipy")
    from spblas_tpu.utils.interop import from_scipy, to_scipy
    a = generate_csr(30, 25, 150, seed=9)
    back = from_scipy(to_scipy(a))
    np.testing.assert_allclose(np.asarray(back.todense()),
                               np.asarray(a.todense()))


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit", [True, False])
def test_level_schedule_native_matches_fallback(monkeypatch, lower, unit):
    """The C++ level scheduler and its numpy fallback agree on levels,
    diagonal positions and level count."""
    from spblas_tpu.utils.generate import generate_triangular_csr
    a = generate_triangular_csr(300, seed=21, lower=lower, density=0.03)
    nnz = int(a.nnz)
    rp = np.asarray(a.rowptr).astype(np.int64)
    ci = np.asarray(a.colind)
    want = native.level_schedule(300, nnz, rp, ci, lower, unit)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    got = native.level_schedule(300, nnz, rp, ci, lower, unit)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_native_build_uses_committed_sources():
    """The library builds from the sources in the package and nothing
    else (no stale source list)."""
    import os
    for src in (native._SRC, native._SRC2):
        assert os.path.exists(src), src
    assert sorted(os.listdir(os.path.dirname(native._SRC))) == sorted(
        os.path.basename(s) for s in (native._SRC, native._SRC2))


class TestSortUtil:
    """Threaded host sort (native/src/sort_util.cpp): must match its
    numpy reference exactly (the symbolic phase relies on stable
    ordering)."""

    def test_argsort_matches_numpy_stable(self):
        rng = np.random.default_rng(11)
        for n in (0, 1, 7, 1000, 200_000):
            # duplicate-heavy keys exercise stability
            key = rng.integers(0, max(n // 50, 2), n) * 12345
            out = native.argsort_i64(key)
            if out is None:
                pytest.skip("native library unavailable")
            order, sk = out
            ref = np.argsort(key, kind="stable")
            np.testing.assert_array_equal(order, ref)
            np.testing.assert_array_equal(sk, key[ref])

    def test_argsort_wide_keys(self):
        rng = np.random.default_rng(12)
        key = rng.integers(0, 1 << 62, 100_000)
        order, sk = native.argsort_i64(key)
        np.testing.assert_array_equal(order,
                                      np.argsort(key, kind="stable"))

    def test_argsort_empty_and_single(self):
        for key in (np.zeros(0, np.int64), np.array([42], np.int64)):
            order, sk = native.argsort_i64(key)
            np.testing.assert_array_equal(order, np.arange(len(key)))
            np.testing.assert_array_equal(sk, key)


class TestReviewHardening:
    """Round-4 native-layer review findings (case-insensitive MM
    banner, argsort negative-key rejection, fallback robustness)."""

    def test_mm_banner_case_insensitive(self, tmp_path):
        # the MM spec makes the banner case-insensitive; a capitalized
        # "Symmetric" silently parsed as general (dropping the mirrored
        # entries) before the fix
        p = tmp_path / "sym.mtx"
        p.write_text("%%MatrixMarket matrix coordinate real Symmetric\n"
                     "3 3 3\n1 1 2.0\n2 1 -1.5\n3 3 4.0\n")
        rows, cols, vals, shape = native.mm_read(str(p))
        assert shape == (3, 3) and len(rows) == 4
        dense = np.zeros((3, 3))
        np.add.at(dense, (rows, cols), vals)
        assert dense[0, 1] == -1.5 and dense[1, 0] == -1.5
        # pure-python fallback agrees
        r2 = native._mm_read_py(str(p))
        assert len(r2[0]) == 4

        p2 = tmp_path / "gen.mtx"
        p2.write_text("%%MatrixMarket MATRIX Coordinate Real General\n"
                      "2 2 1\n2 1 5.0\n")
        rows, cols, vals, shape = native.mm_read(str(p2))
        assert len(rows) == 1 and vals[0] == 5.0

    def test_argsort_rejects_negative_keys(self):
        if native.get_lib() is None:
            pytest.skip("native library unavailable")
        # LSD radix on two's-complement would order negatives after
        # positives; the wrapper must return None (numpy fallback)
        assert native.argsort_i64(
            np.array([5, -3, 2, -7, 9, 0], np.int64)) is None
        key = np.array([5, 3, 2, 7, 9, 0], np.int64)
        order, sk = native.argsort_i64(key)
        np.testing.assert_array_equal(order,
                                      np.argsort(key, kind="stable"))
        np.testing.assert_array_equal(sk, np.sort(key))

    def test_ell_geometry_empty_fallback(self, monkeypatch):
        # the numpy fallback indexed an empty colind even though every
        # slot was invalid (np.where evaluates both branches)
        monkeypatch.setattr(native, "get_lib", lambda: None)
        gather, cols, valid, w = native.ell_geometry(
            3, 3, 0, np.zeros(4, np.int64), np.zeros(0, np.int32))
        assert not valid.any() and cols.shape == gather.shape
