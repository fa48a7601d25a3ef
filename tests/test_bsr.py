"""BSR container + batched block kernels (kernels/bsr.py) vs the dense
oracle, for several block shapes and f32 / f64 / complex64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spblas_tpu as sp
from spblas_tpu.formats.bsr import BSR
from spblas_tpu.kernels.bsr import (bsr_spgemm, bsr_spgemm_compute,
                                    bsr_spgemm_numeric, bsr_spmm, bsr_spmv)
from spblas_tpu.utils.generate import generate_bsr
from tests.util import assert_close


def _block_dense(m, n, bh, bw, nblocks, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), dtype)
    for _ in range(nblocks):
        i, j = rng.integers(m // bh), rng.integers(n // bw)
        blk = rng.standard_normal((bh, bw))
        if np.dtype(dtype).kind == "c":
            blk = blk + 1j * rng.standard_normal((bh, bw))
        dense[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw] = blk
    return dense


def test_bsr_roundtrip():
    dense = _block_dense(64, 256, 8, 128, 12, seed=0)
    a = BSR.from_dense(dense, (8, 128))
    np.testing.assert_allclose(np.asarray(a.todense()), dense)


def test_bsr_empty_rows():
    dense = np.zeros((32, 256), np.float32)
    dense[8:16, :128] = 1.0   # single block; other block rows empty
    a = BSR.from_dense(dense, (8, 128))
    b = np.ones((256, 128), np.float32)
    c = bsr_spmm(a, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(c), dense @ b, rtol=1e-5)


@pytest.mark.parametrize("k", [128, 256])
def test_bsr_spmm(k):
    dense = _block_dense(64, 512, 8, 128, 20, seed=1)
    a = BSR.from_dense(dense, (8, 128))
    rng = np.random.default_rng(2)
    b = rng.standard_normal((512, k)).astype(np.float32)
    c = bsr_spmm(a, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(c), dense @ b,
                               rtol=1e-4, atol=1e-4)


def test_bsr_spmv():
    dense = _block_dense(64, 512, 8, 128, 20, seed=3)
    a = BSR.from_dense(dense, (8, 128))
    rng = np.random.default_rng(4)
    x = rng.standard_normal(512).astype(np.float32)
    y = bsr_spmv(a, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense @ x,
                               rtol=1e-4, atol=1e-4)


def test_bsr_spgemm():
    da = _block_dense(64, 512, 8, 128, 16, seed=1)
    db = _block_dense(512, 384, 128, 128, 10, seed=2)
    a = BSR.from_dense(da, (8, 128))
    b = BSR.from_dense(db, (128, 128))
    c = bsr_spgemm(a, b)
    np.testing.assert_allclose(np.asarray(c.todense()), da @ db,
                               rtol=1e-4, atol=1e-4)


def test_bsr_spgemm_numeric_reuse():
    da = _block_dense(32, 256, 8, 128, 8, seed=3)
    db = _block_dense(256, 256, 128, 128, 4, seed=4)
    a = BSR.from_dense(da, (8, 128))
    b = BSR.from_dense(db, (128, 128))
    plan = bsr_spgemm_compute(a, b)
    c1 = bsr_spgemm_numeric(plan, a, b)
    a2 = dataclasses.replace(a, values=a.values * 3.0)
    c2 = bsr_spgemm_numeric(plan, a2, b)
    np.testing.assert_allclose(np.asarray(c2.todense()),
                               3.0 * np.asarray(c1.todense()),
                               rtol=1e-5, atol=1e-4)


def test_bsr_spgemm_block_mismatch_raises():
    a = BSR.from_dense(_block_dense(32, 256, 8, 128, 4, seed=5), (8, 128))
    b = BSR.from_dense(_block_dense(256, 256, 8, 128, 4, seed=6), (8, 128))
    with pytest.raises(ValueError):
        bsr_spgemm_compute(a, b)   # A's bk=128 != B's bh=8


def test_multiply_routes_bsr_pair_to_block_spgemm():
    da = _block_dense(64, 256, 8, 128, 10, seed=7)
    db = _block_dense(256, 256, 128, 128, 3, seed=8)
    a = BSR.from_dense(da, (8, 128))
    b = BSR.from_dense(db, (128, 128))
    c = sp.multiply(sp.scaled(2.0, a), b)
    assert isinstance(c, BSR)
    np.testing.assert_allclose(np.asarray(c.todense()), 2.0 * da @ db,
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ #
# every block shape x dtype against the dense oracle, through multiply
# ------------------------------------------------------------------ #

_SHAPES = [(1, 1), (4, 4), (16, 16), (8, 128), (32, 8)]
_DTYPES = [np.float32, np.float64, np.complex64]


@pytest.fixture
def maybe_x64(request):
    dt = request.node.callspec.params["dtype"]
    with jax.enable_x64(dt == np.float64):
        yield


def _operand(bs, dtype, seed):
    bh, bw = bs
    dense = _block_dense(8 * bh, 6 * bw, bh, bw, 14, seed, dtype)
    return BSR.from_dense(dense, bs), dense


@pytest.mark.parametrize("dtype", _DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("bs", _SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bsr_spmv_oracle(maybe_x64, bs, dtype):
    a, dense = _operand(bs, dtype, seed=10)
    assert a.dtype == dtype
    x = np.random.default_rng(11).standard_normal(dense.shape[1]).astype(
        dtype)
    y = sp.multiply(a, jnp.asarray(x))
    assert y.dtype == dtype
    assert_close(np.asarray(y), dense @ x)


@pytest.mark.parametrize("dtype", _DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("bs", _SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bsr_spmm_oracle(maybe_x64, bs, dtype):
    a, dense = _operand(bs, dtype, seed=12)
    b = np.random.default_rng(13).standard_normal(
        (dense.shape[1], 5)).astype(dtype)
    c = sp.multiply(a, jnp.asarray(b))
    assert c.dtype == dtype
    assert_close(np.asarray(c), dense @ b)


@pytest.mark.parametrize("dtype", _DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("bs", _SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bsr_spgemm_oracle(maybe_x64, bs, dtype):
    bh, bw = bs
    a, da = _operand(bs, dtype, seed=14)
    db = _block_dense(6 * bw, 5 * bh, bw, bh, 12, 15, dtype)
    b = BSR.from_dense(db, (bw, bh))
    c = sp.multiply(a, b)
    assert isinstance(c, BSR) and c.block_shape == (bh, bh)
    assert c.dtype == dtype
    assert_close(np.asarray(c.todense()), da @ db)


def test_generate_bsr_structure():
    a = generate_bsr(6, 10, 3, (4, 8), seed=0)
    rp = np.asarray(a.block_rowptr)
    ci = np.asarray(a.block_colind)
    assert a.shape == (24, 80) and int(a.nnz_blocks) == 18
    np.testing.assert_array_equal(rp, np.arange(7) * 3)
    for i in range(6):
        row = ci[rp[i]:rp[i + 1]]
        assert len(set(row)) == 3 and (np.diff(row) > 0).all()
    x = np.ones(80, np.float32)
    np.testing.assert_allclose(np.asarray(sp.multiply(a, jnp.asarray(x))),
                               np.asarray(a.todense()) @ x, rtol=1e-5,
                               atol=1e-5)
