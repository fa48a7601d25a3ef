"""Smoke run of spblas_tpu on one GPU (or, with --four-cards, on four).

Drives every public op once at the sizes its users run, through the entry
points a user calls (``matrix_opt`` + ``multiply``, the two-phase SpGEMM,
``SpgemmState``, ``add``, ``transpose``, ``triangular_solve``, BSR
operands, f64 / complex64 operands, ``jax.grad``), each operand generated
from a seed by ``spblas_tpu.utils.generate`` or read from ``data/``.

For every phase it prints one JSON line: sizes, the plan the chooser
picked, the largest error over its tolerance (every result is compared
with scipy.sparse in float64 on the host: per entry
|y - y_ref| <= 64 eps (|A| |x|)_i, eps of the op's dtype; SpTRSV by its
normalised residual), the first-call seconds (compile plus the first
run) and steady seconds, ``peak_bytes_in_use``, the bytes the op must
move over the steady time against the published HBM peak and a large
copy measured in the same run, ``compiled.memory_analysis()``, and
whether the phase's jaxpr holds a ``pallas_call`` or a host callback.
The timings are smoke timings, not benchmark figures.

Any failed phase fails the run.  The last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage:
    python chip_smoke.py               # single-card phases, one GPU
    python chip_smoke.py --four-cards  # distributed phases, four GPUs
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Iterator

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_FACTOR = 64
FORBIDDEN = ("pallas_call",)          # plus any primitive named *callback*


# ------------------------------------------------------------------ #
# references and tolerance checks (host, float64 / complex128)
# ------------------------------------------------------------------ #

def eps_of(dtype) -> float:
    return float(np.finfo(np.dtype(dtype)).eps)


def wide(dtype):
    return np.complex128 if np.dtype(dtype).kind == "c" else np.float64


def to_scipy(a):
    """CSR container -> scipy csr_matrix in 64-bit precision."""
    import scipy.sparse as sps
    nnz = int(a.nnz)
    vals = np.asarray(a.values)[:nnz]
    return sps.csr_matrix(
        (vals.astype(wide(vals.dtype)), np.array(a.colind)[:nnz],
         np.asarray(a.rowptr).astype(np.int64)), shape=a.shape)


def bsr_to_scipy(b):
    import scipy.sparse as sps
    nb = int(b.nnz_blocks)
    vals = np.asarray(b.values)[:nb]
    return sps.bsr_matrix(
        (vals.astype(wide(vals.dtype)), np.array(b.block_colind)[:nb],
         np.asarray(b.block_rowptr).astype(np.int64)),
        shape=b.shape).tocsr()


def err_ratio(got, ref, scale, eps) -> float:
    """max_i |got - ref| / (64 eps scale_i); <= 1 passes.  ``scale`` is
    the |A| |x| magnitude the sum was formed from."""
    got = np.asarray(got).astype(wide(np.asarray(got).dtype))
    if got.shape != np.shape(ref):
        return float("inf")
    err = np.abs(got - np.asarray(ref))
    bound = TOL_FACTOR * eps * np.asarray(scale)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(err == 0, 0.0, err / bound)
    return float(np.nan_to_num(r, nan=np.inf).max()) if r.size else 0.0


def check_product(a_sp, x, eps):
    """Checker for y = A @ x (vector or dense matrix x)."""
    x64 = np.asarray(x).astype(wide(np.asarray(x).dtype))
    ref = a_sp @ x64
    scale = abs(a_sp) @ np.abs(x64)
    return lambda y: err_ratio(y, ref, scale, eps)


def _keys(m_csr):
    m_csr = m_csr.tocsr()
    m_csr.sum_duplicates()
    m_csr.sort_indices()
    rows = np.repeat(np.arange(m_csr.shape[0], dtype=np.int64),
                     np.diff(m_csr.indptr))
    return rows * m_csr.shape[1] + m_csr.indices, m_csr.data


def lookup(m_csr, rows, cols):
    """Values of ``m_csr`` at (rows, cols), and whether each was stored."""
    keys, data = _keys(m_csr)
    q = np.asarray(rows, np.int64) * m_csr.shape[1] + np.asarray(cols)
    pos = np.minimum(np.searchsorted(keys, q), max(len(keys) - 1, 0))
    found = (keys[pos] == q) if len(keys) else np.zeros(len(q), bool)
    return np.where(found, data[pos] if len(keys) else 0, 0), found


def sparse_err_ratio(got, ref, scale, eps, exact=False) -> float:
    """Error ratio of a scipy sparse result against scipy ``ref``: the
    stored structure must be ``scale``'s (|A| |B|, which no cancellation
    thins) and every stored value within 64 eps scale of ref
    (``exact`` demands equality)."""
    got = got.tocsr()
    got.sum_duplicates()
    c = got.tocoo()
    if c.nnz != _keys(scale)[0].shape[0]:
        return float("inf")
    rv, _ = lookup(ref, c.row, c.col)
    sv, found = lookup(scale, c.row, c.col)
    if not found.all():
        return float("inf")
    if exact:
        return 0.0 if np.array_equal(c.data, rv) else float("inf")
    return err_ratio(c.data, rv, np.abs(sv), eps)


def check_sparse(ref, scale, eps, exact=False, convert=None):
    """Checker of a sparse container result (CSR unless ``convert``)."""
    convert = convert or to_scipy
    return lambda c: sparse_err_ratio(convert(c), ref, scale, eps, exact)


# ------------------------------------------------------------------ #
# phases
# ------------------------------------------------------------------ #

@dataclasses.dataclass
class Phase:
    """One op at one size: ``step(*args)`` calls the public API and is
    traced, compiled and timed; ``check(out)`` returns the largest error
    over its tolerance."""

    name: str
    detail: str
    nnz: int
    plan: str
    step: Callable
    args: tuple
    check: Callable
    bytes: int                      # bytes the op must move per call
    inspect_s: float = 0.0          # host inspect / symbolic seconds
    x64: bool = False


def _vec(n, seed, dtype=np.float32):
    """Seeded operand with mixed signs, U(-1, 1) (complex: both parts)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, n)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.uniform(-1, 1, n)
    return v.astype(dtype)


def _csr_bytes(nnz, m, n, k=1, val=4, idx=4):
    return nnz * (val + idx) + (m + 1) * idx + (m + n) * k * val


def spmv_phases(name, a, detail, seed=1, base=True) -> list:
    """SpMV through matrix_opt + multiply, and the base CSR path."""
    import jax
    import jax.numpy as jnp
    import spblas_tpu as sp
    from spblas_tpu.kernels import plans

    m, n = a.shape
    nnz = int(a.nnz)
    dt = np.dtype(a.dtype)
    x64 = dt in (np.float64, np.complex128)
    x = _vec(n, seed, dt)
    check = check_product(to_scipy(a), x, eps_of(dt))
    val = dt.itemsize
    with jax.enable_x64(x64):
        t0 = time.perf_counter()
        ao = sp.matrix_opt(a)
        kind, plan = plans.optimized_plan(ao)
        inspect_s = time.perf_counter() - t0
        xd = jnp.asarray(x)
    nbytes = (plan.ndiag * m * val + (m + n) * val if kind == "dia"
              else _csr_bytes(nnz, m, n, val=val))
    out = [Phase(f"{name}_{kind}", detail, nnz, kind,
                 lambda xv: sp.multiply(ao, xv), (xd,), check, nbytes,
                 inspect_s, x64=x64)]
    if base:
        out.append(Phase(f"{name}_csr", detail, nnz, "csr",
                         lambda av, xv: sp.multiply(av, xv), (a, xd),
                         check, _csr_bytes(nnz, m, n, val=val), x64=x64))
    return out


def spmm_phase(name, a, k, detail, seed=2) -> Phase:
    import jax.numpy as jnp
    import spblas_tpu as sp
    from spblas_tpu.kernels import plans

    m, n = a.shape
    nnz = int(a.nnz)
    b = _vec(n * k, seed).reshape(n, k)
    t0 = time.perf_counter()
    ao = sp.matrix_opt(a)
    kind, plan = plans.optimized_plan(ao)
    inspect_s = time.perf_counter() - t0
    nbytes = (plan.ndiag * m * 4 + (m + n) * k * 4 if kind == "dia"
              else _csr_bytes(nnz, m, n, k))
    return Phase(name, f"{detail} k={k}", nnz, kind,
                 lambda bv: sp.multiply(ao, bv), (jnp.asarray(b),),
                 check_product(to_scipy(a), b, eps_of(np.float32)),
                 nbytes, inspect_s)


def phases_banded(m=409_600, half=50, k=64) -> Iterator[Phase]:
    from spblas_tpu.utils.generate import generate_banded_csr
    a = generate_banded_csr(m, m, 2 * half + 1, seed=0)
    detail = f"banded m={m} half_bw={half}"
    yield from spmv_phases("spmv_banded", a, detail)
    yield spmm_phase("spmm_banded", a, k, detail)
    del a
    ac = generate_banded_csr(m, m, 2 * half + 1, seed=0,
                             dtype=np.complex64)
    yield from spmv_phases("spmv_banded_c64", ac, detail, base=False)


def phases_stencil(n3=128, n2=1024) -> Iterator[Phase]:
    import jax
    from spblas_tpu.utils.generate import generate_stencil_csr
    a3 = generate_stencil_csr((n3, n3, n3))
    yield from spmv_phases("spmv_stencil3d", a3, f"7-point {n3}^3",
                           base=False)
    del a3
    a2 = generate_stencil_csr((n2, n2))
    yield from spmv_phases("spmv_stencil2d", a2, f"5-point {n2}^2",
                           base=False)
    del a2
    with jax.enable_x64(True):
        a64 = generate_stencil_csr((n3, n3, n3), dtype=np.float64)
    yield from spmv_phases("spmv_stencil3d_f64", a64,
                           f"7-point {n3}^3 f64", base=False)


def phases_uniform(m=4_000_000, deg=10) -> Iterator[Phase]:
    import jax
    from spblas_tpu.formats.csr import CSR
    from spblas_tpu.utils.generate import generate_csr_arrays
    vals, rowptr, cols = generate_csr_arrays(m, m, m * deg, seed=3)
    detail = f"uniform m={m} deg={deg}"
    a = CSR.from_arrays(vals, rowptr, cols, (m, m))
    yield from spmv_phases("spmv_uniform", a, detail)
    del a
    rng = np.random.default_rng(4)
    cvals = (vals + 1j * rng.uniform(0, 100, len(vals))).astype(
        np.complex64)
    ac = CSR.from_arrays(cvals, rowptr, cols, (m, m))
    del cvals
    yield from spmv_phases("spmv_uniform_c64", ac, detail, base=False)
    del ac
    with jax.enable_x64(True):
        a64 = CSR.from_arrays(vals.astype(np.float64), rowptr, cols,
                              (m, m))
    yield from spmv_phases("spmv_uniform_f64", a64, f"{detail} f64",
                           base=False)


def phases_rmat(n=131_072, deg=16) -> Iterator[Phase]:
    from spblas_tpu.utils.generate import generate_rmat_csr
    a = generate_rmat_csr(n, n * deg, seed=5)
    yield from spmv_phases("spmv_rmat", a, f"rmat n={n} deg={deg}")


def phases_data(names=None) -> Iterator[Phase]:
    from spblas_tpu.utils.io import load_matrix_market
    names = names or sorted(f[:-len(".mtx.gz")] for f in
                            os.listdir(os.path.join(ROOT, "data"))
                            if f.endswith(".mtx.gz"))
    for nm in names:
        a = load_matrix_market(os.path.join(ROOT, "data", nm + ".mtx.gz"))
        yield from spmv_phases(f"spmv_data_{nm}", a, f"data/{nm}",
                               base=False)


def phases_spmm_uniform(m=100_000, deg=10, k=256) -> Iterator[Phase]:
    from spblas_tpu.utils.generate import generate_csr
    a = generate_csr(m, m, m * deg, seed=6)
    yield spmm_phase("spmm_uniform", a, k, f"uniform m={m} deg={deg}")


def phases_spgemm(m=100_000, nnz=1_000_000) -> Iterator[Phase]:
    import dataclasses as dc
    import jax.numpy as jnp
    import spblas_tpu as sp
    from spblas_tpu.utils.generate import generate_csr

    a = generate_csr(m, m, nnz, seed=7)
    a_sp = to_scipy(a)
    eps = eps_of(np.float32)
    detail = f"C=A*A uniform m={m} nnz={nnz}"
    t0 = time.perf_counter()
    info = sp.multiply_compute(a, a)
    inspect_s = time.perf_counter() - t0
    nnz_c = info.result_nnz
    nbytes = (2 * nnz + nnz_c) * 8
    ref, scale = a_sp @ a_sp, abs(a_sp) @ abs(a_sp)
    yield Phase("spgemm_two_phase", f"{detail} nnz_c={nnz_c}", nnz,
                "esc", lambda av, bv: sp.multiply_fill(info, av, bv),
                (a, a), check_sparse(ref, scale, eps), nbytes, inspect_s)

    # numeric reuse: new values, same sparsity, through SpgemmState
    state = sp.SpgemmState()
    t0 = time.perf_counter()
    sp.multiply_symbolic_compute(state, a, a)
    inspect_s = time.perf_counter() - t0
    v2 = jnp.asarray(_vec(a.capacity, 8)) * (jnp.arange(a.capacity)
                                            < nnz)
    a2 = dc.replace(a, values=v2)
    a2_sp = to_scipy(a2)
    yield Phase("spgemm_reuse_numeric", f"{detail} new values", nnz,
                "esc", lambda av: sp.multiply_numeric(state, av, a),
                (a2,), check_sparse(a2_sp @ a_sp, abs(a2_sp) @ abs(a_sp),
                                    eps), nbytes, inspect_s)

    # the 4-argument fused C = alpha*A*B + beta*D (D: A's structure)
    alpha, beta = 0.5, -2.0
    fused = sp.SpgemmState()
    t0 = time.perf_counter()
    sp.multiply_fused(fused, sp.scaled(alpha, a), a, sp.scaled(beta, a2))
    inspect_s = time.perf_counter() - t0
    ref_f = alpha * (a_sp @ a_sp) + beta * a2_sp
    scale_f = abs(alpha) * (abs(a_sp) @ abs(a_sp)) + abs(beta) * abs(a2_sp)
    yield Phase("spgemm_fused_4arg", f"{detail} alpha={alpha} "
                f"beta={beta}", nnz, "esc",
                lambda av, dv: fused.numeric(sp.scaled(alpha, av), a,
                                             d=sp.scaled(beta, dv)),
                (a, a2), check_sparse(ref_f, scale_f, eps),
                nbytes + nnz * 8, inspect_s)


def _check_residual(l_sp, b, eps):
    def check(x):
        x = np.asarray(x).astype(np.float64)
        r = np.abs(l_sp @ x - b).max()
        den = (abs(l_sp) @ np.abs(x)).max()
        return float(r / (TOL_FACTOR * eps * den)) if den else float(r)
    return check


def phases_sptrsv(m=1_000_000, block=64, deg=4) -> Iterator[Phase]:
    import jax.numpy as jnp
    import spblas_tpu as sp
    from spblas_tpu.formats.csr import CSR
    from spblas_tpu.utils.generate import generate_block_chain_lower

    low = generate_block_chain_lower(m, block=block, deg=deg, seed=9)
    l_sp = to_scipy(low)
    u_sp = l_sp.T.tocsr()
    up = CSR.from_arrays(u_sp.data.astype(np.float32), u_sp.indptr,
                         u_sp.indices, (m, m))
    b = _vec(m, 10)
    nnz = int(low.nnz)
    for uplo, mat, mat_sp in (("lower", low, l_sp), ("upper", up, u_sp)):
        t0 = time.perf_counter()
        info = sp.triangular_solve_inspect(mat, uplo=uplo)
        inspect_s = time.perf_counter() - t0
        yield Phase(
            f"sptrsv_{uplo}",
            f"block chain m={m} block={block} deg={deg} "
            f"levels={info.plan.num_levels}", nnz, "level_sweep",
            lambda av, bv, info=info, uplo=uplo: sp.triangular_solve(
                av, bv, uplo=uplo, info=info),
            (mat, jnp.asarray(b)), _check_residual(mat_sp, b,
                                                   eps_of(np.float32)),
            _csr_bytes(nnz, m, m), inspect_s)


def phases_add_transpose(m=1_000_000, deg=10) -> Iterator[Phase]:
    import spblas_tpu as sp
    from spblas_tpu.utils.generate import generate_csr

    a = generate_csr(m, m, m * deg, seed=11)
    b = generate_csr(m, m, m * deg, seed=12)
    a_sp, b_sp = to_scipy(a), to_scipy(b)
    nnz = int(a.nnz)
    detail = f"uniform m={m} deg={deg}"
    t0 = time.perf_counter()
    info = sp.add_inspect(a, b)
    inspect_s = time.perf_counter() - t0
    yield Phase("spadd", detail, 2 * nnz, "merge",
                lambda av, bv: sp.add_compute(info, av, bv), (a, b),
                check_sparse(a_sp + b_sp, abs(a_sp) + abs(b_sp),
                             eps_of(np.float32)),
                (2 * nnz + info.result_nnz) * 8, inspect_s)
    at = a_sp.T.tocsr()
    yield Phase("transpose", detail, nnz, "sort",
                lambda av: sp.transpose(av), (a,),
                check_sparse(at, abs(at), 0.0, exact=True),
                4 * nnz * 8)


def phases_bsr(block_shape=(16, 16), mb=16_384, nb=16_384, per_row=4,
               k=64) -> Iterator[Phase]:
    import jax.numpy as jnp
    import spblas_tpu as sp
    from spblas_tpu.utils.generate import generate_bsr

    bh, bw = block_shape
    a = generate_bsr(mb, nb, per_row, block_shape, seed=13)
    a_sp = bsr_to_scipy(a)
    m, n = a.shape
    stored = mb * per_row * bh * bw
    eps = eps_of(np.float32)
    tag = f"{bh}x{bw}"
    detail = f"bsr {m}x{n} blocks={tag} stored={stored}"
    x = _vec(n, 14)
    yield Phase(f"bsr{tag}_spmv", detail, stored, "bsr",
                lambda av, xv: sp.multiply(av, xv), (a, jnp.asarray(x)),
                check_product(a_sp, x, eps), stored * 4 + (m + n) * 4)
    bmat = _vec(n * k, 15).reshape(n, k)
    yield Phase(f"bsr{tag}_spmm", f"{detail} k={k}", stored, "bsr",
                lambda av, bv: sp.multiply(av, bv),
                (a, jnp.asarray(bmat)), check_product(a_sp, bmat, eps),
                stored * 4 + (m + n) * k * 4)
    # B has transposed blocks (bw, bh) so C = A B has (bh, bh) blocks;
    # its block rows hold as many stored values as A's
    b_rows = n // bw
    b = generate_bsr(b_rows, m // bh, max(1, mb * per_row // b_rows),
                     (bw, bh), seed=16)
    b_sp = bsr_to_scipy(b)
    from spblas_tpu.kernels.bsr import bsr_spgemm_compute
    t0 = time.perf_counter()
    plan = bsr_spgemm_compute(a, b)
    inspect_s = time.perf_counter() - t0
    # multiply runs the host block-symbolic phase while it is traced
    yield Phase(f"bsr{tag}_spgemm",
                f"{detail} x bsr blocks={bw}x{bh} "
                f"pairs={int(plan.pair_a.shape[0])}", stored, "bsr",
                lambda: sp.multiply(a, b), (),
                check_sparse(a_sp @ b_sp, abs(a_sp) @ abs(b_sp), eps,
                             convert=bsr_to_scipy),
                (2 * stored + plan.nnzb_c * bh * bh) * 4, inspect_s)


def phases_grad(m=100_000, deg=10) -> Iterator[Phase]:
    import dataclasses as dc
    import jax
    import jax.numpy as jnp
    import spblas_tpu as sp
    from spblas_tpu.formats.csr import host_row_ids
    from spblas_tpu.utils.generate import generate_csr

    a = generate_csr(m, m, m * deg, seed=17)
    a_sp = to_scipy(a)
    nnz = int(a.nnz)
    eps = eps_of(np.float32)
    g = _vec(m, 18)
    ao = sp.matrix_opt(a)

    def grad_spmv(xv, gv):
        return jax.grad(lambda v: jnp.vdot(gv, sp.multiply(ao, v)))(xv)
    at = a_sp.T.tocsr()
    yield Phase("grad_spmv", f"uniform m={m} deg={deg} d/dx <g, A x>",
                nnz, "sell", grad_spmv,
                (jnp.asarray(_vec(m, 19)), jnp.asarray(g)),
                check_product(at, g, eps), 2 * _csr_bytes(nnz, m, m))

    info = sp.multiply_compute(a, a)
    cap = info.result_capacity
    nnz_c = info.result_nnz
    gc_ = _vec(cap, 20) * (np.arange(cap) < nnz_c)
    c0 = sp.multiply_fill(info, a, a)
    c_sp = to_scipy(dc.replace(c0, values=jnp.asarray(gc_)))
    # d/dA_ik sum_ij G_ij (AB)_ij = (G B^T)_ik, read at A's entries
    gbt, sgbt = c_sp @ a_sp.T, abs(c_sp) @ abs(a_sp.T)
    # read at the container's live entries, in its order
    rows = host_row_ids(a.rowptr, nnz, m)
    cols = np.asarray(a.colind)[:nnz]
    ref, _ = lookup(gbt, rows, cols)
    scale, _ = lookup(sgbt, rows, cols)

    def grad_spgemm(av, gv):
        def f(v):
            c = sp.multiply_fill(info, dc.replace(a, values=v), a)
            return jnp.vdot(gv, c.values)
        return jax.grad(f)(av)

    def check(gr):
        return err_ratio(np.asarray(gr)[:nnz], ref, np.abs(scale), eps)
    yield Phase("grad_spgemm_numeric",
                f"C=A*A m={m} nnz={nnz} d/dA <G, A A>", nnz, "esc",
                grad_spgemm, (a.values, jnp.asarray(gc_)), check,
                2 * (2 * nnz + nnz_c) * 8)


SINGLE_CARD = (phases_banded, phases_stencil, phases_uniform, phases_rmat,
               phases_data, phases_spmm_uniform, phases_spgemm,
               phases_sptrsv, phases_add_transpose,
               lambda: phases_bsr((16, 16), mb=16_384, nb=16_384,
                                  per_row=4),
               lambda: phases_bsr((8, 128), mb=4_096, nb=1_024,
                                  per_row=4),
               phases_grad)


# ------------------------------------------------------------------ #
# four-card phases: each distributed op against the same op on one
# device and against scipy
# ------------------------------------------------------------------ #

def _dist_check(ref_sp, x, single, eps, rows):
    """Checker of a padded row-sharded result against scipy and the
    single-device result."""
    base = check_product(ref_sp, x, eps)
    single = np.asarray(single)
    x64 = np.asarray(x).astype(np.float64)
    scale = abs(ref_sp) @ np.abs(x64)

    def check(y):
        y = np.asarray(y)[:rows]
        return max(base(y), err_ratio(y, single.astype(np.float64),
                                      2 * scale, eps))
    return check


def phases_four(p=4, band_m=4 * 409_600, half=50, m=1_000_000, deg=10,
                spmm_m=100_000, k=64, gemm_m=100_000,
                gemm_nnz=1_000_000, trsv_m=1_000_000) -> Iterator[Phase]:
    import jax
    import jax.numpy as jnp
    import spblas_tpu as sp
    from spblas_tpu import parallel as par
    from spblas_tpu.utils.generate import (generate_banded_csr,
                                           generate_block_chain_lower,
                                           generate_csr)

    mesh = par.make_row_mesh(p)
    eps = eps_of(np.float32)

    # dist_spmv ring / all-gather, and the csr chooser kind
    a = generate_csr(m, m, m * deg, seed=21)
    a_sp = to_scipy(a)
    nnz = int(a.nnz)
    x = _vec(m, 22)
    single = sp.multiply(a, jnp.asarray(x))
    t0 = time.perf_counter()
    d = par.partition_csr(a, mesh)
    inspect_s = time.perf_counter() - t0
    xd = par.partition_vector(jnp.asarray(x), d, mesh)
    chk = _dist_check(a_sp, x, single, eps, m)
    for strategy in ("ring", "allgather"):
        yield Phase(f"dist_spmv_{strategy}", f"uniform m={m} deg={deg}",
                    nnz, "csr",
                    lambda xv, s=strategy: par.dist_spmv(d, xv, mesh, s),
                    (xd,), chk, _csr_bytes(nnz, m, m), inspect_s)
    kp = par.partition_spmv(a, mesh, prefer="csr")
    xk = par.partition_spmv_vector(kp, jnp.asarray(x), mesh)
    yield Phase("dist_plan_spmv_csr", f"uniform m={m} deg={deg}", nnz,
                kp[0], lambda xv: par.dist_plan_spmv(kp, xv, mesh), (xk,),
                chk, _csr_bytes(nnz, m, m))

    # dist_add on the row-block partition
    b = generate_csr(m, m, m * deg, seed=23)
    b_sp = to_scipy(b)
    ar, br = par.partition_rowblock(a, mesh), par.partition_rowblock(b, mesh)
    single_add = to_scipy(sp.add(a, b))
    t0 = time.perf_counter()
    aplan = par.dist_add_compute(ar, br, mesh)
    inspect_s = time.perf_counter() - t0

    def check_add(c):
        got = to_scipy(par.assemble_csr(c))
        scale = abs(a_sp) + abs(b_sp)
        return max(sparse_err_ratio(got, a_sp + b_sp, scale, eps),
                   sparse_err_ratio(got, single_add, 2 * scale, eps))
    yield Phase("dist_add", f"uniform m={m} deg={deg} A+B", 2 * nnz,
                "rowblock",
                lambda av, bv: par.dist_add_numeric(aplan, av, bv, mesh),
                (ar, br), check_add, 3 * nnz * 8 * 2, inspect_s)
    del a, b, d, xd, ar, br, aplan

    # banded halo pipeline: dist_band_spmv/spmm and the band chooser kind
    ab = generate_banded_csr(band_m, band_m, 2 * half + 1, seed=24)
    ab_sp = to_scipy(ab)
    nnz_b = int(ab.nnz)
    xb_h = _vec(band_m, 25)
    abo = sp.matrix_opt(ab)
    single_b = sp.multiply(abo, jnp.asarray(xb_h))
    t0 = time.perf_counter()
    kb = par.partition_spmv(ab, mesh, prefer="band")
    inspect_s = time.perf_counter() - t0
    bplan = kb[1]
    xb = par.partition_band_vector(jnp.asarray(xb_h), bplan, mesh)
    chk_b = _dist_check(ab_sp, xb_h, single_b, eps, band_m)
    detail = f"banded m={band_m} half_bw={half}"
    band_bytes = bplan.panels.size * 4 + 2 * band_m * 4
    yield Phase("dist_band_spmv", detail, nnz_b, "band",
                lambda xv: par.dist_band_spmv(bplan, xv, mesh), (xb,),
                chk_b, band_bytes, inspect_s)
    yield Phase("dist_plan_spmv_band", detail, nnz_b, kb[0],
                lambda xv: par.dist_plan_spmv(kb, xv, mesh), (xb,), chk_b,
                band_bytes)
    bm_h = _vec(band_m * k, 26).reshape(band_m, k)
    single_bm = sp.multiply(abo, jnp.asarray(bm_h))
    bm = par.partition_band_vector(jnp.asarray(bm_h), bplan, mesh)
    chk_bm = _dist_check(ab_sp, bm_h, single_bm, eps, band_m)
    yield Phase("dist_band_spmm", f"{detail} k={k}", nnz_b, "band",
                lambda bv: par.dist_band_spmm(bplan, bv, mesh), (bm,),
                chk_bm, bplan.panels.size * 4 + 2 * band_m * k * 4)
    del ab, ab_sp, abo, kb, bplan, xb, bm

    # dist_sell_spmm
    s = generate_csr(spmm_m, spmm_m, spmm_m * deg, seed=27)
    s_sp = to_scipy(s)
    bs_h = _vec(spmm_m * k, 28).reshape(spmm_m, k)
    single_s = sp.multiply(sp.matrix_opt(s), jnp.asarray(bs_h))
    t0 = time.perf_counter()
    splan = par.partition_sell(s, mesh)
    inspect_s = time.perf_counter() - t0
    bs = jax.device_put(
        jnp.pad(jnp.asarray(bs_h), ((0, splan.p * splan.nloc - spmm_m),
                                    (0, 0))),
        par.row_sharding(mesh, 2))
    yield Phase("dist_sell_spmm", f"uniform m={spmm_m} deg={deg} k={k}",
                int(s.nnz), "sell",
                lambda bv: par.dist_sell_spmm(splan, bv, mesh), (bs,),
                _dist_check(s_sp, bs_h, single_s, eps, spmm_m),
                _csr_bytes(int(s.nnz), spmm_m, spmm_m, k), inspect_s)

    # dist_spgemm_compute / numeric
    g = generate_csr(gemm_m, gemm_m, gemm_nnz, seed=29)
    g_sp = to_scipy(g)
    gr = par.partition_rowblock(g, mesh)
    t0 = time.perf_counter()
    gplan = par.dist_spgemm_compute(gr, gr, mesh)
    inspect_s = time.perf_counter() - t0
    single_g = to_scipy(sp.multiply(g, g))
    ref_g, scale_g = g_sp @ g_sp, abs(g_sp) @ abs(g_sp)

    def check_g(c):
        got = to_scipy(par.assemble_csr(c))
        return max(sparse_err_ratio(got, ref_g, scale_g, eps),
                   sparse_err_ratio(got, single_g, 2 * scale_g, eps))
    yield Phase("dist_spgemm", f"C=A*A uniform m={gemm_m} nnz={gemm_nnz}",
                gemm_nnz, "esc",
                lambda av: par.dist_spgemm_numeric(gplan, av, av, mesh),
                (gr,), check_g, (2 * gemm_nnz + gplan.result_nnz) * 8,
                inspect_s)
    del g, gr, gplan

    # dist_triangular_solve
    low = generate_block_chain_lower(trsv_m, block=64, deg=4, seed=30)
    l_sp = to_scipy(low)
    bt = _vec(trsv_m, 31)
    t0 = time.perf_counter()
    tplan = par.dist_triangular_solve_inspect(low, mesh, uplo="lower")
    inspect_s = time.perf_counter() - t0
    single_t = np.asarray(sp.triangular_solve(low, jnp.asarray(bt),
                                              uplo="lower"))
    btd = jax.device_put(jnp.pad(jnp.asarray(bt),
                                 (0, tplan.p * tplan.mloc - trsv_m)),
                         par.row_sharding(mesh))
    res = _check_residual(l_sp, bt, eps)

    def check_t(xv):
        xv = np.asarray(xv)[:trsv_m]
        diff = np.abs(xv - single_t).max()
        lim = 2 * TOL_FACTOR * eps * np.abs(single_t).max()
        return res(xv) if diff <= lim else float("inf")
    yield Phase("dist_triangular_solve",
                f"block chain m={trsv_m} block=64 deg=4", int(low.nnz),
                "block_substitution",
                lambda bv: par.dist_triangular_solve(tplan, bv, mesh),
                (btd,), check_t, _csr_bytes(int(low.nnz), trsv_m, trsv_m),
                inspect_s)


# ------------------------------------------------------------------ #
# runner
# ------------------------------------------------------------------ #

def forbidden_primitives(jaxpr) -> set:
    """Names of pallas_call / host-callback primitives anywhere in
    ``jaxpr`` (sub-jaxprs included)."""
    import jax
    found = set()
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in FORBIDDEN or "callback" in name:
            found.add(name)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found |= forbidden_primitives(sub)
    return found


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    return {f: getattr(ma, f) for f in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, f)}


def run_phase(ph: Phase, reps: int = 5, copy_bytes_s: float | None = None,
              hbm_bytes_s: float | None = None) -> dict:
    """Trace, compile, run, check and time one phase; returns its record
    (``ok`` is False when the error or the jaxpr check fails)."""
    import jax
    import jax.extend.core as jcore

    def body():
        closed, out_shape = jax.make_jaxpr(
            ph.step, return_shape=True)(*ph.args)
        bad = sorted(forbidden_primitives(closed.jaxpr))
        tree = jax.tree_util.tree_structure(out_shape)
        flat = jax.tree_util.tree_leaves(ph.args)

        @jax.jit
        def program(consts, *args):
            return jcore.jaxpr_as_fun(
                jcore.ClosedJaxpr(closed.jaxpr, consts))(*args)

        t0 = time.perf_counter()
        compiled = program.lower(closed.consts, *flat).compile()
        out = jax.block_until_ready(compiled(closed.consts, *flat))
        first = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(closed.consts, *flat))
            times.append(time.perf_counter() - t0)
        out = jax.tree_util.tree_unflatten(tree, out)
        return bad, compiled, out, first, statistics.median(times)

    if ph.x64:
        with jax.enable_x64(True):
            bad, compiled, out, first, steady = body()
    else:
        bad, compiled, out, first, steady = body()
    ratio = ph.check(out)
    stats = jax.devices()[0].memory_stats() or {}
    rate = ph.bytes / steady if steady > 0 else None
    rec = {
        "phase": ph.name, "detail": ph.detail, "nnz": ph.nnz,
        "plan": ph.plan,
        "max_err_over_tol": ratio,
        "tol": f"{TOL_FACTOR}*eps*(|A||x|)_i",
        "inspect_s": ph.inspect_s,
        "first_call_s_compile_plus_run": first,
        "steady_s": steady,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "jaxpr_forbidden": bad,
        "bytes": ph.bytes,
        "bytes_per_s": rate,
        "vs_hbm_peak": rate / hbm_bytes_s if rate and hbm_bytes_s else None,
        "vs_copy": rate / copy_bytes_s if rate and copy_bytes_s else None,
        "memory_analysis": _memory(compiled),
    }
    rec["ok"] = bool(ratio <= 1.0 and not bad)
    return rec


def measure_copy(nbytes: int = 1 << 30, reps: int = 10) -> float:
    """Bytes/s of a large device copy (read + write of ``nbytes``)."""
    import jax
    import jax.numpy as jnp
    x = jnp.ones((nbytes // 4,), jnp.float32)
    f = jax.jit(lambda v: v + 1.0)
    jax.block_until_ready(f(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        times.append(time.perf_counter() - t0)
    del x
    return 2 * nbytes / statistics.median(times)


def card_line() -> str:
    """Name and power limit of the card, read by a child that never
    imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed phases on four GPUs")
    args = ap.parse_args(argv)

    import jax
    from spblas_tpu.utils.compile_cache import enable_compile_cache
    from spblas_tpu.utils.profiling import device_peaks

    enable_compile_cache(ROOT)
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    count = 4 if args.four_cards else 1
    if len(devices) < count:
        print(f"chip_smoke: needs {count} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    print(json.dumps({"device_kind": dev.device_kind,
                      "jax": jax.__version__}), flush=True)
    hbm = device_peaks(dev).hbm_bytes_s
    copy_rate = measure_copy()
    print(json.dumps({"copy_bytes_per_s": copy_rate,
                      "hbm_peak_bytes_per_s": hbm,
                      "copy_vs_hbm_peak": copy_rate / hbm}), flush=True)

    builders = (phases_four,) if args.four_cards else SINGLE_CARD
    failed = []
    for build in builders:
        for ph in build():
            rec = run_phase(ph, copy_bytes_s=copy_rate, hbm_bytes_s=hbm)
            print(json.dumps(rec), flush=True)
            if not rec["ok"]:
                failed.append(rec["phase"])
            del ph
            gc.collect()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
