"""Benchmark harness — the perf baseline the reference never published.

The reference ships no numbers (BASELINE.md); targets come from
BASELINE.json's roofline model: CSR f32/i32 SpMV moves ~12 B of matrix
traffic per nonzero, so roofline nnz/s = HBM_BW / 12.  The headline
metric mirrors configs[0] (banded SpMV, examples/simple_spmv.cpp shape
template) through the plan the chooser picks for banded matrices, DIA
(kernels/dia.py).

Every section runs in its own subprocess under a hard timeout, so the
parent never touches JAX and exactly one process uses the GPU at a time;
the parent always prints its one JSON line:

  {"metric": ..., "value": N, "unit": "nnz/s", "vs_baseline": N, ...}

A run that finds no GPU fails.  ``python bench.py --full`` adds the wider
sweep.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HEADLINE_METRIC = "spmv_banded_400k_nnz_s"
ROOT = os.path.dirname(os.path.abspath(__file__))


# ------------------------------------------------------------------ #
# timing helpers (imported lazily inside sections)
# ------------------------------------------------------------------ #

def _time_chained(step, params, x0, iters: int, reps: int = 3) -> float:
    """Best wall time per `step(params, x)` application over a jitted
    chain.  `params` rides as a traced argument (a closure constant would
    be embedded in the compiled program); each repetition perturbs the
    input so no two timed calls are identical."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(params, x):
        return jax.lax.fori_loop(0, iters, lambda _, v: step(params, v), x)

    jax.block_until_ready(chain(params, x0))
    best = float("inf")
    for r in range(reps):
        xr = x0 + jnp.asarray(1e-3 * (r + 1), x0.dtype)
        jax.block_until_ready(xr)
        t0 = time.perf_counter()
        out = chain(params, xr)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best / iters


def _numeric_chain(numeric, plan, av, bv, iters: int) -> float:
    """Best wall time per numeric re-run with values perturbed every
    iteration; the readback sums every output so nothing is dead code."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(plan, av, bv):
        def body(_, carry):
            s, av2 = carry
            out = numeric(plan, av2, bv)
            return (s + out.sum(), av2 * jnp.float32(1.0000001))
        return jax.lax.fori_loop(0, iters, body, (jnp.float32(0), av))

    jax.block_until_ready(chain(plan, av, bv))
    best = float("inf")
    for r in range(3):
        a_r = av * (1 + 1e-4 * (r + 1))
        jax.block_until_ready(a_r)
        t0 = time.perf_counter()
        jax.block_until_ready(chain(plan, a_r, bv))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def _device_dia(m, half_bw, dtype=None):
    """Synthetic banded operator as a DIA plan assembled on device:
    random diagonals, zero outside the matrix."""
    import jax
    import jax.numpy as jnp
    from spblas_tpu.kernels.dia import DiaPlan

    offsets = tuple(range(-half_bw, half_bw + 1))
    ndiag = len(offsets)

    @jax.jit
    def make(key):
        d = jax.random.uniform(key, (ndiag, m), jnp.float32, 0.1, 1.0)
        d = d / jnp.float32(0.55 * ndiag)
        i = jnp.arange(m)[None, :]
        offs = jnp.asarray(offsets)[:, None]
        d = jnp.where((i + offs >= 0) & (i + offs < m), d, 0)
        return d.astype(dtype or jnp.float32)

    diags = make(jax.random.PRNGKey(0))
    jax.block_until_ready(diags)
    nnz = sum(m - abs(o) for o in offsets)
    return DiaPlan(diags=diags, offsets=offsets, shape=(m, m)), nnz


def _csr_roofline_nnz_s():
    from spblas_tpu.utils.profiling import device_peaks
    return device_peaks().hbm_bytes_s / 12.0


# ------------------------------------------------------------------ #
# sections — each runs in a subprocess and prints one JSON object
# ------------------------------------------------------------------ #

def section_device_info():
    import jax
    from spblas_tpu.utils.profiling import device_peaks
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    pk = device_peaks(dev)
    return {"platform": dev.platform, "device": dev.device_kind,
            "count": len(jax.devices()),
            "hbm_bytes_s": pk.hbm_bytes_s, "peak_source": pk.source,
            "csr_roofline_nnz_s": pk.hbm_bytes_s / 12.0}


def section_headline(m=409_600, half_bw=50, iters=1000):
    """Banded SpMV through the DIA plan the chooser picks for it."""
    import jax.numpy as jnp
    from spblas_tpu.kernels.dia import dia_spmv
    plan, nnz = _device_dia(m, half_bw)
    sec = _time_chained(dia_spmv, plan, jnp.ones((m,), jnp.float32),
                        iters=iters)
    return {"nnz_s": nnz / sec, "nnz": nnz, "path": "dia"}


def section_spmv_general_sell(m=300_000, deg=10, iters=500):
    """Unstructured uniform-random SpMV through the chooser's plan
    (SELL degree buckets)."""
    import jax, jax.numpy as jnp
    from spblas_tpu.kernels import plans as _plans
    from spblas_tpu.utils.generate import generate_csr

    nnz = m * deg
    a = generate_csr(m, m, nnz, seed=3)
    kind, plan = _plans.build_matvec_plan(a)

    def step(plan, x):
        y = _plans.plan_spmv((kind, plan), x)
        return y * jax.lax.rsqrt(jnp.sum(y * y) / m + 1e-9)

    sec = _time_chained(step, plan,
                        jnp.ones((m,), jnp.float32), iters=iters,
                        reps=5)
    return {"nnz_s": int(a.nnz) / sec, "nnz": int(a.nnz), "path": kind}


def section_spmv_general_xla(m=20_000, deg=10, iters=10):
    """Unstructured SpMV on the global-width ELL layout (forced past the
    chooser), kept for comparison with SELL."""
    import jax.numpy as jnp
    from spblas_tpu.kernels.ell import build_ell_plan, ell_spmv
    from spblas_tpu.utils.generate import generate_csr

    a = generate_csr(m, m, m * deg, seed=0)
    kind, plan = "ell", build_ell_plan(a)
    scale = jnp.float32(deg)

    def step(plan, x):
        return ell_spmv(plan, x) / scale

    sec = _time_chained(step, plan, jnp.ones((m,), jnp.float32),
                        iters=iters)
    return {"nnz_s": int(a.nnz) / sec, "plan": kind}


def section_spgemm(m=2_000, nnz=40_000, iters=50):
    """Two-phase SpGEMM: the symbolic phase, and the numeric re-run with
    perturbed values (the reuse hot path)."""
    import jax
    from spblas_tpu.ops.spgemm import _numeric, spgemm_compute
    from spblas_tpu.utils.generate import generate_csr
    import jax.numpy as jnp

    a = generate_csr(m, m, nnz, seed=0)
    jax.block_until_ready(a.values)           # operand resident pre-timer
    spgemm_compute(a, a)                      # warm the symbolic compile
    t0 = time.perf_counter()
    info = spgemm_compute(a, a)
    t_sym = time.perf_counter() - t0
    one = jnp.ones((), jnp.float32)
    best = _numeric_chain(
        lambda plan, av, bv: _numeric(plan, av, bv, None, one, one),
        info.plan, a.values, a.values, iters)
    return {"symbolic_s": t_sym, "numeric_reuse_s": best,
            "result_nnz": info.result_nnz}


def section_spgemm_large(m=100_000, nnz=1_000_000, iters=20):
    """SpGEMM at scale: C = A·A at m=100k / nnz=1M (expansion ~10M,
    output ~10M)."""
    return section_spgemm(m=m, nnz=nnz, iters=iters)


def section_dist_spgemm(m=100_000, nnz=1_000_000, iters=20):
    """Distributed SpGEMM numeric at the spgemm_large shape on a mesh of
    the devices present."""
    import dataclasses as _dc

    import jax
    from spblas_tpu.formats.csr import CSR
    from spblas_tpu.parallel import (dist_spgemm_compute,
                                     dist_spgemm_numeric, make_row_mesh,
                                     partition_rowblock)
    from spblas_tpu.utils.generate import generate_csr_arrays

    mesh = make_row_mesh()
    vals, rowptr, colind = generate_csr_arrays(m, m, nnz, seed=0)
    a = CSR.from_arrays(vals, rowptr, colind, (m, m), nnz=nnz)
    ar = partition_rowblock(a, mesh)
    jax.block_until_ready(ar.values)

    t0 = time.perf_counter()
    plan = dist_spgemm_compute(ar, ar, mesh)
    t_inspect = time.perf_counter() - t0

    def numeric(pl, av, bv):
        return dist_spgemm_numeric(pl, _dc.replace(ar, values=av),
                                   _dc.replace(ar, values=bv),
                                   mesh).values

    best = _numeric_chain(numeric, plan, ar.values, ar.values, iters)
    return {"inspect_s": t_inspect, "numeric_s": best,
            "result_nnz": plan.result_nnz, "p": plan.p}


def _solve_chain(L, info, m, iters):
    import jax
    import jax.numpy as jnp
    from spblas_tpu.ops.triangular_solve import triangular_solve

    b0 = jnp.ones((m,), jnp.float32)

    @jax.jit
    def chain(b):
        def body(_, v):
            x = triangular_solve(L, v, uplo="lower", info=info)
            return x * 1e-3 + b * 0.5
        return jax.lax.fori_loop(0, iters, body, b)

    jax.block_until_ready(chain(b0))
    best = float("inf")
    for r in range(3):
        br = b0 + jnp.float32(r * 1e-3)
        jax.block_until_ready(br)
        t0 = time.perf_counter()
        jax.block_until_ready(chain(br))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def section_sptrsv(m=20_000, iters=200):
    import jax
    from spblas_tpu.ops.triangular_solve import triangular_solve_inspect
    from spblas_tpu.utils.generate import generate_triangular_csr
    from spblas_tpu.utils.profiling import inspect_phases

    L = generate_triangular_csr(m, seed=0, lower=True, density=0.0005)
    jax.block_until_ready(L.values)
    t0 = time.perf_counter()
    info = triangular_solve_inspect(L, uplo="lower")
    t_inspect = time.perf_counter() - t0
    phases_cold = inspect_phases("trsv_inspect")
    t0 = time.perf_counter()
    info = triangular_solve_inspect(L, uplo="lower")
    t_inspect_warm = time.perf_counter() - t0
    best = _solve_chain(L, info, m, iters)
    return {"inspect_s": t_inspect, "inspect_warm_s": t_inspect_warm,
            "inspect_phases": phases_cold,
            "inspect_phases_warm": inspect_phases("trsv_inspect"),
            "solve_s": best, "levels": info.plan.num_levels,
            "rows_per_s": m / best, "path": "level_sweep"}


def section_sptrsv_deep(m=1_000_000, block=64, deg=4, iters=50):
    """High-level-count solve: m=1M block-chain lower with m/block =
    15,625 dependency levels through the ragged level sweep."""
    import jax
    from spblas_tpu.ops.triangular_solve import triangular_solve_inspect
    from spblas_tpu.utils.generate import generate_block_chain_lower

    L = generate_block_chain_lower(m, block=block, deg=deg, seed=0)
    jax.block_until_ready(L.values)
    t0 = time.perf_counter()
    info = triangular_solve_inspect(L, uplo="lower")
    t_inspect = time.perf_counter() - t0
    levels = info.plan.num_levels
    best = _solve_chain(L, info, m, iters)
    return {"inspect_s": t_inspect, "solve_s": best, "levels": levels,
            "rows_per_s": m / best,
            "ms_per_1k_levels": best * 1e3 / (levels / 1e3),
            "path": "level_sweep"}


def section_sptrsv_4m(m=4_000_000, block=64, deg=4, iters=10):
    """m=4M block-chain lower with 62,500 levels."""
    return section_sptrsv_deep(m=m, block=block, deg=deg, iters=iters)


def section_headline_bf16(m=409_600, half_bw=50, iters=300):
    """The headline with bf16 diagonal storage (f32 accumulation)."""
    import jax.numpy as jnp
    from spblas_tpu.kernels.dia import dia_spmv
    plan, nnz = _device_dia(m, half_bw, dtype=jnp.bfloat16)

    def step(plan, x):
        return dia_spmv(plan, x).astype(jnp.float32)

    sec = _time_chained(step, plan, jnp.ones((m,), jnp.float32),
                        iters=iters)
    return {"nnz_s": nnz / sec, "path": "dia_bf16"}


def section_spmm_banded(m=409_600, half_bw=50, k=256, iters=20):
    import jax.numpy as jnp
    from spblas_tpu.kernels.dia import dia_spmm
    plan, nnz = _device_dia(m, half_bw)
    sec = _time_chained(dia_spmm, plan, jnp.ones((m, k), jnp.float32),
                        iters=iters)
    return {"flops_s": 2 * nnz * k / sec, "path": "dia"}


def section_spmm_general(m=100_000, deg=10, k=256, iters=60):
    """Unstructured CSR x dense SpMM through the chooser's plan (SELL).
    Reference bar: vendor/onemkl_sycl/detail/spmm_impl.hpp:40-200."""
    import jax, jax.numpy as jnp
    from spblas_tpu.kernels import plans as _plans
    from spblas_tpu.utils.generate import generate_csr

    a = generate_csr(m, m, m * deg, seed=3)
    kind, plan = _plans.build_matvec_plan(a)

    def step(plan, bmat):
        c = _plans.plan_spmm((kind, plan), bmat)
        return c * 1e-3 + 0.5

    b0 = jnp.ones((m, k), jnp.float32)
    sec = _time_chained(step, plan, b0, iters=iters)
    fl = 2 * int(a.nnz) * k
    return {"gflop_s": fl / sec / 1e9, "k": k, "path": kind,
            "nnz": int(a.nnz)}


def section_spmv_general_4m(m=4_000_000, deg=10, iters=60):
    """Unstructured SpMV at m=4M through the chooser's plan."""
    import jax, jax.numpy as jnp
    from spblas_tpu.formats.csr import CSR
    from spblas_tpu.kernels import plans as _plans
    from spblas_tpu.utils.generate import generate_csr_arrays

    nnz = m * deg
    vals, rowptr, cols = generate_csr_arrays(m, m, nnz, seed=3)
    a = CSR.from_arrays(vals, rowptr, cols, (m, m), nnz=nnz)
    t0 = time.perf_counter()
    kind, plan = _plans.build_matvec_plan(a)
    build_s = time.perf_counter() - t0

    def step(plan, x):
        y = _plans.plan_spmv((kind, plan), x)
        return y * jax.lax.rsqrt(jnp.sum(y * y) / m + 1e-9)

    sec = _time_chained(step, plan, jnp.ones((m,), jnp.float32),
                        iters=iters)
    return {"nnz_s": nnz / sec, "nnz": nnz, "inspect_s": build_s,
            "path": kind}


def _spmv_cases(cases, iters):
    """{name: {path, nnz_s, nnz, roofline_frac}} through the chooser."""
    import jax, jax.numpy as jnp
    from spblas_tpu.kernels import plans as _plans

    roofline = _csr_roofline_nnz_s()
    out = {}
    for name, gen in cases.items():
        a = gen()
        m = a.shape[0]
        kind, plan = _plans.build_matvec_plan(a)

        def step(plan, x):
            y = _plans.plan_spmv((kind, plan), x)
            return y * jax.lax.rsqrt(jnp.sum(y * y) / m + 1e-9)

        sec = _time_chained(step, plan, jnp.ones((m,), jnp.float32),
                            iters=iters)
        nnz_s = int(a.nnz) / sec
        out[name] = {"path": kind, "nnz_s": nnz_s, "nnz": int(a.nnz),
                     "roofline_frac": nnz_s / roofline}
    return out


def section_spmv_mesh(iters=300):
    """Mesh-family matrices through the full matvec chooser — the
    SuiteSparse-class PDE/FEM structures the north star names
    (BASELINE.md row 1)."""
    from spblas_tpu.utils.generate import (generate_fem_graph_csr,
                                           generate_stencil_csr)
    return _spmv_cases({
        "stencil2d_1000": lambda: generate_stencil_csr((1000, 1000)),
        "stencil3d_64": lambda: generate_stencil_csr((64, 64, 64)),
        "fem_800": lambda: generate_fem_graph_csr(800, 800, seed=9),
    }, iters)


def section_spmv_real(iters=300):
    """Checked-in real-matrix files through `load_matrix_market` and the
    full matvec chooser (BASELINE.md row 1 names the SuiteSparse set;
    with no network the data/ files are generator exports round-tripped
    through the Matrix Market IO path, plus an RMAT web-graph stand-in),
    with a small banded matrix's per-step time as the overhead floor."""
    from spblas_tpu.utils.generate import generate_banded_csr
    from spblas_tpu.utils.io import load_matrix_market

    names = ("fem2d_128", "stencil3d_32", "rmat_32k", "powerlaw_64k",
             "fem2d_512")
    cases = {"floor_banded_2048": lambda: generate_banded_csr(
        2048, 2048, 5, seed=0)}
    for name in names:
        path = os.path.join(ROOT, "data", name + ".mtx.gz")
        cases[name] = lambda path=path: load_matrix_market(path)
    out = _spmv_cases(cases, iters)
    floor = out["floor_banded_2048"]
    floor_s = floor["nnz"] / floor["nnz_s"]
    out["floor_us_per_step"] = floor_s * 1e6
    for name in names:
        out[name]["vs_floor_bound"] = (
            out[name]["nnz_s"] / (out[name]["nnz"] / floor_s))
    return out


def section_spmv_f64(iters=300):
    """Double-precision SpMV next to f32 on the same structure (the DIA
    plan keeps the operand dtype).  Reference bar: double instantiations
    throughout (include/spblas/views/csr_view.hpp:12-16)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import jax.numpy as jnp
    from spblas_tpu.kernels import plans as _plans
    from spblas_tpu.utils.generate import generate_stencil_csr

    out = {}
    for dtype, tag in ((np.float64, "f64"), (np.float32, "f32")):
        a = generate_stencil_csr((1000, 1000), dtype=dtype)
        m = a.shape[0]
        kind, plan = _plans.build_matvec_plan(a)

        def step(plan, x):
            y = _plans.plan_spmv((kind, plan), x)
            return y * jax.lax.rsqrt(jnp.sum(y * y) / m + 1e-9)

        sec = _time_chained(step, plan, jnp.ones((m,), dtype),
                            iters=iters)
        out[tag] = {"path": kind, "dtype": str(jnp.dtype(dtype)),
                    "nnz_s": int(a.nnz) / sec}
    out["f64_vs_f32"] = out["f64"]["nnz_s"] / out["f32"]["nnz_s"]
    return out


def section_spmv_rmat(m=131_072, deg=16, iters=300):
    """Power-law (RMAT) pattern through the plan chooser — the
    SuiteSparse-class skewed-degree case."""
    from spblas_tpu.utils.generate import generate_rmat_csr
    return _spmv_cases({"rmat": lambda: generate_rmat_csr(
        m, m * deg, seed=5)}, iters)["rmat"]


SECTIONS = {
    "device_info": section_device_info,
    "headline": section_headline,
    "spmv_general_sell": section_spmv_general_sell,
    "spmv_general_sell_1m":
        lambda: section_spmv_general_sell(m=1_000_000, iters=200),
    "spmv_general_xla": section_spmv_general_xla,
    "spgemm": section_spgemm,
    "spgemm_large": section_spgemm_large,
    "sptrsv": section_sptrsv,
    "headline_bf16": section_headline_bf16,
    "spmm_banded": section_spmm_banded,
    "spmv_rmat": section_spmv_rmat,
    "spmm_general": section_spmm_general,
    "spmm_general_k64": lambda: section_spmm_general(k=64),
    "sptrsv_100k": lambda: section_sptrsv(m=100_000),
    "sptrsv_deep": section_sptrsv_deep,
    "sptrsv_4m": section_sptrsv_4m,
    "spmv_general_4m": section_spmv_general_4m,
    "spmv_mesh": section_spmv_mesh,
    "spmv_real": section_spmv_real,
    "spmv_f64": section_spmv_f64,
    "dist_spgemm": section_dist_spgemm,
}


def _run_section(name: str, timeout_s: int):
    """Run one section in a subprocess under a hard timeout."""
    print(f"[bench] {name} (timeout {timeout_s}s)", file=sys.stderr,
          flush=True)
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--section", name],
            capture_output=True, text=True, timeout=timeout_s, cwd=ROOT)
        if out.returncode != 0:
            return None, f"exit {out.returncode}: {out.stderr[-300:]}"
        line = out.stdout.strip().splitlines()[-1]
        return json.loads(line), None
    except subprocess.TimeoutExpired:
        return None, f"timeout after {timeout_s}s"
    except (OSError, ValueError, IndexError) as e:
        return None, repr(e)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--section":
        from spblas_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache(ROOT)
        print(json.dumps(SECTIONS[sys.argv[2]]()))
        return 0

    info, err = _run_section("device_info", 240)
    if info is None:
        print(f"bench: no GPU device ({err})", file=sys.stderr)
        return 1
    details = dict(info)
    head, err = _run_section("headline", 540)
    if head is None:
        print(f"bench: headline failed ({err})", file=sys.stderr)
        return 1
    details["headline_path"] = head.get("path")
    details["banded_nnz"] = head.get("nnz")

    defaults = [
        ("spmv_general_sell", 540),
        ("spmv_general_sell_1m", 900),
        ("spmv_rmat", 540),
        ("spgemm", 480),
        ("sptrsv", 480),
        ("spmm_general", 600),
        ("spmv_mesh", 700),
        ("spmv_real", 700),
        ("spmv_f64", 600),
        ("spgemm_large", 1500),
        ("dist_spgemm", 1500),
    ]
    if "--full" in sys.argv[1:]:
        defaults += [
            ("spmv_general_4m", 1800),
            ("spmm_general_k64", 420),
            ("sptrsv_100k", 600),
            ("sptrsv_deep", 900),
            ("sptrsv_4m", 1800),
            ("spmv_general_xla", 300),
            ("headline_bf16", 420),
            ("spmm_banded", 420),
        ]
    for name, tmo in defaults:
        res, err = _run_section(name, tmo)
        if res is not None:
            details[name] = res
        else:
            details[name + "_error"] = err

    nnz_s = head["nnz_s"]
    print(json.dumps({
        "metric": HEADLINE_METRIC,
        "value": nnz_s,
        "unit": "nnz/s",
        "vs_baseline": nnz_s / info["csr_roofline_nnz_s"],
        "details": details,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
