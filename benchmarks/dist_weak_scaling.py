"""Weak-scaling harness for the distributed SpMV paths.

BASELINE.json's north star asks for >=70% weak-scaling efficiency.
This script scales the problem with the mesh (rows_per_device held
constant), measures per-iteration time on 1..P devices, and reports
efficiency = t(1) / t(P).  On a faked CPU mesh the absolute numbers say
nothing about a device (all fake devices share the host's cores); the
machinery (partition, halo ppermute pipeline, timing) is what a run on
several GPUs uses.

Usage:
  python benchmarks/dist_weak_scaling.py [band|csr|spgemm]   # GPUs
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python benchmarks/dist_weak_scaling.py   # rehearsal

``band`` (default) scales the halo band pipeline; ``csr`` scales the
unstructured generic gather blocks through the chooser surface
(partition_spmv / dist_plan_spmv); ``spgemm`` scales the distributed
SpGEMM numeric re-run.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from spblas_tpu.parallel import (dist_band_spmv, make_row_mesh,
                                 partition_band, partition_band_vector)
from spblas_tpu.utils.generate import generate_banded_csr

ROWS_PER_DEVICE = 8192
BANDWIDTH = 65
ITERS = 20


def measure(p: int) -> float:
    mesh = make_row_mesh(p, devices=jax.devices()[:p])
    m = ROWS_PER_DEVICE * p
    a = generate_banded_csr(m, m, BANDWIDTH, seed=0)
    plan = partition_band(a, mesh)
    x = partition_band_vector(jnp.ones((m,), jnp.float32), plan, mesh)

    @jax.jit
    def chain(panels_plan, v):
        def body(_, u):
            return dist_band_spmv(panels_plan, u, mesh) / BANDWIDTH
        return jax.lax.fori_loop(0, ITERS, body, v)

    jax.block_until_ready(chain(plan, x))
    best = float("inf")
    for r in range(3):
        xr = x + jnp.float32(1e-3 * (r + 1))
        jax.block_until_ready(xr)
        t0 = time.perf_counter()
        out = chain(plan, xr)
        jax.block_until_ready(out)
        float(np.asarray(out)[0])
        best = min(best, time.perf_counter() - t0)
    return best / ITERS


DEG = 10


def measure_csr(p: int) -> float:
    """Unstructured weak scaling through the chooser surface
    (partition_spmv's default generic gather blocks)."""
    from spblas_tpu.parallel import (dist_plan_spmv, partition_spmv,
                                     partition_spmv_vector)
    from spblas_tpu.utils.generate import generate_csr

    mesh = make_row_mesh(p, devices=jax.devices()[:p])
    m = ROWS_PER_DEVICE * p
    a = generate_csr(m, m, DEG * m, seed=0)
    kind, plan = partition_spmv(a, mesh)
    x = partition_spmv_vector((kind, plan),
                              jnp.ones((m,), jnp.float32), mesh)

    @jax.jit
    def chain(plan, v):
        def body(_, u):
            y = dist_plan_spmv((kind, plan), u, mesh)
            return y / jnp.float32(DEG)
        return jax.lax.fori_loop(0, ITERS, body, v)

    jax.block_until_ready(chain(plan, x))
    best = float("inf")
    for r in range(3):
        xr = x + jnp.float32(1e-3 * (r + 1))
        jax.block_until_ready(xr)
        t0 = time.perf_counter()
        out = chain(plan, xr)
        jax.block_until_ready(out)
        float(np.asarray(out)[0])
        best = min(best, time.perf_counter() - t0)
    return best / ITERS


def measure_spgemm(p: int) -> float:
    """Distributed SpGEMM numeric weak scaling: work per device held
    constant (C = A·A, rows scale with the mesh), numeric re-run
    timed."""
    import dataclasses
    from spblas_tpu.parallel import (dist_spgemm_compute,
                                     dist_spgemm_numeric,
                                     partition_rowblock)
    from spblas_tpu.utils.generate import generate_csr

    mesh = make_row_mesh(p, devices=jax.devices()[:p])
    m = (ROWS_PER_DEVICE // 8) * p
    a = generate_csr(m, m, DEG * m, seed=0)
    ar = partition_rowblock(a, mesh)
    plan = dist_spgemm_compute(ar, ar, mesh)

    def run(values):
        c = dist_spgemm_numeric(
            plan, dataclasses.replace(ar, values=values), ar, mesh)
        return c.values

    jax.block_until_ready(run(ar.values))
    best = float("inf")
    for r in range(3):
        av = ar.values * (1 + 1e-3 * (r + 1))
        jax.block_until_ready(av)
        t0 = time.perf_counter()
        out = run(av)
        jax.block_until_ready(out)
        float(np.asarray(out).ravel()[0])
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import sys
    mode = sys.argv[1] if len(sys.argv) > 1 else "band"
    fn = {"band": measure, "csr": measure_csr,
          "spgemm": measure_spgemm}[mode]
    pmax = jax.device_count()
    t1 = fn(1)
    print(f"[{mode}] p=1: {t1*1e3:.2f} ms/iter "
          f"(rows/device={ROWS_PER_DEVICE})")
    for p in (2, 4, pmax):
        if p <= 1 or p > pmax:
            continue
        tp = fn(p)
        eff = t1 / tp
        print(f"[{mode}] p={p}: {tp*1e3:.2f} ms/iter, weak-scaling "
              f"efficiency {eff:.2f}")


if __name__ == "__main__":
    main()
