"""Distributed op tour: banded SpMV/SpMM halo pipeline, SpGEMM with
numeric reuse, SpADD, and block-substitution SpTRSV over a device mesh.

Run on several GPUs, or fake a mesh on CPU:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python examples/distributed_ops.py
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from spblas_tpu.parallel import (
    assemble_csr, dist_add, dist_band_spmv, dist_spgemm,
    dist_triangular_solve, dist_triangular_solve_inspect, make_row_mesh,
    partition_band, partition_band_vector, partition_rowblock,
)
from spblas_tpu.utils.generate import (generate_banded_csr, generate_csr,
                                       generate_triangular_csr)

mesh = make_row_mesh()
p = mesh.devices.size
print("mesh:", mesh)

# --- banded SpMV: h-wide halo exchange + local band panels ----------- #
m = 1024 * p
a = generate_banded_csr(m, m, 33, seed=0)
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
assert np.allclose(y, exp, rtol=1e-3, atol=1e-3)
print("dist banded spmv ok")

# --- SpGEMM + SpADD over row blocks ---------------------------------- #
g1 = generate_csr(96, 96, 800, seed=2)
g2 = generate_csr(96, 96, 700, seed=3)
c = assemble_csr(dist_spgemm(g1, g2, mesh))
expected = np.asarray(g1.todense()) @ np.asarray(g2.todense())
assert np.allclose(np.asarray(c.todense()), expected, rtol=1e-3)
s = assemble_csr(dist_add(g1, g2, mesh))
assert np.allclose(np.asarray(s.todense()),
                   np.asarray(g1.todense()) + np.asarray(g2.todense()),
                   rtol=1e-4)
print("dist spgemm + add ok")

# --- block-substitution SpTRSV --------------------------------------- #
mt = 320
L = generate_triangular_csr(mt, seed=4, lower=True)
tplan = dist_triangular_solve_inspect(L, mesh, uplo="lower")
b = np.random.default_rng(5).standard_normal(mt).astype(np.float32)
bp = jax.device_put(jnp.asarray(np.pad(b, (0, p * tplan.mloc - mt))),
                    NamedSharding(mesh, P("rows")))
xs = np.asarray(dist_triangular_solve(tplan, bp, mesh))[:mt]
assert np.abs(np.asarray(L.todense()) @ xs - b).max() < 1e-4
print("dist sptrsv ok")

# --- distributed SpGEMM numeric reuse -------------------------------- #
# inspect once on host, then re-run the sharded numeric with new values
# of the same sparsity (the reuse contract)
import dataclasses
from spblas_tpu.parallel import dist_spgemm_compute, dist_spgemm_numeric

ar = partition_rowblock(g1, mesh)
br = partition_rowblock(g2, mesh)
plan = dist_spgemm_compute(ar, br, mesh)
ce = assemble_csr(dist_spgemm_numeric(plan, ar, br, mesh))
assert np.allclose(np.asarray(ce.todense()), expected, rtol=1e-3,
                   atol=1e-3)
a2 = dataclasses.replace(ar, values=ar.values * 3.0)
c3 = assemble_csr(dist_spgemm_numeric(plan, a2, br, mesh))
assert np.allclose(np.asarray(c3.todense()), 3.0 * expected,
                   rtol=1e-3, atol=1e-3)
print("dist spgemm numeric reuse ok")
