"""Distributed SpMV over a device mesh — no reference counterpart
(the reference is single-device; SURVEY.md §2.6).

Run on several GPUs, or fake a mesh on CPU:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python examples/distributed_spmv.py
"""

import jax
import numpy as np

from spblas_tpu.parallel import (
    dist_plan_spmm, dist_plan_spmv, dist_spmv, gather_result,
    make_row_mesh, partition_csr, partition_spmm,
    partition_spmm_operand, partition_spmv, partition_spmv_vector,
    partition_vector,
)
from spblas_tpu.utils.generate import generate_csr, generate_vector

mesh = make_row_mesh()
print("mesh:", mesh)

m = n = 1024
a = generate_csr(m, n, 16 * m, seed=0)
x = generate_vector(n, seed=1)
expected = np.asarray(a.todense()) @ np.asarray(x)

# --- recommended entry: the distributed chooser -------------------- #
# generic gather blocks by default; ``prefer="band"`` takes the halo
# band pipeline for narrow-band matrices
kp = partition_spmv(a, mesh)
assert kp[0] == "csr", kp[0]
xv = partition_spmv_vector(kp, x, mesh)
y = np.asarray(dist_plan_spmv(kp, xv, mesh))[:m]
assert np.allclose(y, expected, rtol=1e-3, atol=1e-3)
print(f"chooser default -> kind={kp[0]} ok")

# dense-operand (SpMM) chooser: same selection surface
B = np.random.default_rng(2).standard_normal((n, 8)).astype(np.float32)
kp = partition_spmm(a, mesh, prefer="sell")
Bp = partition_spmm_operand(kp, B, mesh)
C = np.asarray(dist_plan_spmm(kp, Bp, mesh))[:m]
assert np.allclose(C, np.asarray(a.todense()) @ B, rtol=1e-3, atol=1e-3)
print("spmm chooser kind=sell ok")

# --- raw gather-block kernels, both strategies --------------------- #
d = partition_csr(a, mesh)             # inspect: row blocks + ring layout
xd = partition_vector(x, d, mesh)

y_ring = gather_result(dist_spmv(d, xd, mesh, strategy="ring"), d)
y_ag = gather_result(dist_spmv(d, xd, mesh, strategy="allgather"), d)

assert np.allclose(np.asarray(y_ring), expected, rtol=1e-3, atol=1e-3)
assert np.allclose(np.asarray(y_ag), expected, rtol=1e-3, atol=1e-3)
print("ok")
