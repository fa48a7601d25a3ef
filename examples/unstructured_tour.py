"""Unstructured-sparsity tour: the chooser's general-matrix paths.

The reference delegates general CSR kernels to vendor libraries
(include/spblas/vendor/*); here the `matrix_opt` chooser
(kernels/plans.py) picks a plan from the matrix's structure:

  low-skew random      -> SELL degree-bucketed rows       ("sell")
  hub-heavy power-law  -> SELL, wide buckets for the hubs ("sell")
  SpMM (dense B)       -> the same cached plan
  triangular solve     -> ragged level-schedule sweep

Every step asserts a dense oracle.
"""

import numpy as np

import jax.numpy as jnp

import spblas_tpu as sp
from spblas_tpu.kernels import plans as _plans
from spblas_tpu.utils.generate import (generate_csr, generate_rmat_csr,
                                       generate_triangular_csr)

rng = np.random.default_rng(0)

# --- low-skew uniform random --------------------------------------- #
a = generate_csr(3000, 3000, 24_000, seed=1)
kind, plan = _plans.build_matvec_plan(a)
assert kind == "sell", kind
x = rng.standard_normal(3000).astype(np.float32)
y = np.asarray(_plans.plan_spmv((kind, plan), jnp.asarray(x)))
expected = np.asarray(a.todense()) @ x
assert np.allclose(y, expected, rtol=1e-4, atol=1e-3)
print(f"uniform  -> {kind:7s} ok  (max bucket width {plan.width})")

# --- hub-heavy power-law ------------------------------------------- #
r = generate_rmat_csr(4096, 4096 * 16, seed=2)
kind_r, plan_r = _plans.build_matvec_plan(r)
assert kind_r == "sell", kind_r
xr = rng.standard_normal(4096).astype(np.float32)
yr = np.asarray(_plans.plan_spmv((kind_r, plan_r), jnp.asarray(xr)))
expected = np.asarray(r.todense()) @ xr
assert np.allclose(yr, expected, rtol=1e-4, atol=1e-3)
print(f"rmat     -> {kind_r:7s} ok  (max bucket width {plan_r.width})")

# --- SpMM through the cached plan ---------------------------------- #
ao = sp.matrix_opt(r)
b = rng.standard_normal((4096, 16)).astype(np.float32)
c = np.asarray(sp.multiply(ao, jnp.asarray(b)))
expected = np.asarray(r.todense()) @ b
assert np.allclose(c, expected, rtol=1e-4, atol=1e-3)
print(f"spmm     -> {_plans.optimized_plan(ao)[0]:7s} ok")

# --- level-scheduled triangular solve ------------------------------ #
L = generate_triangular_csr(2000, seed=3, lower=True)
info = sp.triangular_solve_inspect(L, uplo="lower")
bl = rng.standard_normal(2000).astype(np.float32)
xl = np.asarray(sp.triangular_solve(L, bl, uplo="lower", info=info))
dense = np.asarray(L.todense())
assert np.allclose(dense @ xl, bl, rtol=1e-3, atol=1e-3)
print(f"sptrsv   -> level sweep over {info.plan.num_levels} levels ok")
print("ok")
