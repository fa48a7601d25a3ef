"""Mesh-family matrices: stencils and FEM graphs through the chooser.

SuiteSparse-class structure (BASELINE.md row 1): discretized PDE
operators are a few dense diagonals spread wide — band fill ~0.002 but
DIA fill 0.8-1.0.  The `matrix_opt` chooser lands them on the DIA rung
(kernels/dia.py), which streams every diagonal once per SpMV with no
index traffic.  Mirrors the reference inspector-executor usage
(matrix_opt_impl.hpp:14-97); asserts a dense oracle like every example.
"""

import numpy as np

import jax.numpy as jnp

import spblas_tpu as sp
from spblas_tpu.kernels import plans as _plans
from spblas_tpu.kernels.dia import build_dia_plan, dia_spmv
from spblas_tpu.utils.generate import (generate_fem_graph_csr,
                                       generate_stencil_csr,
                                       generate_vector)

# --- 2D 5-point Poisson stencil ------------------------------------ #
a = generate_stencil_csr((40, 50))          # 2000x2000, 5 diagonals
m = a.shape[0]
x = np.asarray(generate_vector(m, seed=1))
dense = np.asarray(a.todense())

plan = build_dia_plan(a)                    # what the chooser picks
from spblas_tpu.kernels.dia import dia_fill_fraction
print(f"2D stencil: {len(plan.offsets)} diagonals, "
      f"DIA fill {dia_fill_fraction(a):.2f}")
y = np.asarray(dia_spmv(plan, jnp.asarray(x)))
np.testing.assert_allclose(y, dense @ x, rtol=1e-4, atol=1e-4)

# through the public inspector-executor surface
aopt = sp.matrix_opt(a)
y2 = np.asarray(sp.multiply(aopt, jnp.asarray(x)))
np.testing.assert_allclose(y2, dense @ x, rtol=1e-4, atol=1e-4)

# --- 3D 7-point stencil --------------------------------------------- #
a3 = generate_stencil_csr((12, 13, 14))
x3 = np.asarray(generate_vector(a3.shape[0], seed=2))
p3 = build_dia_plan(a3)
y3 = np.asarray(dia_spmv(p3, jnp.asarray(x3)))
np.testing.assert_allclose(y3, np.asarray(a3.todense()) @ x3,
                           rtol=1e-4, atol=1e-4)
print(f"3D stencil: {len(p3.offsets)} diagonals ok")

# --- FEM-style triangulated graph ----------------------------------- #
af = generate_fem_graph_csr(30, 35, seed=3)
xf = np.asarray(generate_vector(af.shape[0], seed=4))
pf = build_dia_plan(af)
yf = np.asarray(dia_spmv(pf, jnp.asarray(xf)))
np.testing.assert_allclose(yf, np.asarray(af.todense()) @ xf,
                           rtol=1e-4, atol=1e-4)
print(f"FEM graph: {len(pf.offsets)} offset diagonals ok")

# SpMM over the same plan (k right-hand sides in one pass)
from spblas_tpu.kernels.dia import dia_spmm
B = np.asarray(
    generate_vector(af.shape[0] * 8, seed=5)).reshape(af.shape[0], 8)
C = np.asarray(dia_spmm(pf, jnp.asarray(B)))
np.testing.assert_allclose(C, np.asarray(af.todense()) @ B,
                           rtol=1e-4, atol=1e-4)
print("mesh_matrices example ok")
