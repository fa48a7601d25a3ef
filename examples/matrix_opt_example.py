"""matrix_opt walk-through — mirrors examples/matrix_opt_example.cpp.

Wrapping a matrix in ``matrix_opt`` lets repeated products amortize an
inspection step: the first multiply builds a structured plan (DIA for
banded matrices, degree-bucketed SELL otherwise — the analogue of the
oneMKL handle cache) and later multiplies reuse it.
"""

import numpy as np

import spblas_tpu as sp
from spblas_tpu.utils.generate import generate_csr, generate_vector

a = generate_csr(500, 500, 5000, seed=0)
x = generate_vector(500, seed=1)

a_opt = sp.matrix_opt(a)

y1 = sp.multiply(a_opt, x)       # builds + caches the plan
y2 = sp.multiply(a_opt, x)       # reuses it

expected = np.asarray(a.todense()) @ np.asarray(x)
assert np.allclose(np.asarray(y1), expected, rtol=1e-4)
assert np.allclose(np.asarray(y2), expected, rtol=1e-4)
print("plans cached:", list(a_opt._plans.keys()))
print("ok")
