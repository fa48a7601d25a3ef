"""Complex-valued operations tour.

The reference instantiates its algorithms over std::complex (concepts
detail/type_traits.hpp:10-18; conjugate_test.cpp); here complex64 runs
through every op, and the plans keep the complex dtype:

  banded complex        -> complex DIA plan             ("dia")
  unstructured complex  -> complex SELL plan            ("sell")
  conjugated views      -> folded into values at dispatch
  Matrix Market complex -> 'complex general' files round-trip

Every step asserts a dense oracle.
"""

import dataclasses
import os
import tempfile

import numpy as np

import jax
import jax.numpy as jnp

import spblas_tpu as sp
from spblas_tpu.kernels import plans as _plans
from spblas_tpu.utils.generate import generate_banded_csr, generate_csr

rng = np.random.default_rng(0)


def complexify(a, seed):
    r = np.random.default_rng(seed)
    vi = r.standard_normal(a.values.shape[0]).astype(np.float32)
    vi[int(a.nnz):] = 0.0                  # canonical zero padding
    vc = (np.asarray(a.values) + 1j * vi).astype(np.complex64)
    return dataclasses.replace(a, values=jnp.asarray(vc))


# --- unstructured complex SpMV: SELL ------------------------------- #
ac = complexify(generate_csr(2048, 2048, 16_000, seed=1), 2)
kind, plan = _plans.build_matvec_plan(ac)
assert kind == "sell", kind
x = (rng.standard_normal(2048)
     + 1j * rng.standard_normal(2048)).astype(np.complex64)
y = np.asarray(_plans.plan_spmv((kind, plan), jnp.asarray(x)))
dense = np.asarray(ac.todense())
assert np.allclose(y, dense @ x, rtol=1e-3, atol=1e-2)
print(f"unstructured complex -> {kind:8s} ok")

# --- banded complex: DIA ------------------------------------------- #
ab = complexify(generate_banded_csr(2048, 2048, 9, seed=3), 4)
kind_b, plan_b = _plans.build_matvec_plan(ab)
assert kind_b == "dia", kind_b
yb = np.asarray(_plans.plan_spmv((kind_b, plan_b), jnp.asarray(x)))
dense_b = np.asarray(ab.todense())
assert np.allclose(yb, dense_b @ x, rtol=1e-3, atol=1e-2)
print(f"banded complex       -> {kind_b:8s} ok")

# --- conjugated / scaled views fold into every op ------------------ #
y2 = np.asarray(sp.multiply(sp.scaled(2j, sp.conjugated(ac)), jnp.asarray(x)))
assert np.allclose(y2, 2j * (np.conj(dense) @ x), rtol=1e-3, atol=1e-2)
print("scaled(2j, conjugated(A)) @ x ok")

# complex SpGEMM through the two-phase protocol
bc = complexify(generate_csr(512, 512, 4_000, seed=5), 6)
info = sp.multiply_compute(bc, sp.conjugated(bc))
c = sp.multiply_fill(info, bc, sp.conjugated(bc))
db = np.asarray(bc.todense())
assert np.allclose(np.asarray(c.todense()), db @ np.conj(db),
                   rtol=1e-3, atol=1e-2)
print(f"complex SpGEMM (nnz {info.result_nnz}) ok")

# --- complex Matrix Market round-trip ------------------------------ #
from spblas_tpu.utils.io import load_matrix_market, save_matrix_market

fd, path = tempfile.mkstemp(suffix=".mtx")
os.close(fd)
try:
    save_matrix_market(path, ac)
    back = load_matrix_market(path)
    assert np.issubdtype(back.dtype, np.complexfloating)
    assert np.allclose(np.asarray(back.todense()), dense,
                       rtol=1e-4, atol=1e-4)
    print("complex MatrixMarket round-trip ok")
finally:
    os.unlink(path)

print("complex_ops: all oracles passed")
