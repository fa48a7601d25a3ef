"""Block-sparse (BSR) tour: block SpMV/SpMM and block SpGEMM.

Every stored nonzero of a BSR matrix is a dense (bh, bw) tile, so each
product is one batched dense block product over the stored blocks plus a
segment sum by block row (kernels/bsr.py), with zero index traffic
inside blocks.  Any block shape works; this tour uses two.
"""

import numpy as np
import jax.numpy as jnp

import spblas_tpu as sp
from spblas_tpu.formats.bsr import BSR
from spblas_tpu.kernels.bsr import bsr_spgemm_compute, bsr_spgemm_numeric

rng = np.random.default_rng(0)


def blocky(m, n, bh, bw, nblocks, seed):
    r = np.random.default_rng(seed)
    d = np.zeros((m, n), np.float32)
    for _ in range(nblocks):
        i, j = r.integers(m // bh), r.integers(n // bw)
        d[i*bh:(i+1)*bh, j*bw:(j+1)*bw] = r.standard_normal((bh, bw))
    return d


da = blocky(64, 512, 8, 128, 16, seed=1)
a = BSR.from_dense(da, (8, 128))
print("A:", a)

# SpMV / SpMM through the polymorphic multiply
x = rng.standard_normal(512).astype(np.float32)
y = sp.multiply(a, jnp.asarray(x))
assert np.allclose(np.asarray(y), da @ x, rtol=1e-4, atol=1e-4)

b = rng.standard_normal((512, 128)).astype(np.float32)
c = sp.multiply(a, jnp.asarray(b))
assert np.allclose(np.asarray(c), da @ b, rtol=1e-3, atol=1e-3)

# block SpGEMM with numeric reuse (two-phase over the block graph)
db = blocky(512, 384, 128, 128, 10, seed=2)
bm = BSR.from_dense(db, (128, 128))
plan = bsr_spgemm_compute(a, bm)
print("C blocks:", plan.nnzb_c)
c1 = bsr_spgemm_numeric(plan, a, bm)
assert np.allclose(np.asarray(c1.todense()), da @ db, rtol=1e-3,
                   atol=1e-3)

# same through multiply: BSR x BSR goes to the block kernel
c2 = sp.multiply(a, bm)
assert isinstance(c2, BSR) and c2.block_shape == (8, 128)
assert np.allclose(np.asarray(c2.todense()), da @ db, rtol=1e-3,
                   atol=1e-3)

# small square blocks through the same kernels
ds = blocky(256, 256, 16, 16, 60, seed=3)
s16 = BSR.from_dense(ds, (16, 16))
xs = rng.standard_normal(256).astype(np.float32)
assert np.allclose(np.asarray(sp.multiply(s16, jnp.asarray(xs))), ds @ xs,
                   rtol=1e-4, atol=1e-4)
c16 = sp.multiply(s16, s16)
assert isinstance(c16, BSR) and c16.block_shape == (16, 16)
assert np.allclose(np.asarray(c16.todense()), ds @ ds, rtol=1e-3,
                   atol=1e-3)
print("ok")
