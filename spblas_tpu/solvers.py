"""Iterative solvers on top of the sparse ops — jit-compatible loops.

Beyond the reference's scope (it stops at the BLAS layer), but the
natural consumer of a sparse framework: every solver below is
a pure jax function over the framework's containers/plans, so it jits,
differentiates, and shards like any other jax code.

All loops are `lax.while_loop`/`fori_loop` (compiled once, no host sync
per iteration); operators can be any object accepted by `multiply`
(CSR/BSR/plans via matrix_opt, or a partially-applied kernel).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import jax
import jax.numpy as jnp

from spblas_tpu.ops.spmv import spmv


def _as_matvec(a) -> Callable:
    if callable(a) and not hasattr(a, "shape"):
        return a
    return lambda v: spmv(a, v)


class CGResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array
    residual_norm: jax.Array


def cg(a, b: jax.Array, x0: Optional[jax.Array] = None,
       tol: float = 1e-6, maxiter: int = 1000) -> CGResult:
    """Conjugate gradients for SPD A (matrix container, optimized plan
    via matrix_opt, or a matvec callable)."""
    mv = _as_matvec(a)
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    r = b - mv(x)
    p = r
    rs = jnp.vdot(r, r).real
    tol2 = jnp.asarray(tol, rs.dtype) ** 2 * jnp.vdot(b, b).real

    def cond(state):
        _, _, _, rs, k = state
        return (rs > tol2) & (k < maxiter)

    def body(state):
        x, r, p, rs, k = state
        ap = mv(p)
        alpha = rs / jnp.vdot(p, ap).real
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r).real
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new, k + 1

    x, r, p, rs, k = jax.lax.while_loop(
        cond, body, (x, r, p, rs, jnp.asarray(0)))
    return CGResult(x=x, iterations=k, residual_norm=jnp.sqrt(rs))


class PowerResult(NamedTuple):
    eigenvalue: jax.Array
    eigenvector: jax.Array


def power_method(a, n: int, iters: int = 100,
                 key: Optional[jax.Array] = None) -> PowerResult:
    """Dominant eigenpair by power iteration (normalized each step)."""
    mv = _as_matvec(a)
    if key is None:
        key = jax.random.PRNGKey(0)
    # iterate in the operator's dtype — a hardcoded f32 carry made the
    # fori_loop reject f64/complex operators at trace time (A@v
    # promotes the carry)
    op_dtype = jnp.result_type(getattr(a, "dtype", jnp.float32))
    real = jnp.finfo(op_dtype).dtype if jnp.issubdtype(
        op_dtype, jnp.floating) else jnp.float32
    v0 = jax.random.normal(key, (n,), real).astype(op_dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, v):
        w = mv(v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, iters, body, v0)
    lam = jnp.vdot(v, mv(v)).real
    return PowerResult(eigenvalue=lam, eigenvector=v)


def jacobi(a, b: jax.Array, diag: jax.Array,
           x0: Optional[jax.Array] = None, iters: int = 50,
           omega: float = 1.0) -> jax.Array:
    """(Weighted) Jacobi smoother: x ← x + ω D⁻¹ (b − A x).

    ``diag`` is A's diagonal (the caller extracts it once; the framework
    stores matrices by structure plans, not by element access)."""
    mv = _as_matvec(a)
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    inv_d = jnp.asarray(omega, b.dtype) / diag

    def body(_, x):
        return x + inv_d * (b - mv(x))

    return jax.lax.fori_loop(0, iters, body, x)
