"""Global type configuration for spblas_tpu.

Equivalents of the reference's ``spblas::index_t`` / ``offset_t`` globals
(reference: include/spblas/detail/types.hpp:28-31).  The vendor backends in
the reference all narrow indices to 32 bits (vendor/rocsparse/types.hpp:11-12,
vendor/cusparse/types.hpp:12-13); we follow that precedent.

Unlike the reference (compile-time ``#define`` forest), configuration here is
a small runtime dataclass — see SURVEY.md §5.6.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import jax.numpy as jnp

# Default index / offset dtype (CSR colind, rowptr).  int32 everywhere —
# watch 2^31 nnz limits on very large matrices (SURVEY.md §7 hard parts).
index_dtype = jnp.int32
offset_dtype = jnp.int32

# Default real scalar dtype.
real_dtype = jnp.float32


@dataclasses.dataclass(frozen=True)
class Config:
    """Runtime knobs for plans.

    The reference's only runtime knobs are execution-policy objects
    (vendor/onemkl_sycl/detail/execution_policy.hpp:10-48); device placement
    in JAX is implicit via sharding, so this holds capacity policy only.
    """

    # Quantize capacities to powers of two to limit recompilation
    # (SURVEY.md §7: dynamic nnz vs static shapes).
    capacity_quantum: bool = True


DEFAULT_CONFIG = Config()


def quantize_capacity(nnz: int, cfg: Config = DEFAULT_CONFIG) -> int:
    """Round a requested capacity up to a power-of-two bucket.

    Keeps the set of distinct compiled shapes small when matrices with
    nearby nnz flow through the same jitted op.
    """
    nnz = int(nnz)
    if nnz <= 0:
        return 1
    if not cfg.capacity_quantum:
        return nnz
    return 1 << (nnz - 1).bit_length()


_WIDE_SCALARS = ("float64", "complex128")


def check_values_dtype(values, where: str) -> None:
    """Loud-downcast guard for 64-bit scalars at container boundaries.

    The reference templates every algorithm and view over ``double``
    (include/spblas/views/csr_view.hpp:12-16; the gtest tolerance model
    instantiates double suites, test/gtest/util.hpp:7-23).  JAX narrows
    float64/complex128 to 32 bits whenever x64 is disabled; doing that
    silently at a container constructor violates the reference contract,
    so: raise under ``SPBLAS_STRICT_DTYPE=1``, warn otherwise.  With
    ``jax.config.update("jax_enable_x64", True)`` every path runs
    genuinely in f64.
    """
    dt = getattr(values, "dtype", None)
    if dt is None or str(dt) not in _WIDE_SCALARS:
        return
    import jax

    if jax.config.jax_enable_x64:
        return
    msg = (f"{where}: {dt} values are narrowed to 32 bits because jax "
           "x64 is disabled. Enable jax_enable_x64 to keep 64-bit "
           "precision, or set SPBLAS_STRICT_DTYPE=1 "
           "to make this an error.")
    if os.environ.get("SPBLAS_STRICT_DTYPE") == "1":
        raise TypeError(msg)
    warnings.warn(msg, UserWarning, stacklevel=3)
