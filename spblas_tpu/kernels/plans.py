"""Plan selection: the optimize ("inspector") step behind matrix_opt.

The reference's vendors hide structure exploitation behind opaque handle
optimization (``optimize_gemv``/``optimize_gemm``,
vendor/onemkl_sycl/detail/matrix_opt hooks); here the chooser is explicit
and decides by structure alone:

  few dense diagonals (banded, stencils) → DIA shift-mul-accumulate
                                            (zero index traffic)
  everything else                        → SELL degree-bucketed rows

Both plans are plain XLA and preserve the operand dtype, so one plan
serves SpMV and SpMM for every dtype.  Plans are cached on the
OptimizedMatrix wrapper, mirroring the lazy handle cache
(detail/get_matrix_handle.hpp:17-40).
"""

from __future__ import annotations

from typing import Tuple

import jax

from spblas_tpu.formats.convert import to_csr
from spblas_tpu.kernels.dia import (build_dia_plan, dia_fill_fraction,
                                    dia_spmm, dia_spmv)
from spblas_tpu.kernels.ell import ell_spmm, ell_spmv
from spblas_tpu.kernels.sell import build_sell_plan, sell_spmm, sell_spmv

# DIA wins when its dense-diagonal storage is mostly true nonzeros:
# above ~1/3 fill, 4 B/slot dense diagonals move fewer bytes than
# 12 B/nnz CSR-style storage.
_DIA_FILL_THRESHOLD = 0.34


def build_matvec_plan(a) -> Tuple[str, object]:
    """(kind, plan) for ``a``; the plan serves both SpMV and SpMM."""
    a = to_csr(a)
    if dia_fill_fraction(a) >= _DIA_FILL_THRESHOLD:
        return ("dia", build_dia_plan(a))
    return ("sell", build_sell_plan(a))


def optimized_plan(opt) -> Tuple[str, object]:
    """The cached (kind, plan) of an OptimizedMatrix, built on first use."""
    return opt.get_plan("plan", build_matvec_plan)


def plan_spmv(plan: Tuple[str, object], x: jax.Array) -> jax.Array:
    kind, p = plan
    if kind == "sell":
        return sell_spmv(p, x)
    if kind == "dia":
        return dia_spmv(p, x)
    return ell_spmv(p, x)


def plan_spmm(plan: Tuple[str, object], b: jax.Array) -> jax.Array:
    kind, p = plan
    if kind == "sell":
        return sell_spmm(p, b)
    if kind == "dia":
        return dia_spmm(p, b)
    return ell_spmm(p, b)
