"""Lazy tensor views: scaled / conjugated / transposed / optimized.

Re-design of the reference's view layer
(include/spblas/views/scaled_view_impl.hpp:20-223,
conjugated_view_impl.hpp:20-197, algorithms/transposed.hpp:7-22,
views/matrix_opt_impl.hpp:14-97).  The reference re-exposes every iteration
CPO through the wrapper; here the wrappers are tiny pytrees carrying
(alpha, conj-flag) that ops *fold into their kernels* — the runtime analogue
of ``get_scaling_factor`` / ``is_conjugated`` / ``get_ultimate_base``
(detail/view_inspectors.hpp:22-111).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from spblas_tpu.formats.csr import CSR
from spblas_tpu.formats.csc import CSC
from spblas_tpu.formats.coo import COO


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScaledView:
    """Lazy alpha * base (scaled_view_impl.hpp:97-219)."""
    alpha: jax.Array
    base: Any

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return jnp.result_type(self.alpha.dtype, _dtype_of(self.base))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ConjugatedView:
    """Lazy conj(base) (conjugated_view_impl.hpp:87-193)."""
    base: Any

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return _dtype_of(self.base)


def _dtype_of(t):
    return t.dtype


def scaled(alpha, tensor):
    """Lazy alpha-scaling view (algorithms/scaled_impl.hpp:8-17)."""
    return ScaledView(alpha=jnp.asarray(alpha), base=tensor)


def conjugated(tensor):
    """Lazy conjugation; identity for real tensors
    (algorithms/conjugated_impl.hpp:12-28)."""
    if jnp.issubdtype(_dtype_of(tensor), jnp.complexfloating):
        if isinstance(tensor, ConjugatedView):
            return tensor.base  # conj(conj(x)) == x
        return ConjugatedView(base=tensor)
    return tensor


def transposed(tensor):
    """Zero-cost lazy transpose (algorithms/transposed.hpp:7-22).

    CSR(m, n) reinterpreted as CSC(n, m) over the *same* arrays, and vice
    versa — the reference's format flip, preserved verbatim because it is
    already free (no data movement).
    """
    if isinstance(tensor, ScaledView):
        return ScaledView(alpha=tensor.alpha, base=transposed(tensor.base))
    if isinstance(tensor, ConjugatedView):
        return ConjugatedView(base=transposed(tensor.base))
    if isinstance(tensor, OptimizedMatrix):
        # stay optimized through the flip (the reference's matrix_opt
        # keeps its handle through transposed views): re-wrap the
        # transposed base with a FRESH plan cache — the cached plans
        # describe the untransposed orientation (round-4 review: the
        # old unwrap silently dropped the wrapper and every later op
        # re-paid full inspection)
        return OptimizedMatrix(transposed(tensor.base))
    if isinstance(tensor, CSR):
        m, n = tensor.shape
        return CSC(values=tensor.values, colptr=tensor.rowptr,
                   rowind=tensor.colind, nnz=tensor.nnz, shape=(n, m))
    if isinstance(tensor, CSC):
        m, n = tensor.shape
        return CSR(values=tensor.values, rowptr=tensor.colptr,
                   colind=tensor.rowind, nnz=tensor.nnz, shape=(n, m))
    if isinstance(tensor, COO):
        raise TypeError("transposed(COO) would break row-major sorting; "
                        "use ops.transpose for a materialized transpose")
    return jnp.swapaxes(tensor, -1, -2)


class OptimizedMatrix:
    """Opaque optimized-matrix wrapper — the ``matrix_opt`` analogue
    (views/matrix_opt_impl.hpp:14-97).

    Where the oneMKL build caches a vendor ``matrix_handle_t``
    (matrix_opt_impl.hpp:90-92), this caches per-op *plans* (ELL geometry,
    row partitions, level schedules) keyed by plan name.  Not a pytree —
    ops unwrap it before tracing (plans are host-side artifacts)."""

    def __init__(self, base):
        self.base = base
        self._plans = {}

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def get_plan(self, key, builder):
        """Return the cached plan for ``key``, building it on first use
        (mirrors lazy handle creation, detail/get_matrix_handle.hpp:17-40)."""
        if key not in self._plans:
            self._plans[key] = builder(self.base)
        return self._plans[key]


def matrix_opt(tensor) -> OptimizedMatrix:
    """Public name parity with the reference's ``matrix_opt``."""
    if isinstance(tensor, OptimizedMatrix):
        return tensor
    return OptimizedMatrix(tensor)


# --------------------------------------------------------------------- #
# runtime view inspection — detail/view_inspectors.hpp re-imagined
# --------------------------------------------------------------------- #

def get_ultimate_base(t):
    """Walk wrapper chains to the underlying container/array
    (view_inspectors.hpp:105-111)."""
    while isinstance(t, (ScaledView, ConjugatedView, OptimizedMatrix)):
        t = t.base
    return t


def get_scaling_factor(t, dtype=None):
    """Product of all nested scaling factors (view_inspectors.hpp:22-77).

    A scaling that sits *inside* an odd number of conjugation views is
    itself conjugated: conj(alpha * A) == conj(alpha) * conj(A)."""
    alpha = None
    conj_depth = 0
    while isinstance(t, (ScaledView, ConjugatedView, OptimizedMatrix)):
        if isinstance(t, ConjugatedView):
            conj_depth += 1
        if isinstance(t, ScaledView):
            a = jnp.conj(t.alpha) if conj_depth % 2 else t.alpha
            alpha = a if alpha is None else alpha * a
        t = t.base
    if alpha is None:
        return jnp.asarray(1, dtype=dtype or _dtype_of(t))
    return alpha


def is_conjugated(t) -> bool:
    """Parity of nested conjugation views (view_inspectors.hpp:81-97)."""
    conj = False
    while isinstance(t, (ScaledView, ConjugatedView, OptimizedMatrix)):
        if isinstance(t, ConjugatedView):
            conj = not conj
        t = t.base
    return conj


def has_matrix_opt(t) -> bool:
    while isinstance(t, (ScaledView, ConjugatedView)):
        t = t.base
    return isinstance(t, OptimizedMatrix)


def get_matrix_opt(t):
    while isinstance(t, (ScaledView, ConjugatedView)):
        t = t.base
    return t if isinstance(t, OptimizedMatrix) else None


def fold(t):
    """Collapse a view chain to (base, alpha, conj_flag).

    The single entry point ops use to consume any view combination —
    replaces the reference's per-CPO re-export of scaled/conjugated
    wrappers with plain attribute folding.
    """
    base = get_ultimate_base(t)
    alpha = get_scaling_factor(t)
    conj = is_conjugated(t)
    return base, alpha, conj


def fold_values(values, alpha, conj):
    """Apply folded (alpha, conj) to an entry-value array."""
    if conj:
        values = jnp.conj(values)
    return values * alpha


# structural type predicates (views/inspectors.hpp:16-113 analogue)
def is_csr(t) -> bool:
    return isinstance(get_ultimate_base(t), CSR)


def is_csc(t) -> bool:
    return isinstance(get_ultimate_base(t), CSC)


def is_coo(t) -> bool:
    return isinstance(get_ultimate_base(t), COO)


def is_sparse(t) -> bool:
    from spblas_tpu.formats.bsr import BSR
    from spblas_tpu.formats.dcsr import DCSR
    return isinstance(get_ultimate_base(t), (CSR, CSC, COO, BSR, DCSR))


def is_dense_matrix(t) -> bool:
    b = get_ultimate_base(t)
    return hasattr(b, "ndim") and not is_sparse(t) and b.ndim == 2


def is_vector(t) -> bool:
    b = get_ultimate_base(t)
    return hasattr(b, "ndim") and not is_sparse(t) and b.ndim == 1
