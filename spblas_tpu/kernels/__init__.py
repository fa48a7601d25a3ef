"""Structured compute kernels — the vendor-backend slot.

Where the reference swaps in cuSPARSE/rocSPARSE/oneMKL behind the same
API (SURVEY.md §2.5), this package holds the structure-exploiting plans
the plan chooser (`plans.build_matvec_plan`) selects from — DIA for
banded and stencil matrices, SELL for general sparsity — plus the BSR
block kernels.  Every kernel is plain XLA.

Submodules load lazily (PEP 562), so importing the package costs
nothing until a kernel is used.
"""

_EXPORTS = {
    "bsr_spmm": "bsr", "bsr_spmv": "bsr",
    "BsrSpgemmPlan": "bsr", "bsr_spgemm": "bsr",
    "bsr_spgemm_compute": "bsr", "bsr_spgemm_numeric": "bsr",
    "DiaPlan": "dia", "build_dia_plan": "dia", "dia_spmm": "dia",
    "dia_spmv": "dia",
    "EllPlan": "ell", "build_ell_plan": "ell", "ell_spmm": "ell",
    "ell_spmv": "ell",
    "SellPlan": "sell", "build_sell_plan": "sell", "sell_spmm": "sell",
    "sell_spmv": "sell",
    "build_matvec_plan": "plans", "plan_spmm": "plans",
    "plan_spmv": "plans",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'spblas_tpu.kernels' has no attribute {name!r}")
    import importlib
    value = getattr(
        importlib.import_module(f"spblas_tpu.kernels.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
