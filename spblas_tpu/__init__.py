"""spblas_tpu — a JAX sparse linear-algebra framework.

Brand-new JAX/XLA implementation of the Sparse BLAS capability set of
SparseBLAS/spblas-reference: SpMV, SpMM,
two-phase SpGEMM (with numeric reuse and the 4-arg fused form), SpADD,
SpTRSV with level scheduling, transpose, and the scaled / conjugated /
transposed / matrix_opt view algebra — over CSR / CSC / COO / BSR pytree
containers — plus a distribution layer (row-partitioned matrices over a
``jax.sharding.Mesh``) that the single-process reference does not have.

Public surface mirrors the reference's umbrella header
(include/spblas/spblas.hpp:9-13): algorithms + views + formats.
"""

from spblas_tpu.types import Config, DEFAULT_CONFIG, index_dtype, real_dtype

from spblas_tpu.formats.csr import CSR
from spblas_tpu.formats.csc import CSC
from spblas_tpu.formats.coo import COO
from spblas_tpu.formats.bsr import BSR
from spblas_tpu.formats.convert import to_csr, to_csc, to_coo

from spblas_tpu.views import (
    ScaledView, ConjugatedView, OptimizedMatrix,
    scaled, conjugated, transposed, matrix_opt,
    get_ultimate_base, get_scaling_factor, is_conjugated,
)

from spblas_tpu.info import OperationInfo

from spblas_tpu.ops.multiply import (
    multiply, multiply_inspect, multiply_compute, multiply_fill,
)
from spblas_tpu.ops.spmv import spmv
from spblas_tpu.ops.spmm import spmm
from spblas_tpu.ops.spgemm import (
    spgemm, spgemm_chunked, spgemm_compute, spgemm_csc, spgemm_fill,
    SpgemmState,
    multiply_symbolic_compute, multiply_symbolic_fill, multiply_numeric,
    multiply_fused,
)
from spblas_tpu.ops.add import add, add_inspect, add_compute
from spblas_tpu.ops.transpose import transpose, transpose_inspect
from spblas_tpu.ops.scale import scale
from spblas_tpu.ops.triangular_solve import (
    triangular_solve, triangular_solve_inspect,
)
from spblas_tpu import solvers

__version__ = "0.1.0"

__all__ = [
    "CSR", "CSC", "COO", "BSR", "to_csr", "to_csc", "to_coo",
    "ScaledView", "ConjugatedView", "OptimizedMatrix",
    "scaled", "conjugated", "transposed", "matrix_opt",
    "get_ultimate_base", "get_scaling_factor", "is_conjugated",
    "OperationInfo",
    "multiply", "multiply_inspect", "multiply_compute", "multiply_fill",
    "spmv", "spmm",
    "spgemm", "spgemm_chunked", "spgemm_compute", "spgemm_csc",
    "spgemm_fill", "SpgemmState",
    "multiply_symbolic_compute", "multiply_symbolic_fill",
    "multiply_numeric", "multiply_fused",
    "add", "add_inspect", "add_compute",
    "transpose", "transpose_inspect", "scale",
    "triangular_solve", "triangular_solve_inspect",
    "Config", "DEFAULT_CONFIG", "index_dtype", "real_dtype",
]
