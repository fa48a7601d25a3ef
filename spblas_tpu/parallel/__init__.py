"""Distribution layer: row-partitioned sparse ops over a device mesh.

The reference has no distribution of any kind (SURVEY.md §2.6); this layer
is specified by BASELINE.json's north star — row-partitioned distributed
SpMV/SpMM/SpGEMM with shard_map-scoped XLA collectives between devices.
"""

from spblas_tpu.parallel.mesh import (
    ROW_AXIS, make_row_mesh, ring_perm, row_sharding, replicated,
)
from spblas_tpu.parallel.dist_csr import (
    DistCSR, partition_csr, partition_vector, gather_result, to_local_csr,
)
from spblas_tpu.parallel.rowblock import (
    RowBlockCSR, partition_rowblock, assemble_csr,
)
from spblas_tpu.parallel.spmv import (
    dist_spmv, dist_spmm, partition_spmv, partition_spmv_vector,
    dist_plan_spmv, partition_spmm, partition_spmm_operand,
    dist_plan_spmm,
)
from spblas_tpu.parallel.banded import (
    DistBandPlan, partition_band, partition_band_vector, dist_band_spmv,
    dist_band_spmm,
)
from spblas_tpu.parallel.add import (
    DistAddPlan, dist_add, dist_add_compute, dist_add_numeric,
)
from spblas_tpu.parallel.trsv import (
    DistTrsvPlan, dist_triangular_solve, dist_triangular_solve_inspect,
)
from spblas_tpu.parallel.spgemm import (
    DistSpgemmPlan, dist_spgemm, dist_spgemm_compute, dist_spgemm_numeric,
)
from spblas_tpu.parallel.sell_spmm import (
    DistSellPlan, partition_sell, dist_sell_spmm,
)

__all__ = [
    "ROW_AXIS", "make_row_mesh", "ring_perm", "row_sharding", "replicated",
    "DistCSR", "partition_csr", "partition_vector", "gather_result",
    "to_local_csr",
    "RowBlockCSR", "partition_rowblock", "assemble_csr",
    "partition_spmv", "partition_spmv_vector", "dist_plan_spmv",
    "partition_spmm", "partition_spmm_operand", "dist_plan_spmm",
    "dist_spmv", "dist_spmm",
    "DistBandPlan", "partition_band", "partition_band_vector",
    "dist_band_spmv", "dist_band_spmm",
    "DistAddPlan", "dist_add", "dist_add_compute", "dist_add_numeric",
    "DistTrsvPlan", "dist_triangular_solve",
    "dist_triangular_solve_inspect",
    "DistSpgemmPlan", "dist_spgemm", "dist_spgemm_compute",
    "dist_spgemm_numeric",
    "DistSellPlan", "partition_sell", "dist_sell_spmm",
]
