"""Operation info objects — the inspector-executor contract.

Analogue of ``operation_info_t``
(reference: include/spblas/detail/operation_info_t.hpp:28-103): the result of
a symbolic/inspect phase, carrying ``result_shape`` / ``result_nnz`` plus an
opaque, backend-owned plan.  Where the reference stashes vendor handles in a
conditionally-compiled ``state_`` member, here the plan is an explicit
serializable payload (gather maps, segment ids, level schedules, ELL
geometry) so inspection cost is amortizable across runs — SURVEY.md §5.4.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass
class OperationInfo:
    """Result of an *_inspect / *_compute symbolic phase.

    result_nnz is a **host** integer: the two-phase protocol's single
    device→host sync happens inside the compute phase (mirroring the
    oneMKL matmat nnz read-back, vendor/onemkl_sycl/spgemm_impl.hpp:106-117),
    so the user can allocate before the numeric fill.
    """

    result_shape: Tuple[int, int]
    result_nnz: int
    # suggested padded capacity for the output (power-of-two bucket)
    result_capacity: Optional[int] = None
    # opaque backend plan (device arrays and/or host metadata)
    plan: Any = None
    # opaque reuse state (e.g. SpGEMM gather/segment maps)
    state: Any = None

    def update(self, **kw) -> "OperationInfo":
        """Functional analogue of operation_info_t::update_impl_
        (operation_info_t.hpp:71-74)."""
        return dataclasses.replace(self, **kw)
