"""Device-mesh helpers — the communication substrate layer.

The reference has no distribution layer of any kind (SURVEY.md §2.6: zero
MPI/NCCL/Gloo occurrences; vendor queues are single-device).  Distribution
here is a new first-class layer: a 1-D ``jax.sharding.Mesh`` over a row
axis, ``shard_map``-scoped XLA collectives (``ppermute`` ring halo
pipelines, ``all_gather`` fallback, ``psum``), which XLA hands to the
device interconnect.

Multi-process bootstrap is ``jax.distributed.initialize()`` (call it once
per process before :func:`make_row_mesh`); single-process tests fake an
8-device mesh via ``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"


def make_row_mesh(num_devices: Optional[int] = None,
                  devices: Optional[Sequence] = None,
                  axis_name: str = ROW_AXIS) -> Mesh:
    """1-D mesh over the row-partition axis.

    The cards of one host are joined all to all, so the mesh order
    follows the algorithm alone.
    """
    if devices is not None:
        return Mesh(np.asarray(devices), (axis_name,))
    if num_devices is None:
        num_devices = jax.device_count()
    # Auto axis type: this layer does manual SPMD via shard_map, not the
    # explicit-sharding tracing mode that jax.make_mesh defaults to.
    return jax.make_mesh((num_devices,), (axis_name,),
                         axis_types=(jax.sharding.AxisType.Auto,))


def mesh_size(mesh: Mesh, axis_name: str = ROW_AXIS) -> int:
    """Devices along the row axis."""
    return int(mesh.shape[axis_name])


def check_mesh_matches(p: int, mesh: Mesh, what: str,
                       axis_name: str = ROW_AXIS) -> None:
    """Every distributed executor calls this: a plan/container
    partitioned for p devices run on a different-size mesh would have
    shard_map hand each kernel a (p/mesh, ...) local slice of which the
    kernels read only block [0] — silently dropping data (round-4
    review)."""
    ms = mesh_size(mesh, axis_name)
    if int(p) != ms:
        raise ValueError(
            f"{what}: partitioned for p={int(p)} devices but the mesh "
            f"has {ms}; re-partition on this mesh")


def row_sharding(mesh: Mesh, ndim: int = 1,
                 axis_name: str = ROW_AXIS) -> NamedSharding:
    """Shard the leading axis over the mesh row axis, replicate the rest."""
    return NamedSharding(mesh, P(axis_name, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def ring_perm(p: int, shift: int = 1):
    """Permutation pairs (src, dst) rotating blocks by ``shift`` device
    positions: after the permute, device d holds what device d+shift held."""
    return [(i, (i - shift) % p) for i in range(p)]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Multi-process bootstrap: call once per process before building a
    mesh that spans processes (the stand-in for the MPI/NCCL init the
    reference never had — SURVEY.md §2.6/§5.8).

    No-op when jax.distributed is already initialized or when running
    single-process (tests, single chip).
    """
    import jax

    if coordinator_address is None and num_processes is None:
        return  # single-process run: nothing to do
    # do NOT probe jax.process_count()/devices() here: that initializes
    # the XLA backend, after which jax.distributed.initialize refuses to
    # run — exactly the path this helper exists for
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError as e:
        if "already" in str(e).lower():
            return  # initialized earlier in this process
        raise
