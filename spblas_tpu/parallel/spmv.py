"""Distributed SpMV / SpMM over a row-partitioned mesh.

New first-class layer with no reference counterpart (SURVEY.md §2.6):
the reference delegates all device work to single-queue vendor libraries.
Specified by BASELINE.json's north-star: row-partitioned distributed
SpMV with halo collectives overlapped with local compute.

``partition_spmv`` / ``partition_spmm`` return a ``(kind, plan)`` pair
(generic gather blocks by default; the banded halo pipeline or per-shard
SELL on request) and ``dist_plan_spmv`` / ``dist_plan_spmm`` run it.

Two ``dist_spmv`` strategies, both inside ``shard_map``:

* ``ring``  — systolic pipeline: x stays block-sharded; at step s every
  device multiplies its (rotation-scheduled) local block s against the x
  chunk it currently holds, while ``ppermute`` rotates chunks one hop
  around the ring.  Memory per device is O(n/p); XLA overlaps the
  permute with the block compute (the collective and the segment-sum are
  data-independent within a step).
* ``allgather`` — gather x fully, then one local SpMV over the
  concatenated blocks; simplest, best for small n.

The step kernel is gather·mul·segment-sum over the COO blocks — the same
canonical-padding trick as single-device SpMV (padded entries carry row id
``mloc`` and value 0, so no masks anywhere in the numeric path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from spblas_tpu.parallel.dist_csr import DistCSR
from spblas_tpu.parallel.mesh import ROW_AXIS, ring_perm


def _block_contrib(values, rowloc, colloc, chunk, mloc):
    """One block's y-contribution: (bcap,) gather·mul → segment-sum.

    For SpMM ``chunk`` is (nloc, k) and the result is (mloc, k).
    """
    contrib = values[..., None] * chunk[colloc] if chunk.ndim == 2 \
        else values * chunk[colloc]
    return jax.ops.segment_sum(contrib, rowloc, num_segments=mloc)


def _ring_kernel(values, rowloc, colloc, x, *, p, mloc):
    """shard_map body: values/rowloc/colloc are (1, p, bcap) local slices,
    x is the local (nloc,) or (nloc, k) chunk."""
    values, rowloc, colloc = values[0], rowloc[0], colloc[0]
    out_shape = (mloc,) if x.ndim == 1 else (mloc, x.shape[1])
    acc = jnp.zeros(out_shape, dtype=jnp.result_type(values.dtype, x.dtype))
    chunk = x
    for s in range(p):
        # Block s on this device is pre-scheduled for the chunk that
        # arrives at step s (rotation layout) — static index, no
        # dynamic slicing on device id.
        nxt = jax.lax.ppermute(chunk, ROW_AXIS, ring_perm(p)) \
            if s + 1 < p else chunk
        acc = acc + _block_contrib(values[s], rowloc[s], colloc[s],
                                   chunk, mloc)
        chunk = nxt
    return acc


def _allgather_kernel(values, rowloc, colloc, x, *, p, mloc, nloc):
    values, rowloc, colloc = values[0], rowloc[0], colloc[0]
    d = jax.lax.axis_index(ROW_AXIS)
    xg = jax.lax.all_gather(x, ROW_AXIS)        # (p, nloc[, k])
    out_shape = (mloc,) if x.ndim == 1 else (mloc, x.shape[1])
    acc = jnp.zeros(out_shape, dtype=jnp.result_type(values.dtype, x.dtype))
    for s in range(p):
        # block s holds columns of device (d + s) % p
        chunk = jax.lax.dynamic_index_in_dim(
            xg, (d + s) % p, axis=0, keepdims=False)
        acc = acc + _block_contrib(values[s], rowloc[s], colloc[s],
                                   chunk, mloc)
    return acc


def dist_spmv(a: DistCSR, x: jax.Array, mesh, strategy: str = "ring"
              ) -> jax.Array:
    """y = A @ x, A row-partitioned, x/y block-sharded over the mesh —
    the generic gather-block path.  Returns y of padded length p*mloc
    sharded over ``rows``; use ``gather_result`` to strip padding."""
    return _dist_apply(a, x, mesh, strategy)


# ------------------------------------------------------------------ #
# distributed matvec chooser
# ------------------------------------------------------------------ #

def partition_spmv(a, mesh, prefer: str = "csr"):
    """Distributed matvec chooser: returns ``(kind, plan)``.

    ``kind`` is ``"csr"`` (generic gather blocks, the default) or
    ``"band"`` (halo band pipeline for narrow-band patterns).  Run the
    result with :func:`dist_plan_spmv`; shard operands with
    :func:`partition_spmv_vector`."""
    from spblas_tpu.formats.convert import to_csr

    a = to_csr(a)
    if prefer == "band":
        from spblas_tpu.parallel.banded import partition_band
        return "band", partition_band(a, mesh)
    if prefer == "csr":
        from spblas_tpu.parallel.dist_csr import partition_csr
        return "csr", partition_csr(a, mesh)
    raise ValueError(f"unknown kind {prefer!r}")


def partition_spmv_vector(kind_plan, x, mesh):
    """Shard a global operand vector for :func:`dist_plan_spmv`
    according to the chosen kind's layout."""
    kind, plan = kind_plan
    x = jnp.asarray(x)
    if kind == "band":
        from spblas_tpu.parallel.banded import partition_band_vector
        return partition_band_vector(x, plan, mesh)
    n = plan.shape[1]
    xp = jnp.pad(x, (0, plan.p * plan.nloc - n))
    return jax.device_put(xp, NamedSharding(mesh, P(ROW_AXIS)))


def dist_plan_spmv(kind_plan, x, mesh):
    """Run the distributed matvec picked by :func:`partition_spmv`.
    Returns the padded row-sharded result (kind-specific padding; rows
    [0, m) are the answer for every kind)."""
    kind, plan = kind_plan
    if kind == "band":
        from spblas_tpu.parallel.banded import dist_band_spmv
        return dist_band_spmv(plan, x, mesh)
    return _dist_apply(plan, x, mesh, "ring")


def dist_spmm(a: DistCSR, b: jax.Array, mesh, strategy: str = "ring"
              ) -> jax.Array:
    """C = A @ B for dense B (p*nloc, k) row-sharded; C is (p*mloc, k).
    Generic gather-block kernel."""
    return _dist_apply(a, b, mesh, strategy)


# ------------------------------------------------------------------ #
# distributed matmul chooser (mirrors the matvec chooser; reference
# bar: vendor SpMM is one entry point for every pattern,
# cusparse/detail/spmm_impl.hpp)
# ------------------------------------------------------------------ #

def partition_spmm(a, mesh, prefer: str = "csr"):
    """Distributed matmul chooser: returns ``(kind, plan)``.

    ``kind`` is ``"csr"`` (generic gather blocks, the default),
    ``"band"`` (halo band pipeline) or ``"sell"`` (per-shard SELL
    row-gather buckets).  Run with :func:`dist_plan_spmm`; shard the
    dense operand with :func:`partition_spmm_operand`."""
    from spblas_tpu.formats.convert import to_csr

    a = to_csr(a)
    if prefer == "band":
        from spblas_tpu.parallel.banded import partition_band
        return "band", partition_band(a, mesh)
    if prefer == "sell":
        from spblas_tpu.parallel.sell_spmm import partition_sell
        return "sell", partition_sell(a, mesh)
    if prefer == "csr":
        from spblas_tpu.parallel.dist_csr import partition_csr
        return "csr", partition_csr(a, mesh)
    raise ValueError(f"unknown kind {prefer!r}")


def partition_spmm_operand(kind_plan, b, mesh):
    """Shard the dense operand B (n, k) for :func:`dist_plan_spmm`
    according to the chosen kind's layout."""
    kind, plan = kind_plan
    b = jnp.asarray(b)
    if kind == "band":
        from spblas_tpu.parallel.banded import partition_band_vector
        return partition_band_vector(b, plan, mesh)
    n = plan.shape[1]
    bp = jnp.pad(b, ((0, plan.p * plan.nloc - n), (0, 0)))
    return jax.device_put(
        bp, NamedSharding(mesh, P(ROW_AXIS, None)))


def dist_plan_spmm(kind_plan, b, mesh):
    """Run the distributed matmul picked by :func:`partition_spmm`.
    Returns the padded row-sharded result (rows [0, m) are the answer
    for every kind)."""
    kind, plan = kind_plan
    if kind == "band":
        from spblas_tpu.parallel.banded import dist_band_spmm
        return dist_band_spmm(plan, b, mesh)
    if kind == "sell":
        from spblas_tpu.parallel.sell_spmm import dist_sell_spmm
        return dist_sell_spmm(plan, b, mesh)
    return _dist_apply(plan, b, mesh, "ring")


def _dist_apply(a: DistCSR, x, mesh, strategy):
    p, mloc, nloc = a.p, a.mloc, a.nloc
    from spblas_tpu.parallel.mesh import check_mesh_matches
    check_mesh_matches(p, mesh, "dist_spmv/dist_spmm")
    if x.shape[0] != p * nloc:
        raise ValueError(
            f"operand leading dim {x.shape[0]} != padded n {p * nloc}; "
            "use partition_vector")
    vec_tail = (None,) * (x.ndim - 1)
    in_specs = (P(ROW_AXIS, None, None),) * 3 + (P(ROW_AXIS, *vec_tail),)
    out_spec = P(ROW_AXIS, *vec_tail)
    if strategy == "ring":
        kern = partial(_ring_kernel, p=p, mloc=mloc)
    elif strategy == "allgather":
        kern = partial(_allgather_kernel, p=p, mloc=mloc, nloc=nloc)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    fn = jax.jit(jax.shard_map(kern, mesh=mesh, in_specs=in_specs,
                               out_specs=out_spec))
    return fn(a.values, a.rowloc, a.colloc, x)
