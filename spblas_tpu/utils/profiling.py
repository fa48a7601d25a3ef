"""Device peak rates and inspection-phase timing — the perf observability
the reference lacks entirely (SURVEY.md §6: no benchmark or counter of
any kind).

``PEAKS`` is the one table of published device peaks, keyed by JAX's
``device_kind``.  A device that is not in it is an error: no rate is
assumed.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one device (dense, without sparsity)."""

    hbm_bytes_s: float
    f32_flops: float          # float32 outside the tensor cores
    tf32_flops: float
    bf16_flops: float
    fp8_flops: float
    int8_ops: float
    link_bytes_s: float       # NVLink to the other cards, both ways
    source: str


_H100_SXM = DevicePeaks(
    hbm_bytes_s=3.35e12, f32_flops=67e12, tf32_flops=495e12,
    bf16_flops=989e12, fp8_flops=1979e12, int8_ops=1979e12,
    link_bytes_s=900e9,
    source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 80 GB part; "
           "rates assume the 700 W power limit")
_H200_SXM = dataclasses.replace(
    _H100_SXM, hbm_bytes_s=4.8e12,
    source="NVIDIA H200 Tensor Core GPU data sheet, SXM part")

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
    "NVIDIA H200": _H200_SXM,
}


def device_peaks(device=None) -> DevicePeaks:
    """Published peaks of ``device`` (default: the first JAX device);
    raises KeyError for a device kind the table does not hold."""
    if device is None:
        import jax
        device = jax.devices()[0]
    kind = device.device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       "add them to spblas_tpu.utils.profiling.PEAKS "
                       "with their source")
    return PEAKS[kind]


# ------------------------------------------------------------------ #
# inspection-phase breakdown (host pack vs device upload) — plan
# builders record phases here; benches read them so the recorded
# inspect latency is attributable
# ------------------------------------------------------------------ #

_inspect_phases: dict = {}


def record_phase(op: str, name: str, seconds: float) -> None:
    _inspect_phases.setdefault(op, {})[name] = round(seconds, 4)


def inspect_phases(op: str) -> dict:
    """Snapshot of the most recent inspection breakdown for ``op``."""
    return dict(_inspect_phases.get(op, {}))
