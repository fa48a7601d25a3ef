"""The device peak table and the compile-cache placement."""

import os
import types

import pytest

from spblas_tpu.utils import compile_cache, profiling


def test_h100_peaks_from_the_data_sheet():
    pk = profiling.device_peaks(types.SimpleNamespace(
        device_kind="NVIDIA H100 80GB HBM3"))
    assert pk.hbm_bytes_s == 3.35e12
    assert pk.bf16_flops == 989e12 and pk.tf32_flops == 495e12
    assert pk.f32_flops == 67e12 and pk.link_bytes_s == 900e9
    assert "data sheet" in pk.source


@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "NVIDIA A100",
                                  ""])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.device_peaks(types.SimpleNamespace(device_kind=kind))


def test_default_device_is_not_in_the_table():
    # the tests run on the CPU, which has no published peak
    with pytest.raises(KeyError):
        profiling.device_peaks()


def test_every_table_entry_names_its_source():
    for kind, pk in profiling.PEAKS.items():
        assert kind.startswith("NVIDIA") and pk.source


def test_compile_cache_unset_uses_fixed_dir(monkeypatch, tmp_path):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.compile_cache_dir(str(tmp_path))
    assert path == os.path.join(str(tmp_path), ".jax_cache")
    # fixed: the same root always gives the same directory
    assert compile_cache.compile_cache_dir(str(tmp_path)) == path


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "elsewhere"))
    assert compile_cache.compile_cache_dir(str(tmp_path)) is None
    # enable leaves JAX's own reading of the variable alone
    assert compile_cache.enable_compile_cache(str(tmp_path)) == \
        str(tmp_path / "elsewhere")


def test_compile_cache_enable_sets_jax_config(monkeypatch, tmp_path):
    import jax
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache(str(tmp_path))
        assert got == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
