"""Device-memory budget and compile-cache placement (host-side settings)."""

import pytest

from svjedi_tpu.align import pipeline as pl
from svjedi_tpu.config import AlignConfig
from svjedi_tpu.utils import jax_cache


class _Device:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_hbm_bytes_config_override_wins():
    cfg = AlignConfig(hbm_bytes=123 << 20)
    assert pl._hbm_bytes(cfg, _Device("gpu", None)) == 123 << 20


def test_hbm_bytes_gpu_reads_bytes_limit():
    dev = _Device("gpu", {"bytes_limit": 60 << 30, "bytes_in_use": 0})
    assert pl._hbm_bytes(AlignConfig(), dev) == 60 << 30


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_hbm_bytes_gpu_without_limit_raises(stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        pl._hbm_bytes(AlignConfig(), _Device("gpu", stats))


def test_hbm_bytes_cpu_gets_its_own_budget():
    assert pl._hbm_bytes(AlignConfig()) == pl.CPU_DEVICE_BYTES
    assert pl._hbm_bytes(AlignConfig(), _Device("cpu", None)) == (
        pl.CPU_DEVICE_BYTES
    )


def test_compile_cache_env_setting_is_left_alone(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    import jax

    from conftest import REPO_ROOT

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = jax_cache.configure_compile_cache()
        assert got == str(REPO_ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
