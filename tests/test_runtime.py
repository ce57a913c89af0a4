"""Process setup shared by the entry points (fpr_tpu.utils.runtime): the
compile-cache location, the GPU guard and the card line."""

import jax
import pytest

from fpr_tpu.utils import runtime


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them (the test
    process must not start writing a compile cache)."""
    seen = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: seen.append((k, v)))
    return seen


def test_compile_cache_respects_env(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert config_updates == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_repo_dir(monkeypatch, config_updates):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    got = runtime.enable_compile_cache()
    assert got == str(runtime.DEFAULT_CACHE_DIR)
    assert runtime.DEFAULT_CACHE_DIR.parent.joinpath("fpr_tpu").is_dir()
    assert runtime.DEFAULT_CACHE_DIR.name == ".jax_cache"
    assert config_updates == [("jax_compilation_cache_dir", got)]


def test_gpu_guard_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert runtime.card_line().startswith("nvidia-smi unavailable")
