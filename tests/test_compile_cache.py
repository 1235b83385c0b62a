"""Where the persistent compilation cache lands (runtime/compile_cache.py)."""

import jax
import pytest

from trpx_tpu.runtime import compile_cache


@pytest.fixture
def config_calls(monkeypatch):
    """Record jax.config.update calls instead of turning the cache on for
    the rest of the suite."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("TRPX_JAX_CACHE", raising=False)
    return calls


def test_env_dir_is_used_and_nothing_else_set(config_calls, monkeypatch,
                                              tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in config_calls


def test_default_dir_beside_the_package(config_calls, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.enable_compile_cache()
    root = compile_cache.DEFAULT_DIR.parent
    assert d == str(root / ".jax_cache")
    assert (root / "trpx_tpu" / "runtime" / "compile_cache.py").exists()
    assert config_calls["jax_compilation_cache_dir"] == d
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


def test_switched_off(config_calls, monkeypatch):
    monkeypatch.setenv("TRPX_JAX_CACHE", "0")
    assert compile_cache.enable_compile_cache() is None
    assert config_calls == {}
