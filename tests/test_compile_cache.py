"""The persistent-compile-cache helper: JAX_COMPILATION_CACHE_DIR wins
and nothing is set in code; otherwise the caller's fixed directory."""

import jax
import pytest

from sclmd_jax.utils.compile_cache import enable_compile_cache


@pytest.fixture
def updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *args: calls.append(args))
    return calls


def test_env_dir_is_used_and_nothing_set(monkeypatch, tmp_path, updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache("/fixed/in/checkout") == str(tmp_path)
    assert updates == []


def test_fixed_dir_without_env(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache("/fixed/in/checkout") == "/fixed/in/checkout"
    assert updates == [("jax_compilation_cache_dir", "/fixed/in/checkout")]
