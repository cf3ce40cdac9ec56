"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR when set, else one
fixed directory in the checkout — never a temp name, a pid or a time."""

import os

import jax

from rs_tfhe_tpu.utils import cache


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.compile_cache_dir() == (str(tmp_path), True)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    path, from_env = cache.compile_cache_dir()
    assert not from_env
    assert path == os.path.join(cache.CHECKOUT_ROOT, ".jax_cache")
    assert os.path.isfile(os.path.join(cache.CHECKOUT_ROOT, "chip_smoke.py"))
    assert cache.compile_cache_dir() == (path, False)  # stable across calls


def test_enable_sets_dir_only_without_environment(monkeypatch, tmp_path):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    path = cache.enable_compile_cache()
    assert calls["jax_compilation_cache_dir"] == path
    calls.clear()
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls  # JAX reads the env var
