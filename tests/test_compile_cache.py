"""The one rule for the persistent compilation cache's location."""

import jax
import pytest

from spherical_ba.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_wins_and_nothing_is_set(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable()
    assert path == compile_cache.DEFAULT_DIR
    assert path.endswith(".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
