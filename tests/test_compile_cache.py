"""The persistent compile cache goes where JAX_COMPILATION_CACHE_DIR says,
and to the checkout's .jax_cache when it is unset."""

import pytest

import jax

from boundplanner_tpu import compile_cache


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_cache_dir(tmp_path, monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = str(compile_cache.CHECKOUT / ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv(compile_cache.ENV_VAR, want)
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert compile_cache.cache_dir() == want
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", before[1])


def test_checkout_is_repo_root():
    assert (compile_cache.CHECKOUT / "boundplanner_tpu" / "compile_cache.py").exists()
