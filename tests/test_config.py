"""Runtime configuration: where Pallas kernels run, and where the
persistent compile cache goes."""

import os

import jax
import pytest

from webdgs import config


@pytest.mark.parametrize("platform,interpret", [("cpu", True),
                                                ("gpu", False)])
def test_use_interpret_mode(platform, interpret):
    assert config.use_interpret_mode(platform) is interpret


def test_use_interpret_mode_rejects_other_platforms():
    """No kernel route exists for any other backend: fail loudly rather
    than fall back to the interpreter."""
    with pytest.raises(RuntimeError, match="rocm"):
        config.use_interpret_mode("rocm")
    # the test session itself runs on the CPU: interpreted
    assert config.use_interpret_mode() is True


@pytest.fixture()
def cache_config():
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


def test_compile_cache_defaults_into_checkout(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    config.enable_compilation_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        root, ".jax_cache")
    assert config.CACHE_DIR == os.path.join(root, ".jax_cache")


def test_compile_cache_follows_environment(cache_config, monkeypatch,
                                           tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    program sets nothing."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    config.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir is None
