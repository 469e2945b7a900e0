"""Persistent compile cache location."""
import os

import jax
import pytest

from vacv_tpu import config


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is used and
    nothing is overridden in code."""
    target = str(tmp_path / "cc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    before = jax.config.jax_compilation_cache_dir
    assert config.enable_compile_cache() == target
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set writes its
    compiled programs there."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    target = tmp_path / "cc"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from vacv_tpu import config\n"
        "config.enable_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 2 + 1)(jnp.ones(8)).block_until_ready()\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(target), PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    assert target.is_dir() and any(target.iterdir())
