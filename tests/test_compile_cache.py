"""utils.compile_cache: JAX_COMPILATION_CACHE_DIR wins and nothing is set
in code; otherwise the fixed <repo>/.jax_cache, independent of the working
directory and the process."""

import os
import subprocess
import sys

import jax
import pytest

from levelsetfortran_jax.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_var_wins_and_nothing_is_set(monkeypatch, restore_cache_dir,
                                         tmp_path):
    jax.config.update("jax_compilation_cache_dir", "/sentinel")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/sentinel"


def test_default_is_repo_jax_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.configure_compile_cache()
    assert got == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_default_independent_of_cwd(monkeypatch, restore_cache_dir,
                                    tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert compile_cache.configure_compile_cache() == os.path.join(
        ROOT, ".jax_cache")


def test_default_independent_of_process(tmp_path):
    """A second process from another directory resolves the same path."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "from levelsetfortran_jax.utils.compile_cache import DEFAULT_DIR;"
         "print(DEFAULT_DIR)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == compile_cache.DEFAULT_DIR
    assert str(os.getpid()) not in compile_cache.DEFAULT_DIR
