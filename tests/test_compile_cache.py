"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins, else <repo>/.jax_cache."""

import os

import pytest

import jax

from iresearch_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_set_sets_nothing(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_env_unset_uses_repo_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_no_other_code_sets_the_cache_dir():
    """Every script goes through the helper: no program file of the repo
    (tests aside) sets jax_compilation_cache_dir itself."""
    paths = [f for f in os.listdir(REPO) if f.endswith(".py")]
    for sub in ("iresearch_tpu", "scripts", "native"):
        for root, dirs, files in os.walk(os.path.join(REPO, sub)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            paths += [
                os.path.relpath(os.path.join(root, f), REPO)
                for f in files if f.endswith(".py")
            ]
    helper = os.path.join("iresearch_tpu", "utils", "compile_cache.py")
    setters = []
    for path in paths:
        with open(os.path.join(REPO, path)) as fh:
            if path != helper and '"jax_compilation_cache_dir"' in fh.read():
                setters.append(path)
    assert "bench.py" in paths and helper in paths
    assert setters == []
