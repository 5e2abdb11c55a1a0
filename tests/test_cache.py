"""Compile-cache directory rules (optflow.utils.cache)."""

import os
import subprocess
import sys

import jax

from optflow.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_dir_is_used_and_nothing_else_is_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the
    helper reports it and sets no directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    calls = _record_updates(monkeypatch)
    assert cache.enable_persistent_cache() == str(tmp_path / "c")
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.5


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    """Without the variable the cache goes to <checkout>/.jax_cache, a
    git-ignored directory whose path names no process, time or
    temporary name."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    got = cache.enable_persistent_cache()
    assert got == os.path.join(REPO, ".jax_cache") == cache.DEFAULT_DIR
    assert calls["jax_compilation_cache_dir"] == got
    assert os.path.isdir(got)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_default_dir_is_the_same_in_another_process():
    out = subprocess.run(
        [sys.executable, "-c",
         "from optflow.utils.cache import DEFAULT_DIR; print(DEFAULT_DIR)"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=60,
    )
    assert out.stdout.strip() == cache.DEFAULT_DIR
