"""Placement of the persistent compile cache
(spectral_tpu/utils/compile_cache.py)."""

from __future__ import annotations

import os
import subprocess

import jax
import pytest

from spectral_tpu.utils import compile_cache as cc


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_honoured(restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    got = cc.configure_compile_cache({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"})
    assert got == "/elsewhere/cache"
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_default_is_fixed_path_in_checkout(restore_cache_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # independent of the working directory
    got = cc.configure_compile_cache({})
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert cc.configure_compile_cache({}) == got  # the same on every call


def test_default_dir_is_git_ignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = open(os.path.join(repo, ".gitignore")).read().split()
    assert ".jax_cache/" in lines
    if os.path.isdir(os.path.join(repo, ".git")):
        out = subprocess.run(
            ["git", "check-ignore", "-q", ".jax_cache/x"], cwd=repo,
        )
        assert out.returncode == 0
