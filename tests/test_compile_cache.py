"""Compile-cache location: the environment wins, else a fixed in-checkout path."""

import os

import jax

from vloam_tpu.utils import compile_cache


def test_env_dir_left_alone(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_checkout_path(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
