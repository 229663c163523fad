"""utils.compile_cache: persistent executable cache placement (the
reference's compile-once analog — nvcc at build time, Makefile:11-12)."""

import os

import jax
import pytest

from cbet_raytracing_3d_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cc.enable_persistent_cache()
    assert got == os.path.join(REPO, ".jax_cache") == cc.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == got


def test_env_set_is_used_and_not_overridden(tmp_path, monkeypatch,
                                            restore_cache_dir):
    d = str(tmp_path / "xla")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    jax.config.update("jax_compilation_cache_dir", d)   # as JAX reads it
    assert cc.enable_persistent_cache() == d
    # the code sets no other directory
    assert jax.config.jax_compilation_cache_dir == d
