"""Persistent compilation cache wiring (utils/cache.py).

Contract: JAX_COMPILATION_CACHE_DIR when set, and no other directory;
otherwise the fixed ``<checkout>/.jax_cache``; HPCCG_NO_COMPILE_CACHE opts
out.
"""

import os

import jax
import pytest

from hpccg_tpu.utils import cache
from hpccg_tpu.utils.cache import enable_compilation_cache


@pytest.fixture
def restore_cache_config():
    """Save/restore the global jax compile-cache config so these tests'
    tmp_path redirections do not leak cache writes into the rest of the
    pytest session."""
    before = getattr(jax.config, "jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_default_is_fixed_dir_in_checkout(tmp_path, monkeypatch, restore_cache_config):
    monkeypatch.delenv("HPCCG_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "xla"))
    got = enable_compilation_cache()
    assert got == str(tmp_path / "xla")
    assert os.path.isdir(got)
    assert jax.config.jax_compilation_cache_dir == got


def test_cache_honors_jax_env_var(tmp_path, monkeypatch, restore_cache_config):
    """A set JAX_COMPILATION_CACHE_DIR wins, and the default directory is
    not created or configured."""
    monkeypatch.delenv("HPCCG_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "default"))
    got = enable_compilation_cache()
    assert got == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == got
    assert not os.path.exists(tmp_path / "default")


def test_cache_opt_out(monkeypatch):
    monkeypatch.setenv("HPCCG_NO_COMPILE_CACHE", "1")
    assert enable_compilation_cache() is None


def test_cli_still_runs_with_cache(tmp_path, monkeypatch, capsys, restore_cache_config):
    """End-to-end: the CLI path that calls enable_compilation_cache still
    solves and reports (cache dir redirected into tmp)."""
    monkeypatch.delenv("HPCCG_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    from hpccg_tpu.cli import main

    rc = main(["8", "8", "8", "--max-iter", "12", "--quiet", "--json"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Final residual" in out
