"""The one backend decision (backend.py) and the compile-cache placement
(utils/jaxcache.py)."""

import os

import jax
import pytest

from mit_driverless_cv_traininginfra import backend
from mit_driverless_cv_traininginfra.utils import jaxcache


def test_accelerator_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.accelerator()


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_mixed_precision_auto_follows_platform(monkeypatch, platform, want):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert backend.mixed_precision("auto") is want


@pytest.mark.parametrize("setting", [True, False])
def test_mixed_precision_explicit_passes_through(monkeypatch, setting):
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert backend.mixed_precision(setting) is setting


def test_mixed_precision_rejects_other_values():
    with pytest.raises(ValueError):
        backend.mixed_precision("bf16")


@pytest.fixture
def restore_cache_config():
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path,
                                    restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.cache_dir() == str(tmp_path)
    assert jaxcache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed_path_in_checkout(
        monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert jaxcache.cache_dir() == want == jaxcache.DEFAULT_DIR
    assert jaxcache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
