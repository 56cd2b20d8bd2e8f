"""Package configuration: x64 on import, and where the persistent
compilation cache goes."""

import os
import subprocess
import sys

import jax
import pytest

from pymes_jax import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_fresh_process(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, pymes_jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_defaults_to_the_checkout():
    assert config.CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    assert _cache_dir_in_fresh_process(None) == config.CACHE_DIR


def test_cache_dir_env_var_wins(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_fresh_process(want) == want


def test_checkout_cache_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_x64_on_after_import():
    assert config.x64_enabled()
    assert jax.numpy.zeros(1).dtype == jax.numpy.float64


@pytest.mark.parametrize("explicit,expect", [(1e9, 1e9), (1.0, 1.0)])
def test_krylov_budget_explicit_wins(explicit, expect):
    from pymes_jax.solver.feast_eom_ccsd import _krylov_budget_bytes
    assert _krylov_budget_bytes(explicit) == expect


def test_krylov_budget_from_device_limit(monkeypatch):
    from pymes_jax.solver import feast_eom_ccsd as fe

    class Dev:
        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    monkeypatch.setattr(fe.jax, "devices", lambda: [Dev({"bytes_limit": 8e10})])
    assert fe._krylov_budget_bytes(None) == 2e10
    monkeypatch.setattr(fe.jax, "devices", lambda: [Dev(None)])
    assert fe._krylov_budget_bytes(None) == float("inf")
