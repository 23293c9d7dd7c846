"""chip_smoke.py refuses to run without a GPU, and the compile cache
honours JAX_COMPILATION_CACHE_DIR."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )


def _prints_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except ValueError:
        return False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """On the CPU, and in a directory holding nothing else of the repo,
    the smoke test exits non-zero and prints no result line."""
    script = SMOKE
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
    r = _run_smoke(str(tmp_path) if alone else ROOT, script)
    assert r.returncode != 0
    assert not _prints_result(r.stdout)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    from indy7_mpc.utils import cache

    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_default_is_in_checkout(monkeypatch):
    from indy7_mpc.utils import cache

    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.cache_dir() == os.path.abspath(
        os.path.join(ROOT, ".jax_cache")
    )
