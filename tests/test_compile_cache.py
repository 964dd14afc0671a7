"""Placement of the persistent compilation cache, each case in a fresh
process: JAX_COMPILATION_CACHE_DIR is honoured, the default is one fixed
directory inside the checkout, and the CPU backend gets no default."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import json, sys
import jax
if sys.argv[1] == "gpu":  # stand-in for a GPU backend
    jax.default_backend = lambda: "gpu"
import brisk_tpu
got = brisk_tpu.enable_persistent_cache()
print(json.dumps(dict(
    returned=got, again=brisk_tpu.enable_persistent_cache(),
    config=jax.config.jax_compilation_cache_dir,
    default=brisk_tpu.CACHE_DIR,
    min_secs=jax.config.jax_persistent_cache_min_compile_time_secs)))
"""


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("with_env", [False, True])
def test_cache_placement(backend, with_env, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env_dir = str(tmp_path / "jcache")
    if with_env:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", PROBE, backend], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["default"] == os.path.join(ROOT, ".jax_cache")
    assert got["again"] == got["returned"]
    if with_env:  # JAX's own setting wins; the code sets no other dir
        assert got["returned"] == env_dir
        assert got["config"] == env_dir
    elif backend == "gpu":
        assert got["returned"] == got["config"] == got["default"]
    else:
        assert got["returned"] is None
        assert got["config"] is None
    assert got["min_secs"] == (0.0 if backend == "gpu" else 1.0)
