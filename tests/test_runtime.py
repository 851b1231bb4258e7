"""utils/runtime: where the persistent compilation cache lives."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax; from coxgraph_tpu.utils import runtime; "
         "p = runtime.enable_compilation_cache(); "
         "print(p); print(jax.config.jax_compilation_cache_dir); "
         "print(jax.config.jax_persistent_cache_min_compile_time_secs)")


@pytest.mark.parametrize("env_dir", [True, False],
                         ids=["env_set", "env_unset"])
def test_compilation_cache_dir(env_dir, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
        want = str(tmp_path / "cache")
    else:
        want = os.path.join(ROOT, ".jax_cache")
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    returned, configured, threshold = p.stdout.split()[-3:]
    assert returned == configured == want
    assert float(threshold) == 0.0
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
