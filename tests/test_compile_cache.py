"""Where enable_compilation_cache() puts JAX's persistent cache, checked
in fresh processes (the settings are process-wide)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import json, jax, ezpz_jax; d = ezpz_jax.enable_compilation_cache(); "
         "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))")


def _probe(cwd, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **env_over)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_var_is_used_verbatim(tmp_path):
    want = str(tmp_path / "x")
    returned, configured = _probe(str(tmp_path),
                                  JAX_COMPILATION_CACHE_DIR=want)
    assert returned == configured == want


def test_default_is_fixed_and_inside_the_checkout(tmp_path):
    first = _probe(str(tmp_path), HOME=str(tmp_path))
    second = _probe(ROOT, HOME=str(tmp_path / "elsewhere"))
    assert first == second
    returned, configured = first
    assert returned == configured
    assert configured.startswith(os.path.join(ROOT, ".jax_cache") + os.sep)
