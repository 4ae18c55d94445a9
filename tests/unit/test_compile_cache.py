"""Where JAX's persistent compilation cache goes (``utils.py``).

Each case runs a fresh interpreter: the cache directory is read when the
first program compiles, and the test process has its own already.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

_PROBE = r"""
import os, sys
import jax
import jax.numpy as jnp
from pycollo_tpu.utils import configure_compile_cache
used = configure_compile_cache()
jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.arange(7.0)).block_until_ready()
print(used)
print(jax.config.jax_compilation_cache_dir)
print(len(os.listdir(used)) if os.path.isdir(used) else 0)
"""


def _probe(env_cache=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_cache is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_cache
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    used, configured, entries = proc.stdout.strip().splitlines()[-3:]
    return used, configured, int(entries)


def test_env_var_is_honoured(tmp_path):
    cache = str(tmp_path / "cache")
    used, configured, entries = _probe(cache)
    assert used == configured == cache
    assert entries > 0


def test_default_is_fixed_path_in_checkout():
    used, configured, entries = _probe()
    assert used == configured == str(REPO / ".jax_cache")
    assert entries > 0
