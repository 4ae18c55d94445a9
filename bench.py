"""Benchmark: batched cart-pole swing-up replanning solves per second.

The workload is MPC-style batched replanning.  The cart-pole swing-up
OCP (Kelly 2017; reference example
``examples/cart_pole_swing_up/cart_pole_swing_up_explicit.py``), built
through the functional frontend, is transcribed on the default mesh
(K=10 sections, n=4 nodes -> N=31) and solved for chunks of instances
whose initial states are perturbed, by the on-device condensed-space
interior-point solver under ``vmap``, to a KKT tolerance of 1e-6.

Measurement: sustained throughput over ``N_CHUNKS`` back-to-back chunks
of ``CHUNK`` fresh instances, after one warm-up chunk that compiles.  A
chunk runs until its LAST instance converges, so the chunk size trades
batch width against the straggler tail.

Solver configuration (``MIXED_OPTIONS``, the scored one):
- ``kkt_precision="mixed"``: the equilibrated condensed matrix is
  factored in f32, and the step is refined against the UNREGULARIZED
  coupled KKT system by right-preconditioned GMRES.
- ``eval_dtype="f32"``: Jacobian/Hessian block assembly in f32; the
  residuals, the J^T lam VJP, the iterate state, and the reported KKT
  error stay f64, so every solve is still certified at 1e-6 in f64.
``F64_OPTIONS`` is the plain f64 configuration at the same tolerance.
``python bench.py <B> block-banded`` scores the structured f64 path.

The benchmark fails unless JAX's default device is a GPU.  It prints
ONE JSON line: ``{"metric": ..., "value": N, "unit": "solves/sec",
"detail": {...}}``; the detail names the device and the card's power
limit, which bounds its clocks.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CHUNK = 256
N_CHUNKS = 4
F64_OPTIONS = dict(tol=1e-6, max_iter=80)
MIXED_OPTIONS = dict(tol=1e-6, max_iter=80, kkt_precision="mixed",
                     dc_floor=1e-7, dense_gmres_iters=12, eval_dtype="f32")


def gpu_report():
    """Fail unless JAX's default device is a GPU.

    Returns ``(device, smi)``: the device as JAX reports it and the
    ``name, power.limit`` lines of ``nvidia-smi``, read by a child
    process that stays off JAX.
    """
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"{Path(sys.argv[0]).name}: needs a GPU; JAX's "
                         f"default device is {devices[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    return device, smi.stdout.strip()


def build_iteration(linear_solver="condensed-cholesky"):
    """The initialised functional cart-pole problem and its first mesh
    iteration (no solver built yet)."""
    sys.path.insert(0, str(REPO / "examples"))
    from cart_pole_swing_up import build_functional_problem

    problem = build_functional_problem()
    problem.settings.console_out_progress = False
    problem.settings.nlp_tolerance = 1e-6
    problem.settings.linear_solver = linear_solver
    problem.initialise()
    return problem, problem.backend.mesh_iterations[0]


def replanning_overrides(batch, seed):
    """Perturbed initial states of one chunk: q1(0) in [-0.25, 0.25],
    q2(0) in [-0.3, 0.3], keyed for ``solve_batched``."""
    rng = np.random.default_rng(seed)
    return {(0, "y", 0, 0): rng.uniform(-0.25, 0.25, batch),
            (0, "y", 1, 0): rng.uniform(-0.3, 0.3, batch)}


def replanning_thetas(it, batch, seed):
    """The ``(batch, n_theta)`` parameter vectors of one chunk."""
    from pycollo_tpu.parallel.batch import make_theta_batch
    return make_theta_batch(it, replanning_overrides(batch, seed))


def main():
    from pycollo_tpu.utils import configure_compile_cache
    configure_compile_cache()
    import jax
    import jax.numpy as jnp

    device, smi = gpu_report()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else CHUNK
    linear_solver = sys.argv[2] if len(sys.argv) > 2 \
        else "condensed-cholesky"
    problem, it = build_iteration(linear_solver)

    from pycollo_tpu.solver.ipm import IPMOptions
    # The structured path is f64 only (see solver/banded.py).
    options = F64_OPTIONS if linear_solver == "block-banded" \
        else MIXED_OPTIONS
    solver = it.build_solver(IPMOptions(**options))

    x0_j = jnp.asarray(np.tile(it.xs_guess, (B, 1)))
    batched = jax.jit(jax.vmap(solver))

    # Warm-up / compile on a chunk not reused in the timed run.
    t0 = time.perf_counter()
    res = batched(x0_j, jnp.asarray(replanning_thetas(it, B, 1000)))
    res.x.block_until_ready()
    compile_time = time.perf_counter() - t0

    chunks = [jnp.asarray(replanning_thetas(it, B, k))
              for k in range(N_CHUNKS)]
    results = []
    t0 = time.perf_counter()
    for th in chunks:
        results.append(batched(x0_j, th))
    results[-1].x.block_until_ready()
    elapsed = time.perf_counter() - t0

    conv = float(np.mean([np.asarray(r.converged).mean() for r in results]))
    iters = float(np.mean([np.asarray(r.iterations).mean()
                           for r in results]))
    kkt99 = float(np.quantile(np.concatenate(
        [np.asarray(r.kkt_error) for r in results]), 0.99))
    solves_per_sec = (N_CHUNKS * B) / elapsed

    print(json.dumps({
        "metric": "batched cart-pole swing-up solves/sec "
                  "(KKT tol 1e-6)",
        "value": solves_per_sec,
        "unit": "solves/sec",
        "detail": {
            "chunk_size": B,
            "n_chunks": N_CHUNKS,
            "total_wall_s": elapsed,
            "compile_s": compile_time,
            "converged_fraction": conv,
            "mean_ipm_iterations": iters,
            "kkt_error_p99": kkt99,
            "linear_solver": linear_solver,
            "ipm_options": options,
            "platform": device["platform"],
            "device_kind": device["kind"],
            "device_count": device["count"],
            "nvidia_smi": smi,
        },
    }))


if __name__ == "__main__":
    main()
