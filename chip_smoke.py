"""Smoke test of pycollo_tpu on one NVIDIA GPU, at the sizes users run.

Run from the root of a checkout::

    python chip_smoke.py              # phases 0-3 on one GPU
    python chip_smoke.py --four-gpus  # batch sharding over four GPUs only

Each phase prints one JSON line; any failed check raises, so the script
exits non-zero.  Without a GPU it fails before printing any result.

0. Device report: JAX's devices and version, x64, the compile cache in
   use, and the card's name and power limit from ``nvidia-smi``.
1. Factorization at the interior-point solver's shapes: the condensed
   KKT solver of ``solver/linalg.py`` in f64 and f32 at (1536, 148, 148)
   (256 instances x 6 inertia levels) against numpy f64, the flagging of
   one indefinite instance, and timings of the plain XLA factorization
   and of two solve spellings.
2. Trajectory design: ``problem.solve()`` with ph-refinement on the
   functional-frontend brachistochrone, against the GPOPS-II objective.
3. Batched replanning at benchmark size: the cart-pole chunks of
   ``bench.py`` in the f64 and the mixed configuration, checked against
   an f64 solve of 8 instances on the CPU backend of the same process.

``--four-gpus`` runs only the sharded path of
``OptimalControlProblem.solve_batched`` at B=1024 over four GPUs, and
the same instances on one GPU as its reference.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "examples"))

import bench  # noqa: E402
from pycollo_tpu.utils import configure_compile_cache  # noqa: E402

CACHE_DIR = configure_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from brachistochrone import build_functional_problem as brachistochrone  # noqa: E402,E501
from pycollo_tpu.solver.ipm import IPMOptions  # noqa: E402
from pycollo_tpu.solver.linalg import make_spd_solver, positive_definite  # noqa: E402,E501

#: condensed KKT size of the benchmark's cart-pole (n + slacks)
N_KKT = 148
#: inertia levels factored per iteration (level 0 + IPMOptions.spec_levels)
LEVELS = 1 + len(IPMOptions().spec_levels)
#: preconditioner applications per step of the mixed path (GMRES + corrector)
SOLVES_PER_STEP = 18
GPOPS_BRACHISTOCHRONE = 0.82434


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields},
                     default=lambda o: o.tolist() if hasattr(o, "tolist")
                     else str(o)), flush=True)


def amortized_seconds(fn, *args, calls=20, samples=5):
    """Median over ``samples`` of the time per call of ``calls``
    back-to-back asynchronous calls (compiled and warmed first)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / calls)
    return statistics.median(times)


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, from its own
    monitoring events."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


# -- phase 0 -------------------------------------------------------------
def device_report():
    device, smi = bench.gpu_report()
    print(smi, flush=True)
    emit("device", devices=[str(d) for d in jax.devices()],
         platform=device["platform"], kind=device["kind"],
         count=device["count"], jax_version=jax.__version__,
         x64=bool(jax.config.jax_enable_x64), compile_cache=CACHE_DIR,
         nvidia_smi=smi)
    return device


# -- phase 1 -------------------------------------------------------------
def equilibrated_spd(rng, batch, n, cond, indefinite):
    """Jacobi-equilibrated random symmetric matrices with eigenvalues
    log-uniform in [1, cond]; instance ``indefinite`` gets one negative
    eigenvalue."""
    Q, _ = np.linalg.qr(rng.standard_normal((batch, n, n)))
    lam = np.exp(rng.uniform(0.0, np.log(cond), (batch, n)))
    lam[:, 0], lam[:, 1] = 1.0, cond
    lam[indefinite, 0] = -1.0
    A = (Q * lam[:, None, :]) @ np.swapaxes(Q, -1, -2)
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    d = 1.0 / np.sqrt(np.abs(np.diagonal(A, axis1=-2, axis2=-1)))
    return A * d[:, :, None] * d[:, None, :]


def check_factorization(batch=LEVELS * bench.CHUNK, n=N_KKT, cond=1e4,
                        seed=0):
    """The stayed solver of ``solver/linalg.py`` against numpy f64."""
    rng = np.random.default_rng(seed)
    bad = 7
    A = equilibrated_spd(rng, batch, n, cond, bad)
    b = rng.standard_normal((batch, n))
    good = np.arange(batch) != bad
    eig = np.linalg.eigvalsh(A[good])
    x_ref = np.linalg.solve(A[good], b[good][..., None])[..., 0]
    factor, diag, invert, solve = make_spd_solver()

    @jax.jit
    def factor_solve(A, b):
        L = factor(A)
        return solve(invert(L), b), positive_definite(diag(L))

    results = {}
    for dtype, tol in ((jnp.float64, 1e-10), (jnp.float32, 1e-3)):
        x, pd = factor_solve(jnp.asarray(A, dtype), jnp.asarray(b, dtype))
        x = np.asarray(x, np.float64)[good]
        pd = np.asarray(pd)
        # Normwise backward error ||A x - b|| / (||A|| ||x|| + ||b||).
        r = np.einsum("bij,bj->bi", A[good], x) - b[good]
        backward = np.linalg.norm(r, axis=-1) / (
            eig.max(-1) * np.linalg.norm(x, axis=-1)
            + np.linalg.norm(b[good], axis=-1))
        forward = np.linalg.norm(x - x_ref, axis=-1) \
            / np.linalg.norm(x_ref, axis=-1)
        name = jnp.dtype(dtype).name
        results[name] = dict(
            precision=name, max_relative_residual=backward.max(),
            residual_tolerance=tol, max_forward_error_vs_numpy=forward.max(),
            indefinite_flagged=not pd[bad],
            spd_flagged=int((~pd[good]).sum()))
        if backward.max() > tol or pd[bad] or not pd[good].all():
            emit("factorization", ok=False, **results[name])
            raise SystemExit(f"factorization check failed in {name}")
    return dict(shape=[batch, n, n], max_condition_number=float(
        (eig.max(-1) / eig.min(-1)).max()), checks=results)


def spd_on_device(key, batch, n, dtype):
    M = jax.random.normal(key, (batch, n, n), dtype)
    return M @ jnp.swapaxes(M, -1, -2) / n + jnp.eye(n, dtype=dtype)


def time_factorization(levels=LEVELS, chunk=bench.CHUNK, n=N_KKT,
                       block_batch=4096, blocks=(16, 32, 48),
                       solves=SOLVES_PER_STEP):
    """Seconds of XLA's plain factorization and of one step's linear
    algebra in two solve spellings, per dtype.

    Both factor the whole (chunk x levels) stack and select one level
    per instance.  ``step_inverse``, the spelling of ``solver/linalg.py``,
    then inverts the selected factors and applies ``solves`` dependent
    solves as two matrix-vector products each.  ``step_cho_solve``
    applies them as ``cho_solve`` substitutions instead.  The f64 path
    solves about 4 times per factorization, the mixed path about 18.
    """
    factor, _, invert, solve = make_spd_solver()

    # Each instance selects one level by a gather, as the solver does,
    # so that XLA cannot drop the other levels' work.
    def select(F, lvl):
        return F.reshape((chunk, levels, n, n))[jnp.arange(chunk), lvl]

    def step_inverse(A, r, lvl, k):
        Linv = invert(select(factor(A), lvl))
        return jax.lax.fori_loop(0, k, lambda _, r: solve(Linv, r), r)

    def step_cho_solve(A, r, lvl, k):
        L = select(factor(A), lvl)
        return jax.lax.fori_loop(
            0, k, lambda _, r: jax.scipy.linalg.cho_solve((L, True), r), r)

    out = {}
    key = jax.random.PRNGKey(0)
    lvl = jnp.zeros(chunk, jnp.int32)
    with jax.default_matmul_precision("highest"):
        for dtype in (jnp.float64, jnp.float32):
            A = spd_on_device(key, chunk * levels, n, dtype)
            r = jax.random.normal(key, (chunk, n), dtype)
            row = {"shape": [chunk * levels, n, n],
                   "cholesky": amortized_seconds(jax.jit(factor), A)}
            for k in (4, solves):
                for name, step in (("step_inverse", step_inverse),
                                   ("step_cho_solve", step_cho_solve)):
                    row[f"{name}_{k}_solves"] = amortized_seconds(
                        jax.jit(step, static_argnums=3), A, r, lvl, k)
            for nb in blocks:
                Ab = spd_on_device(key, block_batch, nb, dtype)
                row[f"cholesky_{block_batch}x{nb}x{nb}"] = \
                    amortized_seconds(jax.jit(factor), Ab)
            out[jnp.dtype(dtype).name] = row
    return out


# -- phase 2 -------------------------------------------------------------
def trajectory_design(clock):
    problem = brachistochrone()
    problem.settings.console_out_progress = False
    c0 = clock.seconds
    t0 = time.perf_counter()
    solution = problem.solve()
    wall = time.perf_counter() - t0
    compile_s = clock.seconds - c0
    err = abs(solution.objective - GPOPS_BRACHISTOCHRONE)
    fields = dict(objective=solution.objective, reference=GPOPS_BRACHISTOCHRONE,
                  abs_error=err, mesh_tolerance_met=problem.mesh_tolerance_met,
                  mesh_iterations=len(problem.backend.mesh_iterations),
                  wall_s=wall, trace_and_compile_s=compile_s,
                  wall_without_compile_s=wall - compile_s)
    ok = err <= 1e-4 and problem.mesh_tolerance_met
    emit("trajectory_design", ok=ok, **fields)
    if not ok:
        raise SystemExit("trajectory-design solve failed")


# -- phase 3 -------------------------------------------------------------
def memory_analysis(compiled):
    mem = compiled.memory_analysis()
    return {k: getattr(mem, k) for k in dir(mem)
            if k.endswith("_in_bytes")} if mem is not None else None


def batched_replanning(clock, chunk=bench.CHUNK, n_chunks=bench.N_CHUNKS,
                       n_ref=8, factor_seconds=None, ref_device=None):
    """Both IPM configurations at benchmark size, checked on the CPU.

    ``n_ref`` instances of the first chunk are solved with the f64
    options on ``ref_device`` (the CPU backend).  The f64 path must
    reach the same objectives.  Both paths' answers are re-certified
    there: the f64 KKT error of each device solution, evaluated on the
    CPU, must meet the tolerance.  The mixed path is not held to the
    CPU objectives: it reaches a neighbouring local minimum of this
    nonconvex NLP on some instances, and which ones changes with
    perturbations of the starting point at the 1e-9 level.
    """
    problem, it = bench.build_iteration()
    ref_device = ref_device or jax.devices("cpu")[0]
    x0 = jnp.asarray(np.tile(it.xs_guess, (chunk, 1)))
    chunks = [jnp.asarray(bench.replanning_thetas(it, chunk, k))
              for k in range(n_chunks)]
    warm = jnp.asarray(bench.replanning_thetas(it, chunk, 1000))
    theta_ref = jax.device_put(np.asarray(chunks[0][:n_ref]), ref_device)

    with jax.default_device(ref_device):
        ref_solver = it.build_solver(IPMOptions(**bench.F64_OPTIONS))
        ref = jax.jit(jax.vmap(ref_solver))(
            jax.device_put(np.asarray(x0[:n_ref]), ref_device), theta_ref)
        f_ref = np.asarray(ref.f) / it.w

        @jax.jit
        @jax.vmap
        def recertify(res, theta):
            v = jnp.concatenate([res.x, res.slack])
            return ref_solver._kkt_error(v, res.lam, res.zl, res.zu, 0.0,
                                         theta)
    if not np.asarray(ref.converged).all():
        raise SystemExit("reference solve did not converge")

    for name, options in (("f64", bench.F64_OPTIONS),
                          ("mixed", bench.MIXED_OPTIONS)):
        solver = it.build_solver(IPMOptions(**options))
        c0 = clock.seconds
        t0 = time.perf_counter()
        compiled = jax.jit(jax.vmap(solver)).lower(x0, warm).compile()
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(compiled(x0, warm))
        t0 = time.perf_counter()
        results = [compiled(x0, th) for th in chunks]
        jax.block_until_ready(results)
        elapsed = time.perf_counter() - t0
        conv = np.concatenate([np.asarray(r.converged) for r in results])
        iters = np.stack([np.asarray(r.iterations) for r in results])
        kkt = np.concatenate([np.asarray(r.kkt_error) for r in results])
        head = jax.device_put(
            jax.tree.map(lambda a: np.asarray(a[:n_ref]), results[0]),
            ref_device)
        kkt_cpu = np.asarray(recertify(head, theta_ref))
        rel = np.abs(np.asarray(head.f) / it.w - f_ref) / np.abs(f_ref)
        # The vmapped while-loop runs until the last instance of a chunk
        # converges: one chunk costs max(iterations) loop trips.
        seconds_per_iteration = elapsed / iters.max(axis=1).sum()
        fields = dict(
            config=name, ipm_options=options, batch=chunk,
            n_chunks=n_chunks, converged_fraction=conv.mean(),
            kkt_error_p99=float(np.quantile(kkt, 0.99)),
            mean_ipm_iterations=iters.mean(), max_ipm_iterations=iters.max(),
            solves_per_s=chunk * n_chunks / elapsed, wall_s=elapsed,
            compile_s=compile_s, trace_and_compile_s=clock.seconds - c0,
            seconds_per_ipm_iteration=seconds_per_iteration,
            memory_analysis=memory_analysis(compiled),
            reference_device=str(ref_device),
            max_kkt_error_recertified_on_reference=kkt_cpu.max(),
            rel_objective_diff_vs_reference_f64=rel,
            instances_at_reference_objective=int((rel <= 1e-6).sum()))
        if factor_seconds is not None:
            dtype = "float32" if name == "mixed" else "float64"
            times = factor_seconds[dtype]
            fields["factorization_share_of_iteration"] = \
                times["cholesky"] / seconds_per_iteration
            k = 4 if name == "f64" else SOLVES_PER_STEP
            for spelling in ("step_inverse", "step_cho_solve"):
                fields[f"{spelling}_share_of_iteration"] = \
                    times[f"{spelling}_{k}_solves"] / seconds_per_iteration
        ok = (conv.mean() == 1.0 and fields["kkt_error_p99"] <= 1e-6
              and kkt_cpu.max() <= 1e-6
              and (name == "mixed" or rel.max() <= 1e-6))
        emit("batched_replanning", ok=ok, **fields)
        if not ok:
            raise SystemExit(f"batched replanning ({name}) failed")


# -- --four-gpus -----------------------------------------------------------
def sharded_replanning(devices, batch=4 * bench.CHUNK, seed=0):
    """``solve_batched`` sharded over ``devices`` against the same
    instances solved chunk by chunk on ``devices[0]`` alone."""
    problem, it = bench.build_iteration()
    solver = it.build_solver(IPMOptions(**bench.F64_OPTIONS))
    overrides = bench.replanning_overrides(batch, seed)
    t0 = time.perf_counter()
    sharded = problem.solve_batched(overrides, devices=devices)
    sharded_s = time.perf_counter() - t0

    from pycollo_tpu.parallel.batch import make_theta_batch
    theta = make_theta_batch(it, overrides)
    per = batch // len(devices)
    one = jax.jit(jax.vmap(solver))
    assemble = jax.jit(jax.vmap(it.assemble_full))
    x0 = jax.device_put(np.tile(it.xs_guess, (per, 1)), devices[0])
    t0 = time.perf_counter()
    x_ref = []
    for k in range(len(devices)):
        th = jax.device_put(theta[k * per:(k + 1) * per], devices[0])
        x_ref.append(np.asarray(assemble(one(x0, th).x, th)))
    single_s = time.perf_counter() - t0
    dx = float(np.max(np.abs(sharded.x_full - np.concatenate(x_ref))))
    fields = dict(batch=batch, devices=[str(d) for d in devices],
                  converged_fraction=sharded.converged.mean(),
                  max_abs_dx_vs_one_device=dx, tolerance=1e-8,
                  sharded_wall_s_with_compile=sharded_s,
                  one_device_wall_s_with_compile=single_s)
    ok = dx <= 1e-8 and sharded.converged.all()
    emit("sharded_replanning", ok=ok, **fields)
    if not ok:
        raise SystemExit("sharded replanning failed")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-gpus", action="store_true",
                        help="run only the batch-sharded path on 4 GPUs")
    args = parser.parse_args(argv)
    device = device_report()
    clock = CompileClock()
    if args.four_gpus:
        if device["count"] < 4:
            raise SystemExit(f"--four-gpus needs 4 GPUs, have "
                             f"{device['count']}")
        sharded_replanning(jax.devices()[:4])
    else:
        checks = check_factorization()
        timings = time_factorization()
        emit("factorization", ok=True, seconds=timings, **checks)
        trajectory_design(clock)
        batched_replanning(clock, factor_seconds=timings)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
