"""Multi-device batched solving tests on the virtual 8-device CPU mesh.

The on-device analogue of the reference's (nonexistent) distributed
layer: batched instances shard across a ``jax.sharding.Mesh`` and all
converge to per-instance solutions (SURVEY.md section 2 "absent" rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture(scope="module")
def compiled_cart_pole():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent.parent.parent / "examples"))
    from cart_pole_swing_up import build_problem
    problem = build_problem()
    problem.settings.console_out_progress = False
    problem.initialise()
    return problem.backend


def test_batched_solve_perturbed_instances(compiled_cart_pole):
    """Perturbed initial angles solve in one vmapped call with distinct
    objectives."""
    from pycollo_tpu.parallel.batch import solve_batched
    from pycollo_tpu.solver.ipm import IPMOptions

    it = compiled_cart_pole.mesh_iterations[-1]
    B = 8
    pl = it.layout.phases[0]
    q2_0 = np.linspace(-0.2, 0.2, B)
    result = solve_batched(
        compiled_cart_pole,
        overrides={(0, "y", 1, 0): q2_0},
        options=IPMOptions(tol=1e-6, max_iter=60))
    assert result.converged.all()
    # Objectives vary smoothly and are symmetric-ish around q2_0 = 0.
    assert result.objective.std() > 1e-3
    assert np.all(result.objective > 0)
    # The pinned initial angle is reproduced in each instance's solution.
    q2_col = pl.y_off + 1 * pl.N
    np.testing.assert_allclose(result.x_full[:, q2_col], q2_0, atol=1e-12)


def test_sharded_solve_across_devices(compiled_cart_pole):
    """The batch axis shards over all 8 virtual devices and matches the
    single-device result."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from pycollo_tpu.solver.ipm import IPMOptions

    devices = jax.devices()
    assert len(devices) == 8, "conftest must provide 8 virtual devices"
    it = compiled_cart_pole.mesh_iterations[-1]
    if it._solver is None:
        it.build_solver(IPMOptions(tol=1e-6, max_iter=60))
    solver = it._solver
    B = 16
    x0 = jnp.tile(jnp.asarray(it.xs_guess), (B, 1))
    theta = np.tile(it.theta_default, (B, 1))
    pl = it.layout.phases[0]
    theta[:, pl.y_off] = np.linspace(-0.1, 0.1, B)
    theta = jnp.asarray(theta)

    batched = jax.jit(jax.vmap(solver))
    res_local = batched(x0, theta)

    mesh = Mesh(np.asarray(devices), ("batch",))
    sharding = NamedSharding(mesh, P("batch"))
    x0_s = jax.device_put(x0, sharding)
    theta_s = jax.device_put(theta, sharding)
    res_sharded = batched(x0_s, theta_s)
    assert bool(res_sharded.converged.all())
    np.testing.assert_allclose(np.asarray(res_sharded.f),
                               np.asarray(res_local.f), rtol=1e-8)


def test_scaling_efficiency_harness(compiled_cart_pole):
    """The weak-scaling harness runs and reports a sane efficiency."""
    from pycollo_tpu.parallel.scaling import measure_scaling_efficiency
    from pycollo_tpu.solver.ipm import IPMOptions

    it = compiled_cart_pole.mesh_iterations[-1]
    result = measure_scaling_efficiency(
        it, per_device_batch=4, n_rep=1,
        options=IPMOptions(tol=1e-6, max_iter=60))
    assert result.n_devices == 8
    assert result.all_devices_solves_per_sec > 0
    # Virtual CPU devices share cores, so only sanity-check the range.
    assert 0.0 < result.efficiency <= 1.5
