"""Driver-level sharded optimization on the 8-device virtual CPU mesh.

The reference runs its ENTIRE optimization loop under trajectory
parallelism (``@threadsif`` around both hot loops,
``/root/reference/src/optimize.jl:720,876``, with the serial ``Σ_k``
reduction at ``:574-584``).  The JAX counterpart is
``optimize(..., mesh=...)``: the full L-BFGS-B loop (callbacks, info
table, convergence protocol) driven by the psum-reduced sharded fg
program.  The sharded J_T trace must reproduce the single-device trace
exactly (agreement to 1e-12)."""

import numpy as np
import jax
import pytest

from grape_tpu import Trajectory, hamiltonian, optimize
from grape_tpu.functionals import J_T_sm
from grape_tpu.parallel import (
    make_host_chip_mesh, make_mesh, traj_axes,
)
from grape_tpu.shapes import flattop


def _ensemble_problem(K=8, n_steps=100):
    def eps(t):
        return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))

    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    gens = [hamiltonian(-0.5 * sz, (sx, eps))]
    shared_eps = gens[0].terms[0][1]
    gens = [
        hamiltonian(-0.5 * (1.0 + 0.01 * k) * sz, (sx, shared_eps))
        for k in range(K)
    ]
    trajs = [
        Trajectory([1, 0], g, target_state=[0, 1]) for g in gens
    ]
    tlist = np.linspace(0, 5, n_steps + 1)
    return trajs, tlist


def _trace_cb(store):
    def cb(wrk, iteration):
        store.append(wrk.result.J_T)

    return cb


@pytest.mark.parametrize("gradient_method", ["gradgen", "taylor"])
def test_sharded_optimize_matches_single_device(gradient_method):
    """optimize(mesh=...) through the public API: J_T trace ≡ the
    single-device trace to 1e-12 (the psum reduction is associative over
    the same f64 addition order XLA uses unsharded at K=8/8 devices)."""
    assert len(jax.devices()) >= 8
    trajs, tlist = _ensemble_problem(K=8)
    kwargs = dict(
        iter_stop=5, J_T=J_T_sm, gradient_method=gradient_method,
        print_iters=False, rethrow_exceptions=True,
    )
    trace_single, trace_sharded = [], []
    res1 = optimize(
        trajs, tlist, callback=_trace_cb(trace_single), **kwargs
    )
    mesh = make_mesh(8)
    res2 = optimize(
        trajs, tlist, mesh=mesh, callback=_trace_cb(trace_sharded), **kwargs
    )
    assert res1.J_T < 1e-2 and res2.J_T < 1e-2
    assert len(trace_single) == len(trace_sharded)
    np.testing.assert_allclose(
        trace_sharded, trace_single, rtol=0, atol=1e-12
    )
    for c1, c2 in zip(res1.optimized_controls, res2.optimized_controls):
        np.testing.assert_allclose(c2, c1, rtol=0, atol=1e-10)


def test_sharded_optimize_host_chip_mesh():
    """The 2D (host, chip) mesh path: on a single host this is a (1, 8)
    mesh with the trajectory axis sharded over both axes."""
    trajs, tlist = _ensemble_problem(K=8)
    mesh = make_host_chip_mesh(n_hosts=1, devices=jax.devices()[:8])
    assert mesh.axis_names == ("host", "chip")
    assert traj_axes(mesh) == ("host", "chip")
    trace = []
    res = optimize(
        trajs, tlist, mesh=mesh, iter_stop=5, J_T=J_T_sm,
        callback=_trace_cb(trace), print_iters=False,
        rethrow_exceptions=True,
    )
    assert res.J_T < 1e-2
    assert len(trace) == 6  # iter 0 + 5 iterations


def test_sharded_optimize_with_bounds_and_running_cost():
    """Sharded driver composes with box bounds and a pulse running cost."""
    from grape_tpu.functionals import J_a_fluence

    trajs, tlist = _ensemble_problem(K=8)
    mesh = make_mesh(8)
    res = optimize(
        trajs, tlist, mesh=mesh, iter_stop=8, J_T=J_T_sm,
        J_a=J_a_fluence, lambda_a=1e-4,
        lower_bound=-0.7, upper_bound=0.7,
        print_iters=False, rethrow_exceptions=True,
    )
    assert res.J_T < 1e-2
    assert max(np.max(np.abs(c)) for c in res.optimized_controls) <= 0.700001


def test_weak_scaling_efficiency_virtual():
    """Weak scaling on the virtual mesh: K=8 over 8 devices runs the same
    per-device work as K=1 on one device; the wall-clock ratio is the
    scaling efficiency.  On the virtual CPU mesh all 'devices' share the
    machine, so this only smoke-checks the measurement helper."""
    from grape_tpu.parallel.scaling import measure_weak_scaling

    table = measure_weak_scaling(
        n_devices_list=[1, 2], traj_per_device=2, dim=2, n_steps=20
    )
    assert set(table[0]) >= {"n_devices", "steps_per_s", "efficiency"}
    assert table[0]["efficiency"] == 1.0


def test_sharded_gate_problem_shared_generator():
    """Gate problems (shared generator) under the sharded driver: the
    operator arrays are REPLICATED (every device slices H0[0] locally)
    while psi0/trajectory data shards; the result matches single-device.
    Reference anchor: the `@threadsif` trajectory parallelism over gate
    basis states (`/root/reference/src/optimize.jl:720,876` with the
    CNOT gate setup of `test/test_lbfgsb_saddle_point.jl:40-47`)."""
    from grape_tpu.fg import compile_problem
    from grape_tpu.models import tls_xgate_problem

    problem = tls_xgate_problem(n_steps=100, iter_stop=5)
    cp = compile_problem(problem.trajectories, problem.tlist,
                         **problem.kwargs)
    assert cp.shared_generator
    from grape_tpu import optimize_problem

    res1 = optimize_problem(problem, print_iters=False,
                            rethrow_exceptions=True)
    mesh = make_mesh(4)  # K=4 basis states over 4 devices
    from grape_tpu.parallel import shard_problem

    cp_sh = shard_problem(cp, mesh)
    # operators replicated, states sharded
    assert len(set(s.device for s in cp_sh.psi0.addressable_shards)) == 4
    assert cp_sh.H0.sharding.is_fully_replicated
    res2 = optimize_problem(problem, mesh=mesh, print_iters=False,
                            rethrow_exceptions=True)
    assert abs(res1.J_T - res2.J_T) < 1e-12
    for c1, c2 in zip(res1.optimized_controls, res2.optimized_controls):
        np.testing.assert_allclose(c2, c1, rtol=0, atol=1e-10)
