"""Benchmark model-family tests (BASELINE configs 1-5 at reduced size)."""

import numpy as np
import pytest

from grape_tpu import optimize_problem, optimize
from grape_tpu.models import (
    tls_problem, transmon_ensemble_trajectories, transmon_qutrit_problem,
    two_transmon_cz_problem,
)
from grape_tpu.functionals import J_T_sm


def test_tls_problem():
    """BASELINE config 1 (README two-level)."""
    problem = tls_problem(
        J_T=J_T_sm, iter_stop=5, print_iters=False, rethrow_exceptions=True
    )
    res = optimize_problem(problem)
    assert res.J_T < 1e-3
    assert 0.75 < np.max(np.abs(res.optimized_controls[0])) < 0.85


def test_transmon_qutrit_guard_penalty():
    """BASELINE config 3: qutrit X gate; the guard-level running cost
    suppresses the peak guard-level population relative to the unpenalized
    optimization (measured by re-propagating under the optimized pulses,
    the reference's STIRAP methodology)."""
    from grape_tpu import get_controls, propagate, substitute

    problem = transmon_qutrit_problem(
        n_steps=100, T=10.0, iter_stop=100, print_iters=False,
        rethrow_exceptions=True,
    )

    def guard_pop(res):
        H = problem.trajectories[0].generator
        H_opt = substitute(
            H, list(zip(get_controls(H), res.optimized_controls))
        )
        dyn = propagate(
            problem.trajectories[0].initial_state, H_opt, problem.tlist,
            storage=True,
        )
        return float(np.max(np.abs(dyn[:, 2:]) ** 2))

    res_free = optimize_problem(
        problem, lambda_b=0.0,
        check_convergence=lambda r: bool(r.J_T < 1e-3),
    )
    res_pen = optimize_problem(
        problem, lambda_b=1.0,
        check_convergence=lambda r: bool(r.J_T < 1e-3 and r.J_b < 1e-3),
    )
    assert res_free.J_T < 1e-3
    assert res_pen.J_T < 5e-2
    assert guard_pop(res_pen) < guard_pop(res_free)


def test_two_transmon_cz_small():
    """BASELINE config 4 at reduced size (d=4 -> dim=16, 200 steps)."""
    problem = two_transmon_cz_problem(
        d=4, J=0.15, n_steps=300, T=30.0, E0=0.1, iter_stop=60,
        print_iters=False, rethrow_exceptions=True,
        check_convergence=lambda r: bool(r.J_T < 1e-2),
    )
    res = optimize_problem(problem)
    assert res.converged
    assert res.J_T < 1e-2


def test_ensemble_trajectories_share_controls():
    trajs = transmon_ensemble_trajectories(4, d=3)
    from grape_tpu import get_controls

    controls = get_controls([t.generator for t in trajs])
    assert len(controls) == 2  # x and y drives shared across all samples


def test_graft_entry():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    fn, args = g.entry()
    J, grad, aux = fn(*args)
    assert np.isfinite(float(J))
    assert np.isfinite(np.linalg.norm(np.asarray(grad)))
    g.dryrun_multichip(8)


def test_two_transmon_subspace_gate_problem():
    """Fat-batch gate synthesis: K = n_basis basis states under ONE
    shared generator toward a seeded random subspace unitary, here at
    reduced size."""
    from grape_tpu.models import two_transmon_subspace_gate_problem
    from grape_tpu.fg import compile_problem

    problem = two_transmon_subspace_gate_problem(
        d=3, n_basis=6, n_steps=50, T=10.0, E0=0.2, J=0.3,
    )
    cp = compile_problem(problem.trajectories, problem.tlist,
                         **problem.kwargs)
    assert cp.shared_generator and cp.n_traj == 6 and cp.dim == 9
    # targets are the unitary image of the basis: orthonormal columns
    targets = np.stack([t.target_state for t in problem.trajectories])
    np.testing.assert_allclose(
        targets.conj() @ targets.T, np.eye(6), atol=1e-12
    )
    # seeded: same problem twice -> identical targets
    problem2 = two_transmon_subspace_gate_problem(
        d=3, n_basis=6, n_steps=50, T=10.0, E0=0.2, J=0.3,
    )
    targets2 = np.stack([t.target_state for t in problem2.trajectories])
    np.testing.assert_allclose(targets, targets2, atol=0)
    Js = []
    res = optimize_problem(
        problem, iter_stop=30, print_iters=False, rethrow_exceptions=True,
        callback=lambda wrk, it: Js.append(wrk.result.J_T),
    )
    assert res.iter >= 10 and res.J_T < 0.35 * Js[0]


def test_tls_xgate_problem():
    """BASELINE config 2: TLS X-gate over the tomography-complete basis
    {|0>, |1>, |+>, |+i>} with a fluence running cost; shared-generator
    gate path (K=4, one H)."""
    from grape_tpu.models import tls_xgate_problem
    from grape_tpu.fg import compile_problem

    problem = tls_xgate_problem(iter_stop=20)
    cp = compile_problem(problem.trajectories, problem.tlist,
                         **problem.kwargs)
    assert cp.shared_generator and cp.n_traj == 4 and cp.n_controls == 2
    res = optimize_problem(
        problem, print_iters=False, rethrow_exceptions=True,
        check_convergence=lambda r: bool(r.J_T < 1e-4),
    )
    assert res.converged
    assert res.J_T < 1e-3
    assert res.J_a > 0.0  # fluence cost active
    # gate realized up to global phase: check the propagated basis
    from grape_tpu import get_controls, propagate, substitute

    H = problem.trajectories[0].generator
    H_opt = substitute(
        H, list(zip(get_controls(H), res.optimized_controls))
    )
    psis = [
        propagate(t.initial_state, H_opt, problem.tlist)
        for t in problem.trajectories
    ]
    overlaps = [
        np.vdot(t.target_state, psi)
        for t, psi in zip(problem.trajectories, psis)
    ]
    # all overlaps share one global phase, each with |tau| ~ 1
    assert min(abs(o) for o in overlaps) > 0.999
    phases = np.angle(np.asarray(overlaps))
    assert np.ptp((phases - phases[0] + np.pi) % (2 * np.pi)) < 1e-2


def test_two_transmon_cz_ensemble_problem():
    """Robust-CZ ensemble (BASELINE config-5 shape): K = 4·n_samples
    trajectories with DISTINCT generators sharing one 4-control set —
    the per-trajectory-generator regime (reference per-trajectory
    propagators, `/root/reference/src/workspace.jl:221-233`); gradgen
    and taylor agree on the gradient."""
    from grape_tpu.fg import build_fg, compile_problem
    from grape_tpu.models import two_transmon_cz_ensemble_problem

    problem = two_transmon_cz_ensemble_problem(
        n_samples=2, d=4, T=2.0, n_steps=10,
    )
    cp = compile_problem(problem.trajectories, problem.tlist,
                         **problem.kwargs)
    assert cp.n_traj == 8 and cp.dim == 16 and cp.n_controls == 4
    assert not cp.shared_generator and not cp.per_traj_coeffs
    x = cp.guess_pulsevals.reshape(-1)
    J1, g1, _ = build_fg(cp)(x)
    import dataclasses

    cp_t = dataclasses.replace(cp, gradient_method="taylor", env_cache={})
    J2, g2, _ = build_fg(cp_t)(x)
    assert abs(float(J1) - float(J2)) < 1e-10
    assert np.max(np.abs(np.asarray(g1) - np.asarray(g2))) < 1e-10
