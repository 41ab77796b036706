"""Checkpoint/recompute storage mode: O(sqrt(N_T)) memory with gradients
identical to full storage."""

import numpy as np
import jax.numpy as jnp
import pytest

from grape_tpu import Trajectory, hamiltonian, optimize
from grape_tpu.fg import build_fg, compile_problem, _pick_segments
from grape_tpu.functionals import J_T_sm, J_T_re
from grape_tpu.shapes import flattop


def _tls(n_steps=100):
    def eps(t):
        return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))

    sz = np.array([[1, 0], [0, -1]], dtype=complex)
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    H = hamiltonian(-0.5 * sz, (sx, eps))
    tlist = np.linspace(0, 5, n_steps + 1)
    return [Trajectory([1, 0], H, target_state=[0, 1])], tlist


def test_pick_segments():
    assert _pick_segments("full", None, 100) == 0
    assert _pick_segments("recompute", None, 100) == 10
    assert _pick_segments("recompute", 25, 100) == 25
    assert _pick_segments("recompute", None, 2000) in (40, 50)
    with pytest.raises(ValueError, match="divide"):
        _pick_segments("recompute", 7, 100)


def test_recompute_matches_full():
    trajs, tlist = _tls(100)
    x = None
    results = {}
    for mode in ("full", "recompute"):
        cp = compile_problem(
            trajs, tlist, J_T=J_T_sm, storage_mode=mode,
        )
        fg = build_fg(cp)
        if x is None:
            x = cp.guess_pulsevals.reshape(-1)
        J, g, aux = fg(x)
        results[mode] = (float(J), np.asarray(g))
    assert abs(results["full"][0] - results["recompute"][0]) < 1e-14
    assert np.linalg.norm(
        results["full"][1] - results["recompute"][1]
    ) < 1e-13


def test_recompute_with_state_cost():
    """J_b (inline trapezoid) and the xi inhomogeneity agree between modes."""
    trajs, tlist = _tls(100)
    D = jnp.asarray(np.diag([0.0, 1.0]).astype(complex))

    def g_b(Psi, trajectories, tl, n):
        return jnp.real(jnp.einsum("ki,ij,kj->k", jnp.conj(Psi), D, Psi))

    results = {}
    for mode in ("full", "recompute"):
        cp = compile_problem(
            trajs, tlist, J_T=J_T_re, g_b=g_b, lambda_b=0.3,
            storage_mode=mode,
        )
        fg = build_fg(cp)
        x = cp.guess_pulsevals.reshape(-1)
        J, g, aux = fg(x)
        results[mode] = (
            float(J), np.asarray(g), np.asarray(aux["J_parts"]),
        )
    assert abs(results["full"][0] - results["recompute"][0]) < 1e-13
    assert np.allclose(results["full"][2], results["recompute"][2])
    assert np.linalg.norm(
        results["full"][1] - results["recompute"][1]
    ) < 1e-12


def test_recompute_optimization():
    """Full optimization under recompute mode hits the TLS anchors."""
    trajs, tlist = _tls(500)
    res = optimize(
        trajs, tlist, iter_stop=5, J_T=J_T_sm, storage_mode="recompute",
        rethrow_exceptions=True, print_iters=False,
    )
    assert res.J_T < 1e-3
    assert 0.75 < np.max(np.abs(res.optimized_controls[0])) < 0.85


def _tiny_ensemble(n_samples=2, d=3, n_steps=60, T=10.0):
    """Grouped per-trajectory-generator ensemble (each sample's 4 basis
    states share one H; samples differ): the BASELINE config-5 shape at
    test size."""
    from grape_tpu.models import two_transmon_cz_ensemble_problem

    problem = two_transmon_cz_ensemble_problem(
        n_samples=n_samples, d=d, n_steps=n_steps, T=T,
    )
    return problem


@pytest.mark.parametrize("method", ["taylor", "gradgen"])
def test_recompute_vectorized_matches_full_ensemble(method):
    """Segment-vectorized recompute backward: per-trajectory grouped generators, taylor AND gradgen,
    recompute == full to f64 accuracy.  Also asserts the vectorized path
    is actually selected (not the per-step scan fallback)."""
    from grape_tpu.fg import (
        _vec_gradgen_enabled, _vectorized_taylor_orders,
    )

    problem = _tiny_ensemble()
    results = {}
    for mode in ("full", "recompute"):
        cp = compile_problem(
            problem.trajectories, problem.tlist, gradient_method=method,
            storage_mode=mode, **problem.kwargs,
        )
        if mode == "recompute":
            assert cp.storage_segments > 1
            if method == "gradgen":
                assert _vec_gradgen_enabled(cp)
            else:
                assert _vectorized_taylor_orders(cp) is not None
        fg = build_fg(cp)
        x = cp.guess_pulsevals.reshape(-1)
        J, g, aux = fg(x)
        results[mode] = (float(J), np.asarray(g))
    J_full, g_full = results["full"]
    J_rec, g_rec = results["recompute"]
    assert abs(J_full - J_rec) < 1e-13 * max(1.0, abs(J_full))
    scale = max(np.max(np.abs(g_full)), 1e-12)
    assert np.max(np.abs(g_full - g_rec)) < 1e-11 * scale


def test_recompute_gradgen_matches_taylor():
    """Cross-method agreement inside recompute mode (the reference's
    gradgen-vs-taylor 1e-10 anchor,
    /root/reference/test/test_tls_optimization.jl:229)."""
    problem = _tiny_ensemble()
    grads = {}
    for method in ("taylor", "gradgen"):
        cp = compile_problem(
            problem.trajectories, problem.tlist, gradient_method=method,
            storage_mode="recompute", **problem.kwargs,
        )
        fg = build_fg(cp)
        x = cp.guess_pulsevals.reshape(-1)
        _, g, _ = fg(x)
        grads[method] = np.asarray(g)
    scale = max(np.max(np.abs(grads["taylor"])), 1e-12)
    assert np.max(np.abs(grads["taylor"] - grads["gradgen"])) < 1e-9 * scale


def test_recompute_pertraj_segment_window():
    """The segment-vectorized gradgen backward of a per-trajectory
    ensemble in complex64 (each invocation's window is one segment)
    matches an independent reference: the full-storage taylor gradient
    in complex128."""
    from grape_tpu.fg import _vec_gradgen_enabled

    problem = _tiny_ensemble(n_samples=2, d=4, n_steps=36, T=6.0)
    cp = compile_problem(
        problem.trajectories, problem.tlist, gradient_method="gradgen",
        storage_mode="recompute", dtype=np.complex64, **problem.kwargs,
    )
    assert cp.storage_segments > 1 and _vec_gradgen_enabled(cp)
    x = cp.guess_pulsevals.reshape(-1)
    J1, g1, _ = build_fg(cp)(x)

    cp_ref = compile_problem(
        problem.trajectories, problem.tlist, gradient_method="taylor",
        dtype=np.complex128, **problem.kwargs,
    )
    Jx, gx, _ = build_fg(cp_ref)(x)
    g1, gx = np.asarray(g1), np.asarray(gx)
    scale = max(np.max(np.abs(gx)), 1e-12)
    assert abs(float(J1) - float(Jx)) < 1e-4 * max(1.0, abs(float(Jx)))
    assert np.max(np.abs(g1 - gx)) < 2e-3 * scale


def test_grouped_xla_forward_step_matches_ungrouped():
    """The grouped ExpProp forward step (one expm per generator GROUP,
    round 5) is exact: an ensemble whose samples share generator objects
    (grouped) matches the same physics built with per-trajectory
    generator copies (ungrouped), both storage modes."""
    from grape_tpu import Trajectory, hamiltonian
    from grape_tpu.fg import _effective_group_size

    problem = _tiny_ensemble()
    cp_g = compile_problem(
        problem.trajectories, problem.tlist, gradient_method="gradgen",
        **problem.kwargs,
    )
    assert _effective_group_size(cp_g) == 4

    # per-trajectory generator COPIES: same arrays, distinct objects ->
    # grouping disabled (identity-run detection)
    trajs_u = [
        Trajectory(
            t.initial_state,
            hamiltonian(t.generator.drift, *t.generator.terms),
            target_state=t.target_state,
        )
        for t in problem.trajectories
    ]
    cp_u = compile_problem(
        trajs_u, problem.tlist, gradient_method="gradgen",
        **problem.kwargs,
    )
    assert _effective_group_size(cp_u) == 1

    x = cp_g.guess_pulsevals.reshape(-1)
    for mode_g, mode_u in (("full", "full"), ("recompute", "recompute")):
        import dataclasses

        cpg = dataclasses.replace(cp_g) if mode_g == "full" else (
            compile_problem(
                problem.trajectories, problem.tlist,
                gradient_method="gradgen", storage_mode="recompute",
                **problem.kwargs,
            )
        )
        cpu_ = cp_u if mode_u == "full" else compile_problem(
            trajs_u, problem.tlist, gradient_method="gradgen",
            storage_mode="recompute", **problem.kwargs,
        )
        Jg, gg, _ = build_fg(cpg)(x)
        Ju, gu, _ = build_fg(cpu_)(x)
        gg, gu = np.asarray(gg), np.asarray(gu)
        scale = max(np.max(np.abs(gu)), 1e-12)
        assert abs(float(Jg) - float(Ju)) < 1e-13 * max(1.0, abs(float(Ju)))
        assert np.max(np.abs(gg - gu)) < 1e-11 * scale


def test_grouped_operator_storage_layout():
    """Identity-run generator groups store ONE operator entry per group
    (round 5: the per-trajectory stack at the 1024-sample config-5
    letter is 1.6 GB of embedded constants); content-equal but
    object-distinct generators keep per-trajectory storage (legacy
    sliced-group access)."""
    from grape_tpu import Trajectory, hamiltonian

    problem = _tiny_ensemble(n_samples=3)
    cp = compile_problem(
        problem.trajectories, problem.tlist, **problem.kwargs,
    )
    assert cp.ops_grouped
    assert cp.gen_group_size == 4
    assert cp.H0.shape[0] == 3        # one entry per sample
    assert cp.ops.shape[0] == 3
    assert cp.n_traj == 12

    # distinct generator objects with equal content: per-traj storage
    trajs_u = [
        Trajectory(
            t.initial_state,
            hamiltonian(t.generator.drift, *t.generator.terms),
            target_state=t.target_state,
        )
        for t in problem.trajectories
    ]
    cp_u = compile_problem(trajs_u, problem.tlist, **problem.kwargs)
    assert not cp_u.ops_grouped
    assert cp_u.H0.shape[0] == 12


def test_multicall_fg_matches_single_call():
    """build_fg_multicall (one forward + n backward-block device calls
    with a device-resident χ carry, bounding each execution's length) is
    the SAME math as build_fg: J, gradient, and aux agree exactly."""
    from grape_tpu.fg import build_fg_multicall

    problem = _tiny_ensemble(n_samples=2, d=3, n_steps=60, T=10.0)
    cp = compile_problem(
        problem.trajectories, problem.tlist, gradient_method="gradgen",
        storage_mode="recompute", **problem.kwargs,
    )
    x = cp.guess_pulsevals.reshape(-1)
    J1, g1, aux1 = build_fg(cp)(x)
    fg_mc = build_fg_multicall(cp, n_calls=3)  # S=10 -> 5 blocks of 2? 10%3!=0 -> n_calls grows to 5
    J2, g2, aux2 = fg_mc(x)
    assert abs(float(J1) - J2) < 1e-13 * max(1.0, abs(float(J1)))
    g1 = np.asarray(g1)
    scale = max(np.max(np.abs(g1)), 1e-12)
    assert np.max(np.abs(g1 - g2)) < 1e-12 * scale
    np.testing.assert_allclose(
        np.asarray(aux1["J_parts"]), aux2["J_parts"], atol=1e-14
    )
    assert bool(aux2["chi_ok"]) and bool(aux2["taylor_ok"])

    # taylor flavor
    cp_t = compile_problem(
        problem.trajectories, problem.tlist, gradient_method="taylor",
        storage_mode="recompute", **problem.kwargs,
    )
    J3, g3, _ = build_fg(cp_t)(x)
    J4, g4, _ = build_fg_multicall(cp_t, n_calls=2)(x)
    assert abs(float(J3) - J4) < 1e-13 * max(1.0, abs(float(J3)))
    assert np.max(np.abs(np.asarray(g3) - g4)) < 1e-12 * scale
