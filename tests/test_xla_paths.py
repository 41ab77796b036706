"""The XLA paths of the fg program against independent references.

Each case builds one of the problem shapes with a path of its own
(per-trajectory generators, per-trajectory coefficient tables, grouped
generators, Chebyshev propagation, small-d ensembles) and checks the
complex64 (J, gradient) of the plain XLA path against a reference that
shares none of its gradient code: the other gradient method in
complex128.  Reference anchor for the per-trajectory backward loop:
reference ``src/optimize.jl:876-911``.
"""

import numpy as np
import pytest

import grape_tpu.fg as fgmod
from grape_tpu import ShapedAmplitude, Trajectory, hamiltonian
from grape_tpu.fg import build_f, build_fg, compile_problem
from grape_tpu.functionals import J_T_sm


def _assert_close(cp, cp_ref, j_tol=1e-4, g_tol=2e-3):
    x = cp_ref.guess_pulsevals.reshape(-1)
    J, g, _ = build_fg(cp)(x)
    J_ref, g_ref, _ = build_fg(cp_ref)(x)
    g, g_ref = np.asarray(g), np.asarray(g_ref)
    scale = max(np.max(np.abs(g_ref)), 1e-12)
    assert abs(float(J) - float(J_ref)) < j_tol * max(1.0, abs(float(J_ref)))
    assert np.max(np.abs(g - g_ref)) < g_tol * scale
    return x, J_ref


def _pertraj_problem(d=16, K=3):
    """K distinct random Hamiltonians, two shared controls."""
    rng = np.random.default_rng(21)

    def eps(t):
        return 0.2 * np.cos(0.7 * t)

    def eps2(t):
        return 0.1 * np.sin(0.9 * t)

    ctl_ops = []
    for _ in range(2):
        A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
        ctl_ops.append(0.5 * (A + A.conj().T))
    trajs = []
    for k in range(K):
        A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
        H0 = 0.5 * (A + A.conj().T) * 0.3 * (1 + 0.05 * k)
        psi0 = rng.normal(size=d) + 1j * rng.normal(size=d)
        tgt = rng.normal(size=d) + 1j * rng.normal(size=d)
        trajs.append(Trajectory(
            psi0 / np.linalg.norm(psi0),
            hamiltonian(H0, (ctl_ops[0], eps), (ctl_ops[1], eps2)),
            target_state=tgt / np.linalg.norm(tgt),
        ))
    return trajs, np.linspace(0, 2.0, 21)


@pytest.mark.parametrize("u_storage", ["stored", "over_budget"])
def test_fg_pertraj_gradgen_matches_reference(u_storage, monkeypatch):
    """Per-trajectory generators, gradgen in complex64: the
    time-vectorized pass with stored propagators, and the per-step scan
    taken when the propagators exceed their storage budget."""
    trajs, tlist = _pertraj_problem()
    if u_storage == "over_budget":
        monkeypatch.setattr(fgmod, "_gg_u_bytes_ok", lambda cp: False)
    cp = compile_problem(trajs, tlist, J_T=J_T_sm,
                         gradient_method="gradgen", dtype=np.complex64)
    assert not cp.shared_generator and not cp.per_traj_coeffs
    assert fgmod._vec_gradgen_enabled(cp) == (u_storage == "stored")
    cp_ref = compile_problem(trajs, tlist, J_T=J_T_sm,
                             gradient_method="taylor", dtype=np.complex128)
    _assert_close(cp, cp_ref)


def test_fg_pertraj_coeffs_matches_reference():
    """Per-trajectory amplitude SHAPES (per-trajectory coefficient
    tables), gradgen in complex64 against taylor in complex128."""
    rng = np.random.default_rng(31)
    d, K = 16, 3

    def eps(t):
        return 0.2 * np.cos(0.5 * t)

    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    Hc = 0.2 * (A + A.conj().T)
    B = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    H0 = 0.15 * (B + B.conj().T)
    trajs = []
    for k in range(K):
        p0 = rng.normal(size=d) + 1j * rng.normal(size=d)
        tg = rng.normal(size=d) + 1j * rng.normal(size=d)
        trajs.append(Trajectory(
            p0 / np.linalg.norm(p0),
            hamiltonian(
                H0,
                (Hc, ShapedAmplitude(eps, lambda t, k=k: 1.0 + 0.1 * k)),
            ),
            target_state=tg / np.linalg.norm(tg),
        ))
    tlist = np.linspace(0, 2.0, 13)
    cp = compile_problem(trajs, tlist, J_T=J_T_sm,
                         gradient_method="gradgen", dtype=np.complex64)
    assert cp.per_traj_coeffs
    cp_ref = compile_problem(trajs, tlist, J_T=J_T_sm,
                             gradient_method="taylor", dtype=np.complex128)
    _assert_close(cp, cp_ref)


@pytest.mark.parametrize("vectorize_backward", [True, False])
def test_fg_grouped_ensemble_matches_reference(vectorize_backward):
    """Robust-CZ ensemble (each sample's 4 basis trajectories share one
    generator, group size 4): the grouped gradgen pass, and the per-step
    taylor scan over grouped stored propagators, in complex64 against
    the vectorized taylor pass in complex128."""
    from grape_tpu.models import two_transmon_cz_ensemble_problem

    p = two_transmon_cz_ensemble_problem(n_samples=2, d=4, T=4.0,
                                         n_steps=12)  # dim=16, K=8
    method = "gradgen" if vectorize_backward else "taylor"
    cp = compile_problem(
        p.trajectories, p.tlist, dtype=np.complex64,
        gradient_method=method, vectorize_backward=vectorize_backward,
        **p.kwargs,
    )
    assert cp.gen_group_size == 4
    assert fgmod._effective_group_size(cp) == 4
    cp_ref = compile_problem(
        p.trajectories, p.tlist, dtype=np.complex128,
        gradient_method="taylor", **p.kwargs,
    )
    _assert_close(cp, cp_ref)


def test_fg_cheby_matches_expprop():
    """Chebyshev propagation at d=256 (shared generator, thin K=2 state
    block): forward storage and the adjoint χ chain both run the XLA
    Chebyshev scan; complex64 against ExpProp in complex128, and build_f
    agrees with build_fg."""
    rng = np.random.default_rng(11)
    d, K = 256, 2
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    H0 = 0.3 * (A + A.conj().T)
    B = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    Hc = 0.25 * (B + B.conj().T)

    def eps(t):
        return 0.2 * np.cos(1.3 * t)

    gen = hamiltonian(H0, (Hc, eps))
    U = np.linalg.qr(
        rng.normal(size=(d, K)) + 1j * rng.normal(size=(d, K))
    )[0]
    trajs = []
    for k in range(K):
        e_k = np.zeros(d, complex)
        e_k[k] = 1.0
        trajs.append(Trajectory(e_k, gen, target_state=U[:, k]))
    tlist = np.linspace(0, 0.3, 4)
    cp = compile_problem(trajs, tlist, J_T=J_T_sm, prop_method="cheby",
                         gradient_method="taylor", dtype=np.complex64)
    cp_ref = compile_problem(trajs, tlist, J_T=J_T_sm,
                             gradient_method="taylor", dtype=np.complex128)
    x, J_ref = _assert_close(cp, cp_ref, j_tol=1e-5, g_tol=5e-4)
    J_f = build_f(cp)(x)[0]
    assert abs(float(J_f) - float(J_ref)) < 1e-5 * max(1.0, abs(float(J_ref)))


def test_fg_smalld_ensemble_matches_reference():
    """Small-d ensemble (K=256 distinct qutrit generators): the batched
    (K, 3, 3) XLA scan in complex64 against complex128."""
    from grape_tpu.models import transmon_ensemble_trajectories

    trajs = transmon_ensemble_trajectories(256, d=3, T=20.0)
    tlist = np.linspace(0, 20.0, 41)
    cp = compile_problem(trajs, tlist, J_T=J_T_sm, gradient_method="taylor",
                         dtype=np.complex64)
    assert cp.dim == 3 and not cp.shared_generator
    cp_ref = compile_problem(trajs, tlist, J_T=J_T_sm,
                             gradient_method="taylor", dtype=np.complex128)
    _assert_close(cp, cp_ref)
