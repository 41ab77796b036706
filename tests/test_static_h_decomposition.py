"""Static-operator decomposition of the vectorized-taylor H†-apply.

At dim ≥ 128 the backward recursion applies the T+1 STATIC term operators
to the whole (N_T·K·(L+1), d) block (large matmuls, no (N_T, d, d) H_n
materialization) instead of N_T thin per-step matmuls.  Must be exactly
the same math as the per-step scan path."""

import numpy as np
import pytest

from grape_tpu import Trajectory, hamiltonian
from grape_tpu.fg import build_fg, compile_problem
from grape_tpu.functionals import J_T_sm


def _big_problem(d=128, K=2, n_steps=8, L=2):
    rng = np.random.default_rng(0)

    def herm(scale):
        A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
        return scale * 0.5 * (A + A.conj().T) / np.sqrt(d)

    H0 = herm(1.0)
    ops = [herm(0.5) for _ in range(L)]
    controls = [
        (lambda t, l=l: 0.2 * np.cos((l + 1) * t)) for l in range(L)
    ]
    trajs = []
    for k in range(K):
        e = np.zeros(d, dtype=complex)
        e[k] = 1.0
        t = np.zeros(d, dtype=complex)
        t[d - 1 - k] = 1.0
        gen = hamiltonian(
            (1 + 0.02 * k) * H0, *[(op, c) for op, c in zip(ops, controls)]
        )
        trajs.append(Trajectory(e, gen, target_state=t))
    tlist = np.linspace(0.0, 1.0, n_steps + 1)
    return trajs, tlist


def test_static_h_matches_per_step_scan():
    trajs, tlist = _big_problem()
    cp_vec = compile_problem(
        trajs, tlist, J_T=J_T_sm, gradient_method="taylor"
    )
    assert cp_vec.dim == 128  # static-operator decomposition active
    cp_scan = compile_problem(
        trajs, tlist, J_T=J_T_sm, gradient_method="taylor",
        vectorize_backward=False, reuse_propagators=False,
    )
    rng = np.random.default_rng(1)
    x = 0.2 * rng.normal(size=cp_vec.n_controls * cp_vec.n_timesteps)
    J_v, G_v, _ = build_fg(cp_vec)(x)
    J_s, G_s, _ = build_fg(cp_scan)(x)
    np.testing.assert_allclose(float(J_v), float(J_s), rtol=1e-12)
    scale = np.max(np.abs(np.asarray(G_s)))
    np.testing.assert_allclose(
        np.asarray(G_v), np.asarray(G_s), atol=1e-10 * max(scale, 1.0)
    )
