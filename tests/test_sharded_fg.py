"""Trajectory-sharded fg programs against the one-device build.

``build_fg_sharded`` shards the trajectory axis over a device mesh; XLA's
SPMD partitioner then lowers the ``Σ_k`` reductions to collectives.  On
four virtual CPU devices, the sharded (J, gradient) must match the
unsharded build up to the reduction order, for each problem shape the
mesh path serves: a shared generator, per-trajectory generators, grouped
generators whose groups divide the shards (and straddle them), and a
small-d ensemble.

Reference anchor for the parallelized reduction: the ``Σ_k`` gradient
sum, reference ``src/optimize.jl:574-584``.
"""

import numpy as np
import jax
import pytest

from grape_tpu import Trajectory, hamiltonian
from grape_tpu.fg import build_fg, compile_problem
from grape_tpu.functionals import J_T_sm
from grape_tpu.parallel import build_fg_sharded, make_mesh
from grape_tpu.shapes import flattop


def _gate_problem(K=4, d=8):
    """Shared-generator problem: one random H, K basis states."""
    rng = np.random.default_rng(42)

    def eps(t):
        return 0.2 * float(flattop(t, T=4, t_rise=0.5, func="blackman"))

    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    H0 = 0.15 * (A + A.conj().T)
    B = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    Hc = 0.2 * (B + B.conj().T)
    gen = hamiltonian(H0, (Hc, eps))
    U_tgt = np.linalg.qr(
        rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    )[0]
    trajs = []
    for k in range(K):
        e_k = np.zeros(d, complex)
        e_k[k] = 1.0
        trajs.append(Trajectory(e_k, gen, target_state=U_tgt[:, k]))
    tlist = np.linspace(0, 4, 17)
    return trajs, tlist


def _ensemble_problem(K=8, d=16):
    """Per-trajectory generators: K distinct drifts, one shared control."""
    rng = np.random.default_rng(7)

    def eps(t):
        return 0.2 * np.cos(0.7 * t)

    B = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    Hc = 0.2 * (B + B.conj().T)
    trajs = []
    for k in range(K):
        A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
        H0 = 0.15 * (A + A.conj().T) * (1 + 0.03 * k)
        p0 = np.zeros(d, complex)
        p0[0] = 1.0
        tg = np.zeros(d, complex)
        tg[1] = 1.0
        trajs.append(
            Trajectory(p0, hamiltonian(H0, (Hc, eps)), target_state=tg)
        )
    tlist = np.linspace(0, 3, 13)
    return trajs, tlist


def _grouped_problem():
    """Robust-CZ ensemble: K=16, groups of 4 trajectories share one
    generator, dim=16."""
    from grape_tpu.models import two_transmon_cz_ensemble_problem

    p = two_transmon_cz_ensemble_problem(n_samples=4, d=4, T=3.0,
                                         n_steps=12)
    return p.trajectories, p.tlist, p.kwargs


def _smalld_problem():
    from grape_tpu.models import transmon_ensemble_trajectories

    trajs = transmon_ensemble_trajectories(32, d=3, T=4.0)
    return trajs, np.linspace(0, 4.0, 17), {"J_T": J_T_sm}


@pytest.mark.parametrize(
    "case,n_dev,method",
    [
        ("shared", 4, "gradgen"),
        ("pertraj", 4, "gradgen"),
        ("grouped", 4, "gradgen"),
        ("grouped_straddle", 8, "gradgen"),
        ("smalld", 4, "taylor"),
    ],
)
def test_sharded_fg_matches_unsharded(case, n_dev, method):
    from grape_tpu.fg import _effective_group_size
    from grape_tpu.parallel import shard_problem

    if case == "shared":
        trajs, tlist = _gate_problem()
        kw = {"J_T": J_T_sm}
    elif case == "pertraj":
        trajs, tlist = _ensemble_problem()
        kw = {"J_T": J_T_sm}
    elif case.startswith("grouped"):
        trajs, tlist, kw = _grouped_problem()
    else:
        trajs, tlist, kw = _smalld_problem()
    assert len(jax.devices()) >= n_dev
    mesh = make_mesh(n_dev)
    cp = compile_problem(trajs, tlist, gradient_method=method,
                         dtype=np.complex64, **kw)
    x = cp.guess_pulsevals.reshape(-1)
    J0, g0, _ = build_fg(cp)(x)

    if case.startswith("grouped"):
        assert cp.gen_group_size == 4
        # groups that divide the shards stay grouped per shard; groups
        # that would straddle a shard boundary fall back to ungrouped
        expect_gs = 4 if case == "grouped" else 1
        assert _effective_group_size(shard_problem(cp, mesh)) == expect_gs

    fg_sh, cp_sh = build_fg_sharded(cp, mesh)
    assert cp_sh.mesh is mesh
    assert len(cp_sh.psi0.sharding.device_set) == n_dev
    J1, g1, _ = fg_sh(x)
    g0, g1 = np.asarray(g0), np.asarray(g1)
    gs = max(np.max(np.abs(g0)), 1e-12)
    # same complex64 math, trajectory sums in another order
    assert abs(float(J1) - float(J0)) < 1e-5 * max(1.0, abs(float(J0)))
    assert np.max(np.abs(g1 - g0)) < 1e-4 * gs
