"""Robust ensemble GRAPE: optimize one pulse pair against many Hamiltonian
samples (detuning spread), optionally sharded over a device mesh — the
multi-chip flagship pattern (BASELINE config 5).

Run:  python examples/03_robust_ensemble.py
For a multi-device run on CPU:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/03_robust_ensemble.py
"""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from grape_tpu import optimize
from grape_tpu.functionals import J_T_sm
from grape_tpu.models import transmon_ensemble_trajectories


def main():
    K = 16  # ensemble size (scale to thousands on a GPU)
    trajectories = transmon_ensemble_trajectories(
        K, d=3, delta_spread=0.05, T=20.0
    )
    tlist = np.linspace(0, 20.0, 201)
    result = optimize(
        trajectories, tlist,
        J_T=J_T_sm,
        gradient_method="taylor",
        iter_stop=30,
        check_convergence=lambda r: bool(r.J_T < 1e-3),
    )
    print(result)
    print(f"robust-ensemble J_T over {K} samples: {result.J_T:.3e}")

    # For explicit multi-chip sharding (the optimize() driver handles the
    # single-program case; this is the building block the multi-host path
    # uses):
    if len(jax.devices()) >= 8 and K % 8 == 0:
        from grape_tpu.fg import compile_problem
        from grape_tpu.parallel import build_fg_sharded, make_mesh

        cp = compile_problem(trajectories, tlist, J_T=J_T_sm)
        mesh = make_mesh(8)
        fg_sharded, _ = build_fg_sharded(cp, mesh)
        J, grad, _ = fg_sharded(cp.guess_pulsevals.reshape(-1))
        print(f"sharded fg over {mesh.devices.size} devices: J = {float(J):.6f}")


def main_robust_gate():
    """Robust GATE ensemble (BASELINE config-5 north star): a CZ on an
    ensemble of perturbed two-transmon Hamiltonians.  Each sample's 4
    logical basis trajectories share one generator, which the ExpProp
    paths exploit automatically (grouped expm bases); the functional
    is per-sample coherent / cross-sample incoherent
    (`make_ensemble_gate_functional` — a plain J_T_sm would let the
    sample-dependent drift phases interfere destructively).  Add
    `optimizer="device-lbfgs"` for the device-resident loop."""
    from grape_tpu import optimize_problem
    from grape_tpu.models import two_transmon_cz_ensemble_problem

    problem = two_transmon_cz_ensemble_problem(
        n_samples=4, d=4, T=25.0, n_steps=250,
    )  # dim=16 demo size; use d=10 (dim=100) for the real benchmark
    result = optimize_problem(
        problem, iter_stop=40,
        check_convergence=lambda r: bool(r.J_T < 1e-2),
    )
    print(result)
    print(f"robust-CZ ensemble J_T: {result.J_T:.3e}")


if __name__ == "__main__":
    main()
    main_robust_gate()
