"""Fat-batch gate synthesis: a random unitary on an 8-dimensional
subspace of a two-transmon register, optimized over K = 8 basis-state
trajectories under ONE shared generator.

This is the reference's gate-functional pattern
(reference `docs/src/background.md:552-610`) in the fat-batch
regime: with a shared generator every propagator term application is a
single (K, dim) @ (dim, dim) matmul instead of K thin ones, and the
gradgen backward derives one expm base per step for all K directions.

Run:  python examples/06_subspace_gate_fat_batch.py   (~1 min on CPU)
"""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from grape_tpu import optimize_problem
from grape_tpu.models import two_transmon_subspace_gate_problem


def main():
    # CPU-sized instance of the fat-batch family (on the GPU: d=10..32,
    # n_basis=64, complex64 — same code path).  A random subspace
    # unitary is only partially reachable with two drive controls; the
    # example demonstrates steady infidelity descent, like the model's
    # regression test (tests/test_models.py).
    problem = two_transmon_subspace_gate_problem(
        d=3, n_basis=6, n_steps=100, T=10.0, E0=0.2, J=0.3,
        iter_stop=60,
    )
    J0 = []
    result = optimize_problem(
        problem,
        gradient_method="gradgen",
        callback=lambda wrk, it: J0.append(wrk.result.J_T) or (),
        rethrow_exceptions=True,
    )
    print(result)
    print(f"\nsubspace-gate infidelity J_T = {result.J_T:.3e} "
          f"(guess: {J0[0]:.3e}, {J0[0] / result.J_T:.0f}x reduction) "
          f"after {result.iter} iterations over "
          f"{len(result.tau_vals)} basis-state trajectories")
    # the tau vector holds the per-basis-state overlaps with the target
    print("min |tau_k| =", float(np.min(np.abs(result.tau_vals))))


if __name__ == "__main__":
    main()
