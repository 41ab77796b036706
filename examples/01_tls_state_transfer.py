"""Two-level-system |0⟩→|1⟩ state transfer — the canonical GRAPE example
(the reference's README example, /root/reference/README.md:30-58).

Run:  python examples/01_tls_state_transfer.py
"""

import jax

jax.config.update("jax_platforms", "cpu")  # small problem: CPU is enough
jax.config.update("jax_enable_x64", True)

import numpy as np

from grape_tpu import Trajectory, hamiltonian, optimize
from grape_tpu.functionals import J_T_sm
from grape_tpu.shapes import flattop


def guess_pulse(t):
    """A low-amplitude flattop guess."""
    return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))


def main():
    sigma_z = np.array([[1, 0], [0, -1]], dtype=complex)
    sigma_x = np.array([[0, 1], [1, 0]], dtype=complex)
    H = hamiltonian(-0.5 * sigma_z, (sigma_x, guess_pulse))
    tlist = np.linspace(0, 5, 501)
    trajectory = Trajectory([1, 0], H, target_state=[0, 1])

    result = optimize(
        [trajectory], tlist,
        J_T=J_T_sm,
        iter_stop=5,
        check_convergence=lambda r: ("J_T < 10⁻³" if r.J_T < 1e-3 else ""),
    )
    print(result)
    print(f"final J_T = {result.J_T:.3e}")
    print(f"max |ε_opt| = {np.max(np.abs(result.optimized_controls[0])):.4f}")
    assert result.J_T < 1e-3


if __name__ == "__main__":
    main()
