"""Background pre-warm of the next amplitude-envelope bucket (kills the
mid-run re-jit stall).

Static-envelope programs (Chebyshev tables, vectorized-Taylor orders,
expm squarings) re-jit when the optimizer pushes pulses past the
envelope, which would pay a compile MID-RUN.  The workspace builds AND executes the
next bucket's programs on a daemon thread right after the first
foreground evaluation, so the growth swaps to an already-warm program."""

import numpy as np

from grape_tpu import Trajectory, hamiltonian
from grape_tpu.functionals import J_T_sm
from grape_tpu.shapes import flattop
from grape_tpu.workspace import GrapeWrk

sz = np.array([[1, 0], [0, -1]], dtype=complex)
sx = np.array([[0, 1], [1, 0]], dtype=complex)


def _tls_trajs(n_steps=100):
    def eps(t):
        return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))

    H = hamiltonian(-0.5 * sz, (sx, eps))
    tlist = np.linspace(0, 5, n_steps + 1)
    return [Trajectory([1, 0], H, target_state=[0, 1])], tlist


def test_prewarm_builds_next_bucket():
    """After the first evaluation, the NEXT bucket's programs are built
    and executed in the background; growing into it needs no rebuild."""
    trajs, tlist = _tls_trajs()
    wrk = GrapeWrk(trajs, tlist, dict(
        J_T=J_T_sm, prop_method="cheby", gradient_method="taylor",
    ))
    assert wrk._amp_bucket is not None  # static-envelope program
    x = wrk.pulsevals.copy()
    wrk.evaluate_gradient(x)
    next_key = wrk._next_bucket_key()
    assert next_key is not None and next_key != wrk._amp_bucket
    wrk._join_prewarm()
    assert next_key in wrk._program_cache
    warm_fg, _ = wrk._program_cache[next_key]
    # push the pulse past the current envelope: the workspace must swap
    # to exactly the pre-warmed program object (no rebuild)
    big = x * (1.1 * float(np.max(np.asarray(wrk._amp_bucket)))
               / max(np.max(np.abs(x)), 1e-12))
    J, G = wrk.evaluate_gradient(big)
    assert wrk._amp_bucket == next_key
    assert wrk.fg is warm_fg
    assert np.isfinite(J)
    # the growth re-armed warming for the bucket after that
    wrk._join_prewarm()
    assert wrk._next_bucket_key() in wrk._program_cache


def test_prewarm_correctness_of_warmed_program():
    """The pre-warmed (larger-envelope) program computes the same J and
    gradient as a fresh build at that envelope (envelope over-estimates
    are mathematically exact)."""
    from grape_tpu.fg import build_fg, compile_problem

    trajs, tlist = _tls_trajs(n_steps=50)
    wrk = GrapeWrk(trajs, tlist, dict(
        J_T=J_T_sm, prop_method="cheby", gradient_method="taylor",
    ))
    x = wrk.pulsevals.copy()
    wrk.evaluate_gradient(x)
    wrk._join_prewarm()
    next_key = wrk._next_bucket_key()
    warm_fg, _ = wrk._program_cache[next_key]
    J_w, G_w, _ = warm_fg(x)
    cp = compile_problem(trajs, tlist, J_T=J_T_sm, prop_method="cheby",
                         gradient_method="taylor")
    J_f, G_f, _ = build_fg(cp, amp_max=np.asarray(next_key))(x)
    np.testing.assert_allclose(float(J_w), float(J_f), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(G_w), np.asarray(G_f), atol=1e-12
    )


def test_clean_interpreter_exit_with_prewarm_in_flight():
    """Interpreter exit while a background pre-warm compile is running
    must not abort ("pure virtual method called"): the atexit hook joins
    live prewarm threads before C++ static destructors run."""
    import subprocess
    import sys

    code = """
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from grape_tpu import Trajectory, hamiltonian
from grape_tpu.functionals import J_T_sm
from grape_tpu.shapes import flattop
from grape_tpu.workspace import GrapeWrk

def eps(t):
    return 0.2 * float(flattop(t, T=5, t_rise=0.3, func="blackman"))

sz = np.array([[1, 0], [0, -1]], dtype=complex)
sx = np.array([[0, 1], [1, 0]], dtype=complex)
H = hamiltonian(-0.5 * sz, (sx, eps))
tlist = np.linspace(0, 5, 101)
wrk = GrapeWrk([Trajectory([1, 0], H, target_state=[0, 1])], tlist,
               dict(J_T=J_T_sm, prop_method="cheby",
                    gradient_method="taylor"))
wrk.evaluate_gradient(wrk.pulsevals.copy())  # kicks off the prewarm
assert wrk._warm_thread is not None
print("EXITING_WITH_PREWARM_ALIVE")
# exit immediately: the daemon thread is (likely) mid-XLA-compile
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600,
    )
    assert "EXITING_WITH_PREWARM_ALIVE" in proc.stdout, proc.stderr
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])


def test_no_prewarm_when_bounds_cap_envelope():
    """Bound-derived envelopes can never be exceeded: nothing to warm."""
    trajs, tlist = _tls_trajs()
    wrk = GrapeWrk(trajs, tlist, dict(
        J_T=J_T_sm, prop_method="cheby",
        lower_bound=-0.7, upper_bound=0.7,
    ))
    wrk.evaluate_gradient(wrk.pulsevals.copy())
    assert wrk._next_bucket_key() is None
    assert wrk._warm_thread is None


def test_no_prewarm_opt_out_and_mesh():
    """prewarm_envelope=False opts out; mesh runs never background-warm
    (multi-host program-launch order must stay deterministic)."""
    trajs, tlist = _tls_trajs()
    wrk = GrapeWrk(trajs, tlist, dict(
        J_T=J_T_sm, prop_method="cheby", prewarm_envelope=False,
    ))
    wrk.evaluate_gradient(wrk.pulsevals.copy())
    assert wrk._warm_thread is None

    import jax
    from grape_tpu.parallel import make_mesh

    if len(jax.devices()) >= 8:
        def eps(t):
            return 0.2 * float(
                flattop(t, T=5, t_rise=0.3, func="blackman")
            )

        H = hamiltonian(-0.5 * sz, (sx, eps))
        shared_eps = H.terms[0][1]
        gens = [
            hamiltonian(-0.5 * (1 + 0.01 * k) * sz, (sx, shared_eps))
            for k in range(8)
        ]
        trajs8 = [
            Trajectory([1, 0], g, target_state=[0, 1]) for g in gens
        ]
        wrk = GrapeWrk(trajs8, tlist, dict(
            J_T=J_T_sm, prop_method="cheby", mesh=make_mesh(8),
        ))
        wrk.evaluate_gradient(wrk.pulsevals.copy())
        assert wrk._warm_thread is None
