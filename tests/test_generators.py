"""Generator utilities: heterogeneous-ensemble alignment.

The batched device program requires a shared term structure across all
trajectories (the batched counterpart of the reference looping
per-trajectory propagator objects, ``/root/reference/src/optimize.jl:720``).
``align_generators`` pads heterogeneous ensembles onto the union structure.
"""

import numpy as np
import pytest

from grape_tpu import (
    Trajectory, align_generators, hamiltonian, optimize, propagate,
)
from grape_tpu.fg import compile_problem
from grape_tpu.functionals import J_T_sm

sz = np.array([[1, 0], [0, -1]], dtype=complex)
sx = np.array([[0, 1], [1, 0]], dtype=complex)
sy = np.array([[0, -1j], [1j, 0]], dtype=complex)


def test_align_generators_pads_missing_terms():
    """An ensemble member lacking a coupling gets a zero-padded term; the
    aligned generators propagate identically to the originals."""

    def eps1(t):
        return 0.5 * np.sin(np.pi * t / 5.0)

    def eps2(t):
        return 0.1

    # member A has both drives; member B only the first
    gA = hamiltonian(-0.5 * sz, (sx, eps1), (sy, eps2))
    gB = hamiltonian(-0.6 * sz, (sx, eps1))
    aligned = align_generators([gA, gB])

    assert len(aligned[0].terms) == len(aligned[1].terms) == 2
    # padded slot is a zero operator
    assert np.allclose(aligned[1].terms[1][0], 0.0)
    # amplitudes are the SAME objects (control identity preserved)
    assert aligned[0].terms[0][1] is eps1
    assert aligned[1].terms[1][1] is eps2

    tlist = np.linspace(0, 5, 101)
    for orig, al in [(gA, aligned[0]), (gB, aligned[1])]:
        np.testing.assert_allclose(
            propagate([1, 0], orig, tlist),
            propagate([1, 0], al, tlist),
            atol=1e-12,
        )


def test_align_generators_merges_duplicate_amplitude_terms():
    """Two terms with the same amplitude object collapse into one summed
    operator so every aligned generator has exactly one slot per amplitude."""

    def eps(t):
        return 0.2

    g = hamiltonian(-0.5 * sz, (sx, eps), (0.5 * sy, eps))
    (aligned,) = align_generators([g])
    assert len(aligned.terms) == 1
    np.testing.assert_allclose(aligned.terms[0][0], sx + 0.5 * sy)


def test_align_generators_dimension_mismatch():
    g2 = hamiltonian(-0.5 * sz, (sx, lambda t: 0.1))
    g3 = hamiltonian(np.zeros((3, 3)), (np.eye(3), lambda t: 0.1))
    with pytest.raises(ValueError, match="dimension"):
        align_generators([g2, g3])


def test_heterogeneous_ensemble_optimization():
    """End-to-end: a robustness ensemble where only one member has a
    crosstalk drive optimizes directly through the public API —
    compile_problem auto-aligns the heterogeneous term structures (the
    reference accepts arbitrary per-trajectory generators because each
    trajectory owns its propagators, src/workspace.jl:221-233).  The
    auto-aligned result must agree with manual align_generators."""

    def eps(t):
        return 0.3

    def crosstalk(t):
        return 0.05

    gA = hamiltonian(-0.5 * sz, (sx, eps))
    gB = hamiltonian(-0.52 * sz, (sx, eps), (sy, crosstalk))
    tlist = np.linspace(0, 5, 201)
    trajs_raw = [
        Trajectory([1, 0], g, target_state=[0, 1]) for g in (gA, gB)
    ]
    cp_auto = compile_problem(trajs_raw, tlist, J_T=J_T_sm)

    gA2, gB2 = align_generators([gA, gB])
    trajs = [
        Trajectory([1, 0], g, target_state=[0, 1]) for g in (gA2, gB2)
    ]
    cp_manual = compile_problem(trajs, tlist, J_T=J_T_sm)
    np.testing.assert_allclose(cp_auto.ops, cp_manual.ops)
    np.testing.assert_allclose(cp_auto.M, cp_manual.M)

    res = optimize(
        trajs_raw, tlist, iter_stop=12, J_T=J_T_sm,
        rethrow_exceptions=True, print_iters=False,
    )
    assert res.J_T < 1e-2


def test_as_generator_rejects_non_numeric():
    """A mistaken term list (or any object/1D/non-square input) raises a
    descriptive TypeError instead of silently producing an object-dtype
    drift (ADVICE round 3); square numeric matrices still coerce
    (reference static-matrix acceptance, test/test_empty_optimization.jl)."""
    import pytest

    from grape_tpu.generators import as_generator, hamiltonian

    H1 = np.eye(2)

    def eps(t):
        return 0.1

    # a term list passed where a generator belongs -> (T, 2) object array
    with pytest.raises(TypeError, match="as a generator"):
        as_generator([(H1, eps), (H1, eps)])
    with pytest.raises(TypeError, match="as a generator"):
        as_generator(np.arange(4.0))  # 1D
    with pytest.raises(TypeError, match="as a generator"):
        as_generator(np.zeros((2, 3)))  # non-square
    g = as_generator(np.eye(3))
    assert g.dim == 3 and len(g.terms) == 0
    h = hamiltonian(np.eye(2), (H1, eps))
    assert as_generator(h) is h
