"""Standalone propagation utilities.

Public analogs of ``QuantumPropagators.propagate`` and
``QuantumControl.Controls.substitute`` as used in the reference tests
(``test/test_state_running_cost.jl:270-276,317-323``): simulate dynamics
under a generator (optionally storing all intermediate states), and replace
a generator's controls with optimized pulse vectors.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .amplitudes import ShapedAmplitude
from .config import complex_dtype
from .controls import discretize_on_midpoints, get_controls
from .generators import Generator, as_generator
from .ops.expm import expm

__all__ = ["propagate", "substitute"]


def substitute(generator, mapping):
    """Return a copy of `generator` with controls replaced per `mapping`
    (a list of ``(old_control, new_control)`` pairs or a dict-like of
    id-matched controls)."""
    if isinstance(mapping, dict):
        pairs = list(mapping.items())
    else:
        pairs = list(mapping)

    def replace(control):
        for old, new in pairs:
            if control is old:
                return new
        return control

    new_terms = []
    for op, amp in generator.terms:
        if isinstance(amp, ShapedAmplitude):
            new_terms.append(
                (op, ShapedAmplitude(replace(amp.control), amp.shape))
            )
        else:
            new_terms.append((op, replace(amp)))
    return Generator(generator.drift, new_terms)


def propagate(state, generator, tlist, storage=False, backwards=False,
              dtype=None):
    """Propagate `state` under `generator` over `tlist` (piecewise-constant
    exponential propagation).

    With ``storage=True``, returns the array of all states ``(N_T+1, d)``;
    otherwise only the final state ``(d,)``.
    """
    generator = as_generator(generator)  # plain static matrices allowed
    tlist = np.asarray(tlist, dtype=np.float64)
    N_T = len(tlist) - 1
    cdtype = complex_dtype(dtype) if dtype is not None else complex_dtype(
        jnp.result_type(float)
    )
    controls = get_controls(generator)
    eps = (
        np.stack([discretize_on_midpoints(c, tlist) for c in controls])
        if controls else np.zeros((0, N_T))
    )
    T = len(generator.terms)
    M, Mfix = generator.coefficient_tables(tlist, controls)
    # host-side numpy constants; complex outputs are packed into
    # real/imag pairs inside the jitted program, like every program output
    H0 = np.asarray(generator.drift, dtype=cdtype)
    ops = (
        np.stack([np.asarray(op, dtype=cdtype) for op, _ in generator.terms])
        if T else np.zeros((0,) + generator.drift.shape, dtype=cdtype)
    )
    epsj = np.asarray(eps if len(controls) else np.zeros((1, N_T)))
    dtv = np.diff(tlist)
    if backwards:
        sign = -1.0
        order = np.arange(N_T - 1, -1, -1)
    else:
        sign = 1.0
        order = np.arange(N_T)
    psi0 = np.asarray(state, dtype=cdtype)

    from .controls import midpoints

    custom = generator.custom_terms(controls)
    tmid = midpoints(tlist)

    @jax.jit
    @jax.default_matmul_precision("highest")
    def run(eps_in):
        Mj = jnp.asarray(M)
        H0_ = jnp.asarray(H0)
        ops_ = jnp.asarray(ops)
        dt_ = jnp.asarray(dtv)

        Mfixj = jnp.asarray(Mfix)
        # nonlinear (CustomAmplitude) coefficients, evaluated per interval
        coeffs_all = jnp.einsum("ntl,ln->nt", Mj, eps_in) + Mfixj
        tmid_ = jnp.asarray(tmid).astype(eps_in.dtype)
        for j, amp, idxs in custom:
            vals = eps_in[jnp.asarray(idxs), :]
            aj = jax.vmap(amp.func, in_axes=(1, 0))(vals, tmid_)
            coeffs_all = coeffs_all.at[:, j].set(
                jnp.reshape(aj, (N_T,)).astype(coeffs_all.dtype)
            )

        def step(psi, n):
            coeffs = coeffs_all[n].astype(cdtype)
            H = H0_ + jnp.einsum("t,tij->ij", coeffs, ops_)
            if backwards:
                H = jnp.conj(H.T)
            U = expm((-1j * sign * dt_[n].astype(cdtype)) * H)
            psi = U @ psi
            return psi, psi

        psi_T, ys = lax.scan(step, jnp.asarray(psi0), jnp.asarray(order))
        pack = lambda x: jnp.stack([jnp.real(x), jnp.imag(x)])
        return pack(psi_T), pack(ys)

    psi_T_p, ys_p = run(epsj)
    psi_T_p = np.asarray(psi_T_p)
    if storage:
        ys_p = np.asarray(ys_p)
        ys = ys_p[0] + 1j * ys_p[1]
        return np.concatenate([psi0[None], ys], axis=0)
    return psi_T_p[0] + 1j * psi_T_p[1]
