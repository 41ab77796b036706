"""Exact per-time-step gradient kernels.

JAX replacements for the reference's two gradient engines:

- ``gradgen_step``: the augmented-matrix ("gradient generator" / Van Loan)
  scheme.  The reference backward-propagates an extended state of dimension
  ``N(L+1)`` under a block generator (QuantumGradientGenerators; structure at
  reference ``docs/src/background.md:443-496``).  Here we instead
  batch ``L`` independent ``2d x 2d`` augmented exponentials
  ``exp([[A, B_l], [0, A]])`` whose top-right block is the Fréchet derivative
  ``L(A, B_l)`` — a batched-matmul workload that yields
  ``U†χ`` and all ``(∂U†/∂ε_l)χ`` in one fused call.

- ``taylor_grad_step``: the Taylor-recursion scheme of Kuprov & Rogers
  Eq. (20), mirroring ``taylor_grad_step!`` at
  ``/root/reference/src/optimize.jl:587-653``: matvec-only, preferable for
  large dimensions.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .expm import (
    _B as _PADE_B, _FACT_INV, _TAYLOR_DEGREE, _THETA_TAYLOR_F32, _theta13,
)

__all__ = ["gradgen_step", "taylor_grad_step", "expm_frechet"]


def _frechet_taylor_ps(A, B, degree=_TAYLOR_DEGREE):
    """``(expm(A), L(A,B))`` by degree-``degree`` Taylor Paterson-Stockmeyer
    (matmul-only, for pre-scaled ``‖A‖ ≤ θ``); the Fréchet factor follows
    the same Horner-in-A⁴ loop by the product rule.  ``A (..., d, d)``,
    ``B (..., L, d, d)``."""
    d = A.shape[-1]
    ident = jnp.eye(d, dtype=A.dtype)
    A2 = A @ A
    A3 = A2 @ A
    A4 = A3 @ A
    powers = [ident, A, A2, A3]
    Ab = A[..., None, :, :]
    A4b = A4[..., None, :, :]
    # M_r = dA^r[B]: M_r = A M_{r-1} + B A^{r-1}
    M1 = B
    M2 = Ab @ B + B @ A[..., None, :, :]
    M3 = Ab @ M2 + B @ A2[..., None, :, :]
    M4 = Ab @ M3 + B @ A3[..., None, :, :]
    dpowers = [None, M1, M2, M3]
    p = 4
    n_blocks = (degree + 1 + p - 1) // p
    E = None
    dE = None
    for b in reversed(range(n_blocks)):
        blk = None
        dblk = None
        for r in range(p):
            k = 4 * b + r
            if k > degree:
                continue
            term = _FACT_INV[k] * powers[r]
            blk = term if blk is None else blk + term
            if dpowers[r] is not None:
                dterm = _FACT_INV[k] * dpowers[r]
                dblk = dterm if dblk is None else dblk + dterm
        if E is None:
            E = blk
            dE = dblk
        else:
            new_dE = M4 @ E[..., None, :, :]
            if dE is not None:
                new_dE = new_dE + A4b @ dE
            if dblk is not None:
                new_dE = new_dE + dblk
            dE = new_dE
            E = blk + A4 @ E
    return E, dE


def _frechet_pade13(A, B):
    """``(expm(A), L(A,B))`` by the Padé-13 approximant with its exact
    Fréchet factor (Al-Mohy & Higham 2009 structure), for pre-scaled
    ``‖A‖ ≤ θ₁₃``.  One LU factorization is shared between the expm solve
    and all ``L`` Fréchet solves."""
    d = A.shape[-1]
    b = _PADE_B
    ident = jnp.eye(d, dtype=A.dtype)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A2 @ A4
    Ab = A[..., None, :, :]
    A2b, A4b, A6b = (X[..., None, :, :] for X in (A2, A4, A6))
    # dA^{2k}[B] chain: M2 = AB+BA, M4 = A2 M2 + M2 A2, M6 = A4 M2 + M4 A2
    M2 = Ab @ B + B @ Ab
    M4 = A2b @ M2 + M2 @ A2b
    M6 = A4b @ M2 + M4 @ A2b
    W1 = b[13] * A6 + b[11] * A4 + b[9] * A2
    W2 = b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident
    Z1 = b[12] * A6 + b[10] * A4 + b[8] * A2
    Z2 = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
    W = A6 @ W1 + W2
    U = A @ W
    V = A6 @ Z1 + Z2
    Lw1 = b[13] * M6 + b[11] * M4 + b[9] * M2
    Lw2 = b[7] * M6 + b[5] * M4 + b[3] * M2
    Lz1 = b[12] * M6 + b[10] * M4 + b[8] * M2
    Lz2 = b[6] * M6 + b[4] * M4 + b[2] * M2
    Lw = A6b @ Lw1 + M6 @ W1[..., None, :, :] + Lw2
    Lu = Ab @ Lw + B @ W[..., None, :, :]
    Lv = A6b @ Lz1 + M6 @ Z1[..., None, :, :] + Lz2
    # E = (V-U)^{-1}(V+U);  (V-U) L = Lu + Lv + (Lu - Lv) E
    # one LU of (V-U) for all right-hand sides: columns concatenated
    Q = V - U
    E = jnp.linalg.solve(Q, V + U)
    nL = B.shape[-3]
    rhs = Lu + Lv + (Lu - Lv) @ E[..., None, :, :]
    # stack the L right-hand sides as columns for ONE multi-RHS solve:
    # (..., L, d, d) -> (..., d, L*d) via transpose+reshape (O(1) HLO ops)
    rhs_cat = jnp.moveaxis(rhs, -3, -2).reshape(*rhs.shape[:-3], d, nL * d)
    Lf_cat = jnp.linalg.solve(Q, rhs_cat)
    Lf = jnp.moveaxis(
        Lf_cat.reshape(*rhs.shape[:-3], d, nL, d), -2, -3
    )
    return E, Lf


def expm_frechet(A, B, max_squarings=32, squarings=None):
    """``(expm(A), L(A, B))``: the matrix exponential and its Fréchet
    derivative(s) in direction(s) ``B``.

    ``A (..., d, d)``, ``B (..., L, d, d)`` (or ``(..., d, d)``).  Batched
    scaling-and-squaring on the PAIR: base approximant at ``A/2^s``
    (Padé-13 in f64, matmul-only Taylor-PS in f32, matching ``expm``),
    then ``s`` doublings ``(E, L) → (E², EL + LE)``.  The expm work is
    shared across all ``L`` directions — unlike the naive ``L`` augmented
    ``2d×2d`` exponentials (8× the matmul FLOPs of a ``d``-dim expm,
    per direction), this costs one ``d``-dim expm plus ~2 matmuls per
    direction per doubling (the reference delegates this to
    QuantumGradientGenerators' augmented-matrix propagation,
    ``/root/reference/docs/src/background.md:443-496``)."""
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    squeeze = False
    if B.ndim == A.ndim:
        B = B[..., None, :, :]
        squeeze = True
    use_taylor = A.dtype in (jnp.complex64, jnp.float32)
    if squarings is not None:
        # static squaring count from a host-side norm envelope: the
        # squaring loop then has a static trip count (better XLA
        # scheduling inside scans); an over-estimate is mathematically
        # exact, an under-estimate loses base-approximant accuracy —
        # callers must bound ||A|| from above (amp-envelope bucketing)
        s = int(squarings)
    else:
        norm = jnp.max(jnp.sum(jnp.abs(A), axis=-2))
        theta = _THETA_TAYLOR_F32 if use_taylor else _theta13(A.dtype)
        s = jnp.maximum(
            0.0, jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-300) / theta))
        ).astype(jnp.int32)
        s = jnp.minimum(s, max_squarings)
    rdtype = (
        jnp.real(A).dtype
        if jnp.issubdtype(A.dtype, jnp.complexfloating) else A.dtype
    )
    scale = (
        np.dtype(rdtype).type(2.0 ** (-s)) if isinstance(s, int)
        else jnp.exp2(-s.astype(jnp.float32)).astype(rdtype)
    )
    As = A * scale
    Bs = B * scale  # L(A, B) is linear in B: scales with B
    if use_taylor:
        E, Lf = _frechet_taylor_ps(As, Bs)
    else:
        E, Lf = _frechet_pade13(As, Bs)

    def square(_, EL):
        E, Lf = EL
        Eb = E[..., None, :, :]
        return E @ E, Eb @ Lf + Lf @ Eb

    E, Lf = lax.fori_loop(0, s, square, (E, Lf))
    if squeeze:
        Lf = Lf[..., 0, :, :]
    return E, Lf


def gradgen_step(H, mu, chi, dt):
    """One backward gradient-generator step.

    Given the (already adjoint) generator ``H (..., d, d)``, control
    derivatives ``mu (..., L, d, d)``, co-state ``chi (..., d)`` and the
    *backward* step ``dt`` (so the propagator applied is
    ``exp(-1j * H * dt)`` with ``dt < 0`` for backward propagation of the
    adjoint generator), returns ``(chi_prime, chi_new)`` where

    - ``chi_new (..., d)``   = ``exp(-1j H dt) @ chi``
    - ``chi_prime (..., L, d)`` = ``(∂/∂ε_l exp(-1j H dt)) @ chi``

    matching the reference's extended-state step (background.md Eq. for
    ``|χ'_l(t_{n-1})⟩``).
    """
    A = -1j * dt * H
    B = -1j * dt * mu
    E, Lf = expm_frechet(A, B)
    chi_new = jnp.einsum("...ij,...j->...i", E, chi)
    chi_prime = jnp.einsum("...lij,...j->...li", Lf, chi)
    return chi_prime, chi_new


def taylor_grad_step(H, mu, chi, dt, max_order=100, tolerance=1e-16,
                     check_convergence=True, with_status=False, scale=None):
    """Taylor-series evaluation of ``(∂/∂ε exp(-1j H dt)) @ chi``.

    Recursion (reference ``src/optimize.jl:604-653`` / Kuprov & Rogers (20)):

        chi' = Σ_{m≥1} (-1j dt)^m / m! · Φ_m
        Φ_1 = mu @ chi
        Φ_m = mu @ H^{m-1} @ chi + H @ Φ_{m-1}

    ``H (..., d, d)``, ``mu (..., L, d, d)``, ``chi (..., d)``.  Returns
    ``chi_prime (..., L, d)``.  With ``check_convergence``, the series stops
    once the norm of the added term (max over the batch) falls below
    ``tolerance``; otherwise exactly ``max_order`` terms are used.  The series
    runs under ``lax.while_loop`` with a static ``max_order`` bound.

    ``scale`` (a static host-side bound on the norm of ``H``) rescales the
    recursion to iterate with ``H/scale``: the iterates stay O(1) and the
    series weight ``(-i dt scale)^m/m!`` stays in f32 normal range.  The
    unscaled recursion drives ``Φ_m ~ ‖H‖^m`` toward overflow while the
    coefficient underflows — where denormals flush to zero that
    silently truncates the series early.  Mathematically identical.
    """
    A = jnp.asarray(H)
    mu = jnp.asarray(mu)
    chi = jnp.asarray(chi)
    if scale is not None and float(scale) > 0:
        h = float(scale)
        A = A / np.dtype(A.dtype).type(h)
        cdt = jnp.asarray(-1j * dt * h, dtype=A.dtype)
        inv_h = np.dtype(A.dtype).type(1.0 / h)
    else:
        h = 1.0
        cdt = jnp.asarray(-1j * dt, dtype=A.dtype)
        inv_h = np.dtype(A.dtype).type(1.0)
    tolerance = tolerance * h  # terms below are scaled by h

    Hchi0 = chi  # (H/h)^{m-1} chi for m=1 -> identity
    phi1 = jnp.einsum("...lij,...j->...li", mu, chi)
    acc = cdt * phi1  # m=1 term (scaled by h)
    coeff = cdt

    def cond(state):
        m, _, _, _, _, done = state
        return jnp.logical_and(m <= max_order, jnp.logical_not(done))

    def body(state):
        m, Hm_chi, phi_prev, acc, coeff, _ = state
        # H^{m-1} chi for current m
        Hm_chi = jnp.einsum("...ij,...j->...i", A, Hm_chi)
        phi = (
            jnp.einsum("...lij,...j->...li", mu, Hm_chi)
            + jnp.einsum("...ij,...lj->...li", A, phi_prev)
        )
        coeff = coeff * cdt / m
        term = coeff * phi
        acc_new = acc + term
        if check_convergence:
            term_norm = jnp.sqrt(jnp.max(jnp.sum(jnp.abs(term) ** 2, axis=-1)))
            done = term_norm < tolerance
        else:
            done = jnp.asarray(False)
        return (m + 1, Hm_chi, phi, acc_new, coeff, done)

    init = (jnp.asarray(2), Hchi0, phi1, acc, coeff, jnp.asarray(False))
    m_final, _, _, acc, _, done = lax.while_loop(cond, body, init)
    acc = acc * inv_h
    if with_status:
        # converged iff the tolerance stop fired (not the max_order cap);
        # the reference raises on non-convergence (src/optimize.jl:640-646)
        converged = jnp.logical_or(
            jnp.logical_not(jnp.asarray(check_convergence)), done
        )
        return acc, converged
    return acc
