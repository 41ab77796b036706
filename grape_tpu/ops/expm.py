"""Batched matrix exponential.

JAX replacement for the reference's ``ExpProp`` propagator
(QuantumPropagators; used e.g. at ``/root/reference/README.md:38``).  The
reference computes ``exp(-i H dt)`` per time step via a dense matrix
exponential; here we provide a batched scaling-and-squaring Padé-13 expm in
which all matmuls are batched over the leading (trajectory /
control) axes, and the squaring loop uses a single *shared* scaling parameter
``s`` (max over the batch) so the loop count is one traced scalar rather than
per-matrix dynamic control flow.

Unlike a generic expm, this is never differentiated through: GRAPE computes
exact per-step gradients via the Fréchet kernels in ``frechet.py``.
"""

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["expm", "expm_pade13", "taylor_order_for_bound"]

# Padé-13 numerator coefficients (Higham 2005). float64 exact.
_B = (
    64764752532480000.0,
    32382376266240000.0,
    7771770303897600.0,
    1187353796428800.0,
    129060195264000.0,
    10559470521600.0,
    670442572800.0,
    33522128640.0,
    1323241920.0,
    40840800.0,
    960960.0,
    16380.0,
    182.0,
    1.0,
)
_THETA13_F64 = 5.371920351148152
# Single precision theta for Padé-13 (Higham 2005, Table 2.3 single column):
_THETA13_F32 = 3.925724783138660


def _theta13(dtype):
    if dtype in (jnp.complex128, jnp.float64):
        return _THETA13_F64
    return _THETA13_F32


def expm_pade13(A):
    """Padé-13 approximant of expm(A) without scaling (valid for small norm)."""
    d = A.shape[-1]
    ident = jnp.eye(d, dtype=A.dtype)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A2 @ A4
    b = _B
    U = A @ (
        A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
        + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident
    )
    V = (
        A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
        + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
    )
    return jnp.linalg.solve(V - U, V + U)


# Taylor scaling-and-squaring parameters: degree-16 Paterson-Stockmeyer for
# single precision (matmul-only — no LU solve).
_TAYLOR_DEGREE = 16
_THETA_TAYLOR_F32 = 2.0  # conservative: ||A/2^s|| <= 2 with m=16 gives
                          # truncation error well below f32 roundoff

import math as _math
_FACT_INV = tuple(1.0 / _math.factorial(k) for k in range(_TAYLOR_DEGREE + 1))


def expm_taylor_ps(A, degree=_TAYLOR_DEGREE):
    """Degree-`degree` Taylor approximant of expm(A) via Paterson-Stockmeyer
    (matmul-only; for scaled inputs with ``||A|| <= theta``)."""
    d = A.shape[-1]
    ident = jnp.eye(d, dtype=A.dtype)
    p = 4  # block size: powers A^1..A^4
    A2 = A @ A
    A3 = A2 @ A
    A4 = A3 @ A
    powers = [ident, A, A2, A3]
    n_blocks = (degree + 1 + p - 1) // p
    # E = sum_{b} (A^4)^b * (sum_{r<4} c_{4b+r} A^r), evaluated by Horner in A4
    E = None
    for b in reversed(range(n_blocks)):
        blk = None
        for r in range(p):
            k = 4 * b + r
            if k > degree:
                continue
            term = _FACT_INV[k] * powers[r]
            blk = term if blk is None else blk + term
        E = blk if E is None else blk + A4 @ E
    return E


def expm(A, max_squarings=32):
    """Matrix exponential of a batch of square matrices ``A (..., d, d)``.

    Scaling-and-squaring; the scaling exponent ``s`` is shared across the
    batch (max of the per-matrix 1-norms), so the squaring loop is a single
    ``fori_loop`` with a traced trip count.  The core approximant is
    Padé-13 in double precision (reference-accuracy parity) and a matmul-only
    degree-16 Taylor (Paterson-Stockmeyer) in single precision, which needs
    no LU solve.
    """
    A = jnp.asarray(A)
    use_taylor = A.dtype in (jnp.complex64, jnp.float32)
    norm = jnp.max(jnp.sum(jnp.abs(A), axis=-2))  # max 1-norm over batch
    theta = _THETA_TAYLOR_F32 if use_taylor else _theta13(A.dtype)
    # s = max(0, ceil(log2(norm / theta)))
    s = jnp.maximum(
        0.0, jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-300) / theta))
    ).astype(jnp.int32)
    s = jnp.minimum(s, max_squarings)
    scale = jnp.exp2(-s.astype(jnp.float32)).astype(
        jnp.real(A).dtype if jnp.issubdtype(A.dtype, jnp.complexfloating) else A.dtype
    )
    E = (
        expm_taylor_ps(A * scale) if use_taylor else expm_pade13(A * scale)
    )

    def square(_, M):
        return M @ M

    return lax.fori_loop(0, s, square, E)


def taylor_order_for_bound(bound, tolerance=1e-8, max_order=100,
                           prefactor=1.0):
    """Static Taylor order for the χ'-recursion: smallest ``m`` with
    ``prefactor · m · bound^m / m! < tolerance`` (+2 safety).  ``bound`` is
    the host-side envelope of ``|dt|·‖H‖`` (same bound that sizes the expm
    squarings); ``prefactor`` is ``‖μ‖/‖H‖`` — the recursion iterates
    ``Φ_m = μ H^{m-1} χ + H Φ_{m-1}`` so ``‖Φ_m‖ ≤ m·‖μ‖·‖H‖^{m-1}`` and the
    m-th series term is bounded by ``(‖μ‖/‖H‖)·m·(dt‖H‖)^m/m!``.
    Returns ``None`` if no order ≤ ``max_order`` satisfies the tolerance —
    the caller then falls back to the dynamic ``lax.while_loop`` path,
    mirroring the reference's non-convergence error
    (``src/optimize.jl:640-646``)."""
    term = max(float(prefactor), 1e-30)
    for m in range(1, max_order + 1):
        term *= max(float(bound), 1e-30) / m
        if m * term < tolerance:
            return min(m + 2, max_order)
    return None
