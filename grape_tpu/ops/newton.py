"""Krylov (Arnoldi) propagator.

JAX analog of the reference's Newton propagator capability
(QuantumPropagators; ``/root/reference/docs/src/index.md:63`` lists Newton
for non-Hermitian generators where the Chebyshev method does not apply):
``exp(A) ψ`` approximated in a fixed-dimension Krylov subspace,

    exp(A) ψ ≈ β · V_m · exp(H_m) · e_1,

with ``V_m`` the Arnoldi basis of ``span{ψ, Aψ, ..., A^{m-1}ψ}`` and ``H_m``
the (m×m) Hessenberg projection.  Matvec-only (works for arbitrary
non-Hermitian generators), fixed subspace dimension (static shapes under
jit), natively batched over the trajectory axis; the small ``exp(H_m)``
uses the dense expm kernel.
"""

import jax.numpy as jnp
from jax import lax

from .expm import expm

__all__ = ["arnoldi_expmv"]


def arnoldi_expmv(matvec, psi, m=30, substeps=1):
    """``exp(A) ψ`` for the batched linear operator ``matvec((K,d)) -> (K,d)``.

    ``m`` is the (static) Krylov dimension; ``substeps`` splits the action
    into ``exp(A/r)`` applications for large ``||A||``.
    """
    psi = jnp.asarray(psi)
    K, d = psi.shape
    r = int(substeps)
    cdtype = psi.dtype

    def apply_once(p, _):
        beta = jnp.sqrt(jnp.sum(jnp.abs(p) ** 2, axis=-1))  # (K,)
        safe_beta = jnp.where(beta > 0, beta, 1.0).astype(cdtype)
        V0 = jnp.zeros((m, K, d), dtype=cdtype).at[0].set(
            p / safe_beta[:, None]
        )
        H0 = jnp.zeros((K, m, m), dtype=cdtype)

        def body(j, state):
            V, H = state
            w = matvec(V[j]) / r  # (K, d)

            def gs(i, carry):
                w, H = carry
                h = jnp.where(
                    i <= j,
                    jnp.sum(jnp.conj(V[i]) * w, axis=-1),
                    jnp.zeros((K,), dtype=cdtype),
                )
                w = w - h[:, None] * V[i]
                H = H.at[:, i, j].set(h)
                return (w, H)

            w, H = lax.fori_loop(0, m, gs, (w, H))
            hnext = jnp.sqrt(jnp.sum(jnp.abs(w) ** 2, axis=-1))  # (K,)
            safe_h = jnp.where(hnext > 1e-30, hnext, 1.0).astype(cdtype)

            def extend(VH):
                V, H = VH
                H = H.at[:, j + 1, j].set(hnext.astype(cdtype))
                V = V.at[j + 1].set(w / safe_h[:, None])
                return (V, H)

            V, H = lax.cond(j + 1 < m, extend, lambda VH: VH, (V, H))
            return (V, H)

        V, H = lax.fori_loop(0, m, body, (V0, H0))
        E = expm(H)  # (K, m, m)
        coeffs = safe_beta[:, None] * E[:, :, 0]  # (K, m): beta exp(H) e_1
        out = jnp.einsum("ki,ikd->kd", coeffs, V)
        # beta == 0 -> zero state stays zero
        return jnp.where(beta[:, None] > 0, out, p), None

    out, _ = lax.scan(apply_once, psi, None, length=r)
    return out
