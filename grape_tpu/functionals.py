"""Optimization functionals and semi-automatic differentiation.

JAX analog of ``QuantumControl.Functionals`` as consumed by the
reference (``/root/reference/src/workspace.jl:307,314``,
``src/optimize.jl:94``): the standard final-time functionals ``J_T_sm`` /
``J_T_re`` / ``J_T_ss`` with their analytic ``chi`` counterparts, the pulse
running cost ``J_a_fluence``, and the semi-AD constructors ``make_chi`` /
``make_xi`` / ``make_grad_J_a`` built on ``jax.grad``.

Conventions (``docs/src/background.md:245-266``): for a real functional of a
complex vector, ``jax.grad`` returns the "complex gradient"
``∂J/∂Re[z] - i ∂J/∂Im[z] = 2 (∂J/∂z)`` (Wirtinger), so the co-state

    |χ_k(T)⟩ = -∂J_T/∂⟨Ψ_k(T)| = -∂J_T/∂Ψ_k* = -½ conj(jax.grad(J_T)(Ψ))_k .

**Batched API**: functionals receive the stacked final states ``Psi (K, d)``
(jnp array), the list of :class:`~grape_tpu.trajectory.Trajectory` objects
(static), and optionally ``tau (K,)`` — the overlaps
``τ_k = ⟨Ψ_k^tgt|Ψ_k(T)⟩`` — via keyword, mirroring the reference's ``tau``
kwarg protocol (``src/workspace.jl:297-311``).
"""

import inspect

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "J_T_sm", "J_T_re", "J_T_ss", "F_sm", "F_re", "F_ss",
    "chi_sm", "chi_re", "chi_ss",
    "J_a_fluence", "grad_J_a_fluence", "J_b",
    "make_chi", "make_xi", "make_grad_J_a", "make_analytic_chi",
    "set_default_ad_framework",
    "gate_functional", "make_gate_chi", "make_ensemble_gate_functional",
    "taus", "weights_of",
]

_ANALYTIC_CHI = {}


def weights_of(trajectories):
    return jnp.asarray([getattr(t, "weight", 1.0) for t in trajectories])


def taus(Psi, trajectories):
    """Overlaps ``τ_k = ⟨Ψ_k^tgt | Ψ_k⟩`` for stacked states ``Psi (K, d)``."""
    tgt = jnp.stack([jnp.asarray(t.target_state) for t in trajectories])
    return jnp.sum(jnp.conj(tgt) * Psi, axis=-1)


# --------------------------------------------------------------------------
# Standard final-time functionals (formulas per docs/src/tutorial.md:349-356
# and the QuantumControl.Functionals conventions)
# --------------------------------------------------------------------------

def J_T_sm(Psi, trajectories, tau=None):
    """Square-modulus functional ``1 - |Σ_k w_k τ_k|² / K²``."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories).astype(tau.real.dtype)
    K = len(trajectories)
    f = jnp.sum(w * tau)
    return 1.0 - jnp.abs(f) ** 2 / K**2


def chi_sm(Psi, trajectories, tau=None):
    """Analytic ``χ_k = (Σ_j w_j τ_j / K²) w_k |Ψ_k^tgt⟩`` for `J_T_sm`."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories).astype(tau.real.dtype)
    K = len(trajectories)
    f = jnp.sum(w * tau)
    tgt = jnp.stack([jnp.asarray(t.target_state) for t in trajectories])
    return (f / K**2) * (w[:, None] * tgt).astype(Psi.dtype)


def J_T_re(Psi, trajectories, tau=None):
    """Real-part functional ``1 - Re[Σ_k w_k τ_k] / K``."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories).astype(tau.real.dtype)
    K = len(trajectories)
    return 1.0 - jnp.real(jnp.sum(w * tau)) / K


def chi_re(Psi, trajectories, tau=None):
    """Analytic ``χ_k = w_k |Ψ_k^tgt⟩ / (2K)`` for `J_T_re`."""
    K = len(trajectories)
    w = weights_of(trajectories)
    tgt = jnp.stack([jnp.asarray(t.target_state) for t in trajectories])
    return ((w[:, None] / (2 * K)) * tgt).astype(Psi.dtype)


def J_T_ss(Psi, trajectories, tau=None):
    """State-to-state functional ``1 - Σ_k w_k |τ_k|² / K``."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories).astype(tau.real.dtype)
    K = len(trajectories)
    return 1.0 - jnp.sum(w * jnp.abs(tau) ** 2) / K


def chi_ss(Psi, trajectories, tau=None):
    """Analytic ``χ_k = (w_k/K) τ_k |Ψ_k^tgt⟩`` for `J_T_ss`."""
    if tau is None:
        tau = taus(Psi, trajectories)
    w = weights_of(trajectories).astype(tau.real.dtype)
    K = len(trajectories)
    tgt = jnp.stack([jnp.asarray(t.target_state) for t in trajectories])
    return ((w * tau / K)[:, None] * tgt).astype(Psi.dtype)


_ANALYTIC_CHI[J_T_sm] = chi_sm
_ANALYTIC_CHI[J_T_re] = chi_re
_ANALYTIC_CHI[J_T_ss] = chi_ss


def F_sm(Psi, trajectories, tau=None):
    """Square-modulus fidelity ``1 - J_T_sm``."""
    return 1.0 - J_T_sm(Psi, trajectories, tau=tau)


def F_re(Psi, trajectories, tau=None):
    """Real-part fidelity ``1 - J_T_re``."""
    return 1.0 - J_T_re(Psi, trajectories, tau=tau)


def F_ss(Psi, trajectories, tau=None):
    """State-to-state fidelity ``1 - J_T_ss``."""
    return 1.0 - J_T_ss(Psi, trajectories, tau=tau)


# --------------------------------------------------------------------------
# Pulse running costs
# --------------------------------------------------------------------------

def J_a_fluence(pulsevals, tlist):
    """Fluence ``Σ_{nl} ε_{nl}² dt_n`` (pulsevals ``(L, N_T)`` or flat)."""
    dt = jnp.diff(jnp.asarray(tlist))
    eps = jnp.reshape(jnp.asarray(pulsevals), (-1, dt.shape[0]))
    return jnp.sum(eps**2 * dt[None, :])


def grad_J_a_fluence(pulsevals, tlist):
    dt = jnp.diff(jnp.asarray(tlist))
    eps = jnp.reshape(jnp.asarray(pulsevals), (-1, dt.shape[0]))
    return jnp.reshape(2.0 * eps * dt[None, :], jnp.shape(pulsevals))


def J_b(storage, trajectories, tlist, g_b):
    """State-dependent running cost from stored forward states:
    trapezoid sum ``Σ_k Σ_n ½(g_b(Ψ(t_{n-1})) + g_b(Ψ(t_n))) dt_n``
    (the reference's ``QuantumControl.Functionals.J_b``, used in-callback at
    ``test/test_state_running_cost.jl:41-48``).

    ``storage (N_T+1, K, d)``; returns the scalar J_b (excluding λ_b).
    """
    tlist = jnp.asarray(tlist)
    dt = jnp.diff(tlist)
    w = jnp.concatenate(
        [0.5 * dt[:1], 0.5 * (dt[:-1] + dt[1:]), 0.5 * dt[-1:]]
    )
    N = storage.shape[0]

    def gb_at(n):
        return g_b(storage[n], trajectories, tlist, n)

    gvals = jax.vmap(gb_at)(jnp.arange(N))  # (N_T+1, K)
    return jnp.sum(w[:, None] * gvals)


# --------------------------------------------------------------------------
# Semi-automatic differentiation
# --------------------------------------------------------------------------

def accepts_tau(fn):
    """Whether `fn` has a ``tau`` keyword argument (reference's tau protocol)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # pragma: no cover
        return False
    return "tau" in sig.parameters


def set_default_ad_framework(framework=None, quiet=True):
    """API-familiarity shim for the reference's
    ``QuantumControl.set_default_ad_framework`` (re-exported by GRAPE.jl,
    ``src/GRAPE.jl:16``): in grape_tpu, automatic differentiation is always
    ``jax.grad`` (built into :func:`make_chi`/:func:`make_xi`), so there is
    nothing to configure.  Accepts and ignores any framework argument."""
    if not quiet and framework is not None:
        import warnings
        warnings.warn(
            "grape_tpu always uses jax.grad for semi-automatic "
            "differentiation; set_default_ad_framework is a no-op"
        )


def make_analytic_chi(J_T, chi):
    """Register an analytic ``chi`` for a functional (used by `make_chi`)."""
    _ANALYTIC_CHI[J_T] = chi
    return chi


def make_chi(J_T, trajectories, mode="auto"):
    """Construct ``chi(Psi, trajectories[, tau]) -> χ (K, d)`` for ``J_T``.

    ``mode="analytic"`` requires a registered analytic chi; ``mode="automatic"``
    forces AD; ``mode="auto"`` (default) prefers analytic, falling back to
    ``jax.grad`` semi-AD:  ``χ = -½ conj(∇_Ψ J_T)``.
    """
    if mode in ("auto", "analytic") and J_T in _ANALYTIC_CHI:
        return _ANALYTIC_CHI[J_T]
    if mode == "analytic":
        raise ValueError(f"No analytic chi registered for {J_T}")

    J_T_takes_tau = accepts_tau(J_T)

    def chi_ad(Psi, trajectories, tau=None):
        # Differentiate w.r.t. Psi directly; tau (if used by J_T) is
        # recomputed inside so the AD chain rule flows through it.
        def scalar(P):
            if J_T_takes_tau:
                return J_T(P, trajectories, tau=taus(P, trajectories))
            return J_T(P, trajectories)

        g = jax.grad(scalar)(Psi)
        return -0.5 * jnp.conj(g)

    return chi_ad


def make_xi(g_b, trajectories):
    """Construct ``xi(Psi, trajectories, tlist, n) -> (K, d)`` from a
    state-dependent running cost ``g_b(Psi, trajectories, tlist, n) -> (K,)``:
    ``ξ_k = -∂g_b/∂⟨Ψ_k| = -½ conj(∇_{Ψ_k} g_b)``.
    """

    def xi(Psi, trajectories, tlist, n):
        def scalar(P):
            return jnp.sum(g_b(P, trajectories, tlist, n))

        g = jax.grad(scalar)(Psi)
        return -0.5 * jnp.conj(g)

    return xi


def make_grad_J_a(J_a, tlist):
    """Gradient of a pulse running cost via ``jax.grad`` (real pulsevals)."""
    if J_a is J_a_fluence:
        return grad_J_a_fluence

    def grad_J_a(pulsevals, tlist):
        return jax.grad(lambda p: J_a(p, tlist))(pulsevals)

    return grad_J_a


# --------------------------------------------------------------------------
# Gate functionals (background.md:552-610)
# --------------------------------------------------------------------------

def make_ensemble_gate_functional(n_basis):
    """Robust-gate ensemble functional: coherent within each sample's
    ``n_basis`` gate trajectories, INCOHERENT across samples:

        ``J_T = 1 − Σ_s w_s |(1/n_basis) Σ_{k∈s} τ_k|²``

    A plain :func:`J_T_sm` over all ``S·n_basis`` trajectories sums τ
    coherently ACROSS samples; with per-sample drift perturbations the
    sample overlaps carry different dynamical phases and the coherent
    sum destructively interferes — measured: the robust-CZ ensemble
    stalls at J_T ≈ 0.97 under global ``J_T_sm`` while descending
    normally under this functional (ensemble members are independent
    systems; only the relative phases WITHIN one gate are physical).
    Reference counterpart: the gate functionals of
    ``/root/reference/docs/src/background.md:552-610`` applied
    per-ensemble-member.

    Trajectory order must be sample-major (all ``n_basis`` basis states
    of sample 0 first, ...).  Per-sample weights may be given through
    the trajectories' ``weight`` attribute (constant within a sample;
    normalized internally).  Returns ``J_T(Psi, trajectories,
    tau=None)`` (the batched tau protocol); the co-state comes from
    ``make_chi`` semi-AD."""

    def J_T_sm_ensemble(Psi, trajectories, tau=None):
        if tau is None:
            tau = taus(Psi, trajectories)
        K = len(trajectories)
        if K % n_basis != 0:
            raise ValueError(
                f"trajectory count ({K}) is not a multiple of "
                f"n_basis ({n_basis})"
            )
        S = K // n_basis
        w = weights_of(trajectories).astype(tau.real.dtype)
        w_s = w.reshape(S, n_basis)[:, 0]
        w_s = w_s / jnp.sum(w_s)
        tb = tau.reshape(S, n_basis)
        f = jnp.abs(jnp.mean(tb, axis=1)) ** 2
        return 1.0 - jnp.sum(w_s * f)

    return J_T_sm_ensemble


def gate_functional(J_T_U, **kwargs):
    """Lift a functional of the logical gate ``U_L`` (matrix ``(K, K)`` with
    ``(U_L)_ij = ⟨φ_i|Ψ_j(T)⟩``) to a standard ``J_T(Psi, trajectories)``.

    The basis states ``φ_i`` are the trajectories' initial states.
    """

    def J_T(Psi, trajectories, tau=None):
        basis = jnp.stack(
            [jnp.asarray(t.initial_state) for t in trajectories]
        )
        U_L = jnp.einsum("id,jd->ij", jnp.conj(basis), Psi)
        return J_T_U(U_L, **kwargs)

    return J_T


def make_gate_chi(J_T_U, trajectories, **kwargs):
    """``chi`` for a gate functional via AD and the chain rule
    ``χ_k = -½ Σ_i (∇_{U_L} J_T)_ik |φ_i⟩`` (background.md Eq. (chi_gate))."""

    def chi(Psi, trajectories, tau=None):
        basis = jnp.stack(
            [jnp.asarray(t.initial_state) for t in trajectories]
        )

        def scalar(U_L):
            return J_T_U(U_L, **kwargs)

        U_L = jnp.einsum("id,jd->ij", jnp.conj(basis), Psi)
        nabla = jax.grad(scalar)(U_L)  # complex gradient, 2 ∂J/∂U
        # χ_k = -½ Σ_i conj(∂J/∂U*_ik)... with jax convention:
        # jax.grad returns conj(2 ∂J/∂U*); we need -½ Σ_i (∇U J)_ik φ_i with
        # ∇U J the Zygote-style gradient = conj(jax.grad).
        return -0.5 * jnp.einsum("ik,id->kd", jnp.conj(nabla), basis)

    return chi
