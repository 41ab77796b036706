"""First-order Krotov's method — a second in-repo optimization method.

The reference ecosystem pairs GRAPE.jl with Krotov.jl and tests
cross-method continuation in both directions with record continuity
(``/root/reference/test/test_tls_optimization.jl:417-482``); GRAPE.jl's
result object converts results from other methods
(``/root/reference/src/result.jl:137-147``).  Until round 5b the repo
only *accepted* duck-typed foreign results — this module provides the
actual second method, so Krotov→GRAPE and GRAPE→Krotov continuation is
exercised for real.

Algorithm (first-order Krotov, the Krotov.jl default): per iteration,

1. forward-propagate all trajectories under the current pulse, storing
   every state (the same jitted forward pass GRAPE uses);
2. co-states ``χ_k(T) = -∂J_T/∂⟨Ψ_k(T)|`` (the shared semi-AD ``chi``),
   propagated backward under the current pulse, storing ``χ_k(t_n)``;
3. a *sequential* forward sweep: at each interval ``n`` the pulse
   update ``Δε_l(n) = (S_l(t_n)/λ_a) · Im Σ_k ⟨χ_k(t_n)|μ_l|Ψ_k(t_n)⟩``
   is computed from the state propagated under the ALREADY-UPDATED
   pulse, then the state advances one step with the new value — the
   self-consistent update that makes Krotov monotonically convergent.

JAX shape: steps 1–3 are ONE jitted program per iteration; the
sequential sweep is a ``lax.scan`` whose carry is the state block
(the time axis is inherently sequential here, exactly like the GRAPE
forward scan).  Complex outputs are packed as real/imag pairs, like
every program output.  Krotov is a parity/continuation feature, not
the performance path.
"""

import datetime
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .controls import discretize, discretize_on_midpoints
from .fg import (
    CompiledProblem, _chi_boundary, _chi_prop_scan, _coeff_tables,
    _evaluate_forward, _pertraj_ops, _step_ops, compile_problem,
    pack_complex, unpack_complex,
)
from .functionals import taus
from .ops.expm import expm
from .optimize import apply_convergence_check
from .result import GrapeResult

__all__ = ["optimize_krotov", "KrotovResult"]


class KrotovResult(GrapeResult):
    """Result of a Krotov optimization.  Same protocol as
    :class:`GrapeResult` (so ``optimize(..., continue_from=kres)``
    converts it via ``GrapeResult.from_result``, the reference's
    ``Base.convert(GrapeResult, r)``)."""

    method = "krotov"


def _H_at(cp: CompiledProblem, tables, n, eps_n, cdtype):
    """Generator ``H_n`` at interval ``n`` for NEW per-interval pulse
    values ``eps_n (L,)`` (the sweep's already-updated pulse; the old
    pulse's precomputed coefficient table cannot be used here)."""
    _c, _dM, H0_, ops_ = tables
    M_ = jnp.asarray(cp.M)
    Mfix_ = jnp.asarray(cp.Mfix)
    if not cp.shared_generator:
        H0x, opsx = _pertraj_ops(cp, H0_, ops_)
    if cp.per_traj_coeffs:
        c = (
            jnp.einsum("ktl,l->kt", M_[:, n], eps_n) + Mfix_[:, n]
        ).astype(cdtype)
        return H0x + jnp.einsum("kt,ktij->kij", c, opsx)
    c = (M_[n] @ eps_n + Mfix_[n]).astype(cdtype)
    if cp.shared_generator:
        return H0_[0] + jnp.einsum("t,tij->ij", c, ops_[0])
    return H0x + jnp.einsum("t,ktij->kij", c, opsx)


def _build_krotov_step(cp: CompiledProblem, S_tab, lam):
    """One jitted Krotov iteration: ``flat_pulse -> (J_T_old, eps_new,
    J_T_new, tau_new_packed, psi_T_new_packed)``."""
    cdtype = cp.psi0.dtype
    rdtype = np.asarray(cp.tlist).dtype
    K = cp.n_traj
    dt = jnp.diff(jnp.asarray(cp.tlist))
    S_j = jnp.asarray(S_tab, dtype=rdtype)          # (L, N_T)
    lam_j = jnp.asarray(lam, dtype=rdtype)          # (L,)
    psi0_j = jnp.asarray(cp.psi0)

    def step(flat):
        eps = jnp.reshape(flat, (cp.n_controls, cp.n_timesteps)).astype(
            rdtype
        )
        tables = _coeff_tables(cp, eps)
        storage, _ck, psi_T, parts, _Us = _evaluate_forward(
            cp, None, flat, tables=tables
        )
        J_T_old = parts[0]
        tau_old = parts[3]
        chi_T = _chi_boundary(cp, psi_T, tau_old)
        ones = jnp.ones((K,), dtype=rdtype)
        # backward χ chain under the OLD pulse (pds=None → plain
        # adjoint-ExpProp steps; chis[n] = χ(t_{n+1}), carry = χ(t_0))
        chis, chi0 = _chi_prop_scan(
            cp, None, tables, storage[:-1], chi_T, ones
        )
        chi_start = jnp.concatenate([chi0[None], chis[:-1]], axis=0)

        def body(psi, n):
            _H_old, mu = _step_ops(cp, n, tables, cdtype)
            mv = jnp.einsum("klij,kj->kli", mu, psi)
            ovl = jnp.einsum("ki,kli->l", jnp.conj(chi_start[n]), mv)
            d_eps = (S_j[:, n] / lam_j) * jnp.imag(ovl)
            eps_n = eps[:, n] + d_eps
            H = _H_at(cp, tables, n, eps_n, cdtype)
            U = expm((-1j * dt[n]).astype(cdtype) * H)
            if U.ndim == 2:
                psi2 = jnp.einsum("ij,kj->ki", U, psi)
            else:
                psi2 = jnp.einsum("kij,kj->ki", U, psi)
            return psi2, eps_n

        psi_T_new, eps_cols = lax.scan(
            body, psi0_j, jnp.arange(cp.n_timesteps)
        )
        eps_new = eps_cols.T  # (L, N_T)
        if cp.has_targets:
            tau_new = taus(psi_T_new, cp.trajectories)
        else:
            tau_new = jnp.zeros((K,), dtype=cdtype)
        if cp.J_T_takes_tau:
            J_T_new = cp.J_T(psi_T_new, cp.trajectories, tau=tau_new)
        else:
            J_T_new = cp.J_T(psi_T_new, cp.trajectories)
        return (
            jnp.real(J_T_old),
            eps_new,
            jnp.real(J_T_new),
            pack_complex(tau_new),
            pack_complex(psi_T_new),
        )

    return jax.jit(step)


def optimize_krotov(
    trajectories, tlist, *, lambda_a=5.0, update_shape=None,
    iter_stop=50, callback=None, check_convergence=None,
    print_iters=True, store_iter_info=None, continue_from=None,
    rethrow_exceptions=False, **kwargs,
):
    """Krotov's method over the same problem surface as
    :func:`grape_tpu.optimize` (trajectories, tlist, ``J_T``, amplitude
    models, shared/per-trajectory generators).

    Args:
      lambda_a: inverse update step weight λ_a (scalar or per-control
        sequence).  Larger = smaller, safer (monotonic) updates.
      update_shape: ``S(t) ∈ [0, 1]`` scaling of the update (callable or
        one per control), sampled on interval midpoints — Krotov.jl's
        ``update_shape`` pulse option.  Default: constant 1.
      iter_stop / callback / check_convergence / print_iters /
        store_iter_info / continue_from: as in :func:`optimize`.

    Limitations (documented scope): no state-dependent running cost
    (``g_b``/``xi``), no nonlinear ``CustomAmplitude`` terms, no box
    bounds (Krotov's update is unconstrained; use GRAPE for bounds —
    continuation between the two is the supported workflow).
    """
    trajectories = list(trajectories)
    kwargs.pop("optimizer", None)
    # Krotov's per-step update re-derives H_n from the freshly updated
    # pulse inside the sweep; the step propagator is always the exact
    # dense expm (prop-method kwargs are accepted for API compatibility
    # but the sweep does not run Chebyshev/Newton series)
    compile_kwargs = dict(kwargs)
    for k in ("prop_method", "fw_prop_method", "bw_prop_method",
              "grad_prop_method"):
        compile_kwargs.pop(k, None)
    # the sweep consumes the full forward storage (χ(t_n) against every
    # ψ(t_n)); the O(√N_T) recompute mode is a GRAPE-path feature
    compile_kwargs.pop("storage_mode", None)
    compile_kwargs.pop("storage_segments", None)
    cp = compile_problem(
        trajectories, tlist, **compile_kwargs
    )
    if cp.g_b is not None or cp.xi is not None:
        raise NotImplementedError(
            "optimize_krotov does not support state-dependent running "
            "costs (g_b/xi); use optimize() [GRAPE]"
        )
    if cp.custom_terms:
        raise NotImplementedError(
            "optimize_krotov requires amplitudes linear in the controls"
        )
    L, N_T = cp.n_controls, cp.n_timesteps
    lam = np.broadcast_to(
        np.asarray(lambda_a, dtype=np.float64), (L,)
    ).copy()
    if np.any(lam <= 0):
        raise ValueError("lambda_a must be positive")
    tl = np.asarray(cp.tlist, dtype=np.float64)
    tmid = 0.5 * (tl[:-1] + tl[1:])
    tmid[0], tmid[-1] = tl[0], tl[-1]
    S_tab = np.ones((L, N_T))
    if update_shape is not None:
        shapes_ = (
            list(update_shape) if isinstance(update_shape, (list, tuple))
            else [update_shape] * L
        )
        for l, s in enumerate(shapes_):
            S_tab[l] = [float(s(t)) for t in tmid]

    result_kwargs = dict(kwargs)
    result_kwargs["iter_stop"] = iter_stop
    if continue_from is not None:
        result = continue_from
        if not isinstance(result, KrotovResult):
            result = KrotovResult.from_result(
                result, trajectories, tlist, result_kwargs
            )
        result.iter_stop = iter_stop
        result.converged = False
        result.message = "in progress"
        result.start_local_time = datetime.datetime.now()
        pulsevals = np.concatenate([
            discretize_on_midpoints(c, result.tlist)
            for c in result.optimized_controls
        ])
        iter_offset = int(result.iter)
    else:
        result = KrotovResult(trajectories, tlist, result_kwargs)
        pulsevals = cp.guess_pulsevals.reshape(-1).copy()
        iter_offset = 0

    step = _build_krotov_step(cp, S_tab, lam)
    labels = list(store_iter_info or [])

    def record(i, J, dJ, secs):
        row = []
        for lab in labels:
            if lab == "iter.":
                row.append(i)
            elif lab == "J_T":
                row.append(J)
            elif lab in ("ΔJ", "ΔJ_T"):
                row.append(dJ)
            elif lab == "secs":
                row.append(secs)
            else:
                raise ValueError(
                    f"Unsupported store_iter_info label {lab!r} for "
                    "Krotov (supported: iter., J_T, ΔJ, ΔJ_T, secs)"
                )
        if row:
            result.records.append(tuple(row))

    if print_iters:
        print(" iter.        J_T         ΔJ    secs")
    flat = np.asarray(pulsevals, dtype=np.float64)
    t_prev = time.perf_counter()
    try:
        for i in range(iter_offset + 1, iter_stop + 1):
            J_old, eps_new, J_new, tau_p, psi_p = step(flat)
            J_old = float(J_old)
            J_new = float(J_new)
            now = time.perf_counter()
            if i == iter_offset + 1:
                # iteration-0 row: the guess functional (reference
                # table semantics: row 0 is pre-update)
                result.J_T = J_old
                if print_iters:
                    print(f"{i - 1:6d}   {J_old:.2e}        n/a     "
                          f"{now - t_prev:.1f}")
                record(i - 1, J_old, None, now - t_prev)
                if callback is not None:
                    callback(result, i - 1)
            result.iter = i
            result.J_T_prev = J_old
            result.J_T = J_new
            result.f_calls += 1
            result.fg_calls += 1
            result.tau_vals = unpack_complex(np.asarray(tau_p))
            result.states = list(unpack_complex(np.asarray(psi_p)))
            result.optimized_controls = [
                discretize(
                    np.asarray(eps_new)[l], np.asarray(result.tlist)
                )
                for l in range(L)
            ]
            secs = time.perf_counter() - t_prev
            t_prev = time.perf_counter()
            result.secs = secs
            dJ = J_new - J_old
            if print_iters:
                print(f"{i:6d}   {J_new:.2e}   {dJ:+.2e}     "
                      f"{secs:.1f}")
            record(i, J_new, dJ, secs)
            if dJ > 1e-12 * max(1.0, abs(J_old)):  # above fp noise
                import warnings
                warnings.warn(
                    f"Krotov iteration {i} increased J_T by {dJ:.2e}: "
                    f"lambda_a={lam.max():g} is too small for a "
                    "monotonic update",
                    stacklevel=2,
                )
            flat = np.asarray(eps_new).reshape(-1)
            if callback is not None:
                callback(result, i)
            if check_convergence is not None:
                apply_convergence_check(result, check_convergence)
                if result.converged:
                    break
            if i >= iter_stop:
                result.converged = True
                result.message = "Reached maximum number of iterations"
    except Exception as exc:  # noqa: BLE001 — reference exception capture
        if rethrow_exceptions:
            raise
        result.message = f"Exception: {exc}"
    result.end_local_time = datetime.datetime.now()
    return result
