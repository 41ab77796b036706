"""The jitted GRAPE function-and-gradient device program.

This is the JAX re-design of the reference's hot path
(``evaluate_functional`` at ``/root/reference/src/optimize.jl:665-768`` and
``evaluate_gradient!`` at ``src/optimize.jl:824-1014``).  Where the reference
runs per-trajectory propagator objects under a thread loop, here the whole
function-and-gradient evaluation is ONE jitted program:

- forward: ``lax.scan`` over the ``N_T`` time steps, each step a batched
  ``expm(-i H_kn dt_n) @ Ψ_k`` over all ``K`` trajectories (batched
  matmuls), storing every intermediate state (the reference's ``fw_storage``);
- co-states: ``χ_k(T) = -∂J_T/∂⟨Ψ_k(T)|`` by analytic formula or ``jax.grad``
  semi-AD, plus the ``λ_b (dt/2) ξ`` boundary term for state running costs;
- backward: ``lax.scan`` down the time axis, per step either the batched
  augmented-expm Fréchet kernel (``gradient_method="gradgen"``) or the Taylor
  recursion (``"taylor"``), accumulating
  ``∇τ_{knl} = ρ_k ⟨χ'_{kl}(t_{n-1})|Ψ_k(t_{n-1})⟩`` and injecting the
  inhomogeneity ``λ_b Δt ξ/ρ_k`` (``src/optimize.jl:897-908``);
- assembly: ``(∇J_Tb)_{nl} = -2 Re Σ_k ∇τ_{knl}`` (``src/optimize.jl:574-584``)
  plus ``λ_a ∇J_a``.

The trajectory axis ``K`` is a plain batch axis throughout, so the same
program shards over a device mesh by sharding ``K`` (see
``grape_tpu.parallel``); the cross-trajectory sums then lower to ``psum``
collectives.
"""

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from jax.sharding import PartitionSpec as P

from .config import complex_dtype, real_dtype
from .controls import discretize_on_midpoints, get_controls
from .functionals import accepts_tau, make_chi, make_grad_J_a, make_xi, taus
from .ops.cheby import cheby_apply, cheby_coeffs, spectral_envelope
from .ops.expm import expm, taylor_order_for_bound
from .ops.frechet import gradgen_step, taylor_grad_step
from .ops.newton import arnoldi_expmv

__all__ = ["CompiledProblem", "compile_problem", "build_fg", "build_f"]

# dimension gate for the static-operator H-apply decomposition in the
# vectorized taylor backward (module-level so benchmarks can A/B it)
_STATIC_H_MIN_DIM = 128


@dataclass
class CompiledProblem:
    """Static arrays + closures defining one GRAPE problem on device.

    The reference's ``GrapeWrk`` holds mutable propagators and storage
    (``src/workspace.jl:78-362``); here everything static is baked into
    arrays once, and the per-evaluation state is purely functional.
    """

    psi0: Any          # (K, d) complex
    H0: Any            # (K, d, d) complex
    ops: Any           # (K, T, d, d) complex control-term operators
    M: Any             # (N_T, T, L) real: coeffs_n = M[n] @ eps_n
                       # ((K, N_T, T, L) when per_traj_coeffs)
    Mfix: Any          # (N_T, T) real: fixed (locked-amplitude) coefficients
                       # ((K, N_T, T) when per_traj_coeffs)
    tlist: Any         # (N_T+1,) real
    trajectories: list
    controls: tuple
    guess_pulsevals: Any   # (L, N_T) float64 numpy
    n_controls: int
    n_timesteps: int
    dim: int
    n_traj: int
    J_T: Callable = None
    chi: Callable = None
    J_a: Callable = None
    grad_J_a: Callable = None
    lambda_a: float = 1.0
    g_b: Callable = None
    xi: Callable = None
    lambda_b: float = 1.0
    gradient_method: str = "gradgen"
    taylor_grad_max_order: int = 100
    taylor_grad_tolerance: float = 1e-16
    taylor_grad_check_convergence: bool = True
    chi_min_norm: float = 1e-100
    J_T_takes_tau: bool = False
    chi_takes_tau: bool = False
    has_targets: bool = False
    prop_method: str = "expprop"
    fw_prop_method: str = "expprop"
    bw_prop_method: str = "expprop"
    grad_prop_method: str = "expprop"
    cheby_tol: float = 1e-14
    storage_mode: str = "full"
    storage_segments: int = 0
    newton_m: int = 30
    newton_substeps: int = 1
    ctl_idx: tuple = ()  # static control index per term (None = locked)
    reuse_propagators: Any = "auto"
    vectorize_backward: bool = True
    # per-step forward-propagation observables (reference fw_prop callback,
    # src/optimize.jl:733-737): functions (Psi (K,d), tlist, n) -> array,
    # evaluated inside the jitted program over the stored states
    fw_prop_callback: Callable = None
    fw_prop_observables: tuple = ()
    # all trajectories evolve under the SAME generator (gate optimization:
    # K basis states, one H) — U_n is computed once per step, not per k
    shared_generator: bool = False
    # host-side operator norms cached at compile time (so envelope math
    # never needs device->host transfers once the arrays are sharded):
    # {"h0": ||H0||_1 max over k, "ops": (T,) per-term ||Op_j||_1 max over k}
    norm_cache: Any = None
    # general (nonlinear) amplitude protocol — reference get_control_derivs
    # (src/workspace.jl:285-286) / per-step evaluate (src/optimize.jl:946-957):
    # ((j, CustomAmplitude, ctl_indices), ...); the per-interval coefficient
    # and ∂a/∂ε tables become traced functions of the pulse (_coeff_tables)
    custom_terms: tuple = ()
    # heterogeneous ensembles whose members share the control coupling
    # structure but differ in amplitude SHAPES: M/Mfix carry a leading
    # per-trajectory K axis (reference: each trajectory owns its
    # propagators, src/workspace.jl:221-233)
    per_traj_coeffs: bool = False
    # memo for the host-side coefficient envelope (keyed by amp_max):
    # CustomAmplitude envelopes are SAMPLED — the memo keeps that out of
    # traced program bodies (build_f/build_fg pre-warm it)
    env_cache: Any = field(default_factory=dict)
    # contiguous-run generator grouping (gate ensembles: each sample's
    # n_basis trajectories share ONE generator object): the ExpProp
    # paths then derive the expm once per (step, group) instead of per
    # (step, trajectory).  1 = no grouping.
    gen_group_size: int = 1
    # operator STORAGE layout: True = H0/ops hold ONE entry per
    # generator group (K/gen_group_size entries) instead of one per
    # trajectory — a group_size-fold cut of the embedded program
    # constants (at the 1024-sample BASELINE config-5 letter the
    # per-trajectory operator stack alone is 1.6 GB).  Consumers
    # needing per-trajectory entries expand via _pertraj_ops.
    ops_grouped: bool = False
    # set by parallel.mesh.shard_problem: the device mesh and the mesh
    # axis name(s) the trajectory axis shards over (the grouped paths
    # read the per-shard trajectory count from them)
    mesh: Any = None
    mesh_axis: Any = None

    @property
    def dt(self):
        return jnp.diff(self.tlist)


def compile_problem(
    trajectories,
    tlist,
    *,
    J_T,
    chi=None,
    J_a=None,
    grad_J_a=None,
    lambda_a=1.0,
    g_b=None,
    xi=None,
    lambda_b=1.0,
    gradient_method="gradgen",
    taylor_grad_max_order=100,
    taylor_grad_tolerance=1e-16,
    taylor_grad_check_convergence=True,
    chi_min_norm=1e-100,
    dtype=None,
    prop_method=None,
    fw_prop_method=None,
    bw_prop_method=None,
    grad_prop_method=None,
    cheby_tol=1e-14,
    storage_mode="full",
    storage_segments=None,
    newton_m=30,
    newton_substeps=1,
    reuse_propagators="auto",
    vectorize_backward=True,
    fw_prop_callback=None,
    fw_prop_observables=None,
    _controls=None,
    **_ignored,
):
    """Compile trajectories + tlist into a :class:`CompiledProblem`.

    Mirrors the workspace construction at
    ``/root/reference/src/workspace.jl:147-362``: extract the distinct
    controls, discretize them on the interval midpoints into the guess pulse
    vector, stack all trajectory data along the batch axis, and build the
    static per-interval coefficient tensor ``M``.
    """
    trajectories = list(trajectories)
    tlist = np.asarray(tlist, dtype=np.float64)
    N_T = len(tlist) - 1
    K = len(trajectories)
    if K == 0:
        raise ValueError("no trajectories")

    prop_method, fw_prop_method, bw_prop_method, grad_prop_method = (
        _merge_traj_prop_settings(
            trajectories, prop_method, fw_prop_method, bw_prop_method,
            grad_prop_method,
        )
    )

    generators = [t.generator for t in trajectories]
    # _controls: the heterogeneous grouped-compile builder passes the
    # GLOBAL control list so every partition shares one pulse layout
    # (a partition's generators may reference only a subset)
    controls = (
        tuple(_controls) if _controls is not None
        else get_controls(generators)
    )
    L = len(controls)
    if L == 0:
        raise ValueError(
            # exact reference wording (test/test_empty_optimization.jl:36)
            "no controls in trajectories: cannot optimize"
        )
    guess = np.stack(
        [discretize_on_midpoints(c, tlist) for c in controls]
    )  # (L, N_T)

    cdtype = complex_dtype(dtype) if dtype is not None else complex_dtype(
        jnp.result_type(float)
    )

    # Heterogeneous ensembles: the batched design needs slot-aligned term
    # lists (same count, same control coupling per slot).  Generators that
    # differ structurally — e.g. a robustness ensemble where only some
    # members carry a crosstalk drive — are auto-aligned to the union of
    # their amplitudes with zero-operator padding (the reference accepts
    # arbitrary per-trajectory generators because each trajectory owns its
    # propagators, /root/reference/src/workspace.jl:221-233).
    from .generators import align_generators

    if not _slots_aligned(generators, controls):
        generators = align_generators(generators)
    n_terms = len(generators[0].terms)
    dim = generators[0].dim

    # Coefficient tensor M (N_T, T, L): term j couples to control l_j with
    # per-interval weight shape_j[n].  Locked terms (no control) contribute
    # through the fixed-coefficient table Mfix instead.  When trajectories
    # use per-trajectory amplitude SHAPES (same control, different static
    # weight), M/Mfix grow a leading K axis instead of blowing up the
    # operator array through union-padding.
    g0 = generators[0]
    ctl_idx = g0.term_control_indices(controls)
    coeff_tables = [g.coefficient_tables(tlist, controls)
                    for g in generators]
    M, Mfix = coeff_tables[0]
    per_traj_coeffs = any(
        not (np.array_equal(Mk, M) and np.array_equal(Mfk, Mfix))
        for (Mk, Mfk) in coeff_tables[1:]
    )
    if per_traj_coeffs:
        M = np.stack([Mk for (Mk, _) in coeff_tables])      # (K, N_T, T, L)
        Mfix = np.stack([Mfk for (_, Mfk) in coeff_tables])  # (K, N_T, T)
    # nonlinear amplitude slots (identical across k after alignment)
    custom_terms = tuple(g0.custom_terms(controls))

    # gate-optimization detection: one generator, K basis states — then
    # U_n is shared across trajectories and the propagator work drops
    # K-fold.  Shared operator arrays are stored with a LENGTH-1 leading
    # axis (never K-tiled): at K=64, dim=1024 the tile alone is 2.1 GB of
    # host memory, embedded again in the program as constants.
    # Contiguous identical-OBJECT generator runs (gate ensembles: each
    # sample's basis states share one generator) likewise store ONE
    # entry per group (`ops_grouped`) — the per-trajectory stack at the
    # 1024-sample config-5 letter is 1.6 GB of constants.
    same_gen = all(g is g0 for g in generators)
    grun = 1
    if not same_gen and not per_traj_coeffs:
        grun = _gen_group_runs(generators)
        if grun <= 1 or K % grun != 0:
            grun = 1
    if same_gen and not per_traj_coeffs:
        stack_gens = generators[:1]
    elif grun > 1:
        stack_gens = generators[::grun]
    else:
        stack_gens = generators
    H0 = np.stack([g.drift for g in stack_gens]).astype(cdtype)
    if n_terms > 0:
        ops = np.stack(
            [np.stack([op for (op, _) in g.terms]) for g in stack_gens]
        ).astype(cdtype)  # (K, groups, or 1, T, d, d)
    else:
        ops = np.zeros((len(stack_gens), 0, dim, dim), dtype=cdtype)
    shared_generator = not per_traj_coeffs and (
        same_gen
        or (bool(np.all(H0 == H0[:1])) and bool(np.all(ops == ops[:1])))
    )
    if shared_generator and H0.shape[0] > 1:
        H0 = np.ascontiguousarray(H0[:1])
        ops = np.ascontiguousarray(ops[:1])
    ops_grouped = grun > 1 and not shared_generator

    psi0 = np.stack([t.initial_state for t in trajectories]).astype(cdtype)
    has_targets = all(t.target_state is not None for t in trajectories)

    if chi is None:
        chi = make_chi(J_T, trajectories)
    if J_a is not None and grad_J_a is None:
        grad_J_a = make_grad_J_a(J_a, tlist)
    g_b_given = g_b is not None
    if lambda_b == 0 and g_b is not None:
        # reference sanity warning (src/workspace.jl:316-320)
        import warnings
        warnings.warn("Argument `g_b` was given with `lambda_b = 0.0`. Ignoring")
        g_b = None
        xi = None
    if g_b is not None and xi is None:
        xi = make_xi(g_b, trajectories)
    if not g_b_given and xi is not None:
        import warnings
        warnings.warn("Argument `xi` was given without `g_b`. Ignoring")
        xi = None

    rdtype = real_dtype(cdtype)
    # arrays stay host-side numpy: jit embeds them as constants, and the
    # host-side envelope/norm machinery reads them without a device fetch
    # (parallel.shard_problem moves them onto a mesh as arguments)
    cp = CompiledProblem(
        psi0=np.asarray(psi0),
        H0=np.asarray(H0),
        ops=np.asarray(ops),
        M=np.asarray(M, dtype=rdtype),
        Mfix=np.asarray(Mfix, dtype=rdtype),
        tlist=np.asarray(tlist, dtype=rdtype),
        trajectories=trajectories,
        controls=controls,
        guess_pulsevals=guess,
        n_controls=L,
        n_timesteps=N_T,
        dim=dim,
        n_traj=K,
        J_T=J_T,
        chi=chi,
        J_a=J_a,
        grad_J_a=grad_J_a,
        lambda_a=float(lambda_a),
        g_b=g_b,
        xi=xi,
        lambda_b=float(lambda_b),
        gradient_method=(
            "gradgen" if gradient_method == "auto" else gradient_method
        ),
        taylor_grad_max_order=int(taylor_grad_max_order),
        taylor_grad_tolerance=float(taylor_grad_tolerance),
        taylor_grad_check_convergence=bool(taylor_grad_check_convergence),
        chi_min_norm=float(chi_min_norm),
        J_T_takes_tau=accepts_tau(J_T) and has_targets,
        chi_takes_tau=accepts_tau(chi) and has_targets,
        has_targets=has_targets,
        prop_method=_normalize_prop_method(prop_method),
        fw_prop_method=_normalize_prop_method(
            fw_prop_method if fw_prop_method is not None else prop_method
        ),
        bw_prop_method=_normalize_prop_method(
            bw_prop_method if bw_prop_method is not None else prop_method
        ),
        grad_prop_method=_normalize_prop_method(
            grad_prop_method if grad_prop_method is not None else prop_method
        ),
        cheby_tol=float(cheby_tol),
        storage_mode=storage_mode,
        storage_segments=_pick_segments(storage_mode, storage_segments, N_T),
        newton_m=int(newton_m),
        newton_substeps=int(newton_substeps),
        ctl_idx=tuple(ctl_idx),
        custom_terms=custom_terms,
        per_traj_coeffs=per_traj_coeffs,
        reuse_propagators=reuse_propagators,
        vectorize_backward=bool(vectorize_backward),
        fw_prop_callback=_check_fw_prop_callback(
            fw_prop_callback, storage_mode
        ),
        fw_prop_observables=tuple(fw_prop_observables or ()),
        shared_generator=shared_generator,
        # identity-run grouping stores group-level arrays; the legacy
        # content-equality detection (equal arrays, distinct objects)
        # keeps per-trajectory storage with sliced group access
        gen_group_size=(
            grun if ops_grouped else _detect_gen_group_size(
                trajectories, np.asarray(H0), np.asarray(ops),
                per_traj_coeffs, shared_generator,
            )
        ),
        ops_grouped=ops_grouped,
        norm_cache=_make_norm_cache(
            H0, ops,
            with_spectral="cheby" in (
                _normalize_prop_method(prop_method),
                _normalize_prop_method(
                    fw_prop_method if fw_prop_method is not None
                    else prop_method
                ),
                _normalize_prop_method(
                    bw_prop_method if bw_prop_method is not None
                    else prop_method
                ),
                _normalize_prop_method(
                    grad_prop_method if grad_prop_method is not None
                    else prop_method
                ),
            ),
        ),
    )
    if gradient_method == "auto":
        # gradgen wherever the time-vectorized rank-1 Fréchet path serves
        # (ExpProp propagation, dim <= 128); outside that regime
        # (Chebyshev propagation, large dims) the per-step extended-state
        # gradgen costs d^3 per direction and the taylor recursion is
        # cheaper
        if cp.dim > 128 or not _vec_gradgen_enabled(cp):
            cp.gradient_method = "taylor"
    return cp


def _gen_group_runs(gens):
    """Contiguous identical-object run length if uniform, else 1."""
    runs = []
    cur = 1
    for a, b in zip(gens, gens[1:]):
        if b is a:
            cur += 1
        else:
            runs.append(cur)
            cur = 1
    runs.append(cur)
    g = runs[0]
    if g > 1 and all(r == g for r in runs):
        return g
    return 1


def _detect_gen_group_size(trajectories, H0, ops, per_traj_coeffs,
                           shared_generator):
    """Group size for the grouped ExpProp paths: contiguous runs
    of trajectories sharing one generator (verified against the stacked
    operator arrays)."""
    if shared_generator or per_traj_coeffs:
        return 1
    K = len(trajectories)
    g = _gen_group_runs([t.generator for t in trajectories])
    if g <= 1 or K % g != 0:
        return 1
    H0v = H0.reshape(K // g, g, *H0.shape[1:])
    opsv = ops.reshape(K // g, g, *ops.shape[1:])
    if not (
        bool(np.all(H0v == H0v[:, :1]))
        and bool(np.all(opsv == opsv[:, :1]))
    ):
        return 1
    return g


_PROP_SETTING_KEYS = (
    "prop_method", "fw_prop_method", "bw_prop_method", "grad_prop_method"
)


def _merge_traj_prop_settings(trajectories, *given):
    """Resolve per-trajectory propagator settings (the reference reads
    ``prop_method``/``fw_prop_method``/... from trajectory attributes as
    well as kwargs, ``/root/reference/src/workspace.jl:216-233,246-282``,
    spec ``src/docstring.jl:201-225``).

    This build batches ALL trajectories through one jitted
    propagation program, so per-trajectory-HETEROGENEOUS methods (e.g.
    Cheby for one ensemble member, ExpProp for another) cannot be
    honored — that case raises a clear error instead of silently using
    the global setting (documented deviation).  A setting carried UNIFORMLY by every trajectory is adopted when
    no conflicting global kwarg was given."""
    out = list(given)
    K = len(trajectories)
    for i, key in enumerate(_PROP_SETTING_KEYS):
        vals = [
            t.kwargs[key] for t in trajectories
            if getattr(t, "kwargs", None) and key in t.kwargs
        ]
        if not vals:
            continue
        norm = {_normalize_prop_method(v) for v in vals}
        # what the trajectories WITHOUT the attribute resolve to: the
        # global kwarg, falling back to prop_method, then the default
        base = out[i]
        if base is None and key != "prop_method":
            base = out[0]
        eff_default = _normalize_prop_method(base)  # None -> "expprop"
        partial_hetero = (
            len(vals) < K and norm != {eff_default}
        )
        if len(norm) > 1 or partial_hetero:
            raise NotImplementedError(
                f"per-trajectory-heterogeneous propagator settings in a "
                f"SINGLE compiled program are not supported: "
                f"trajectories specify {key} in {sorted(norm)} "
                f"({len(vals)}/{K} trajectories carry the attribute).  "
                "Use the driver (grape_tpu.optimize), which partitions "
                "such ensembles into uniform sub-programs with global "
                "functional assembly (fg_hetero.compile_heterogeneous; "
                "reference per-trajectory propagators: "
                "src/workspace.jl:216-233), or pass one global "
                f"{key}= here"
            )
        val = vals[0]
        base = out[i]
        if base is not None and (
            _normalize_prop_method(base) != _normalize_prop_method(val)
        ):
            raise ValueError(
                f"trajectory attribute {key}={val!r} conflicts with "
                f"the global {key}={base!r} keyword argument"
            )
        out[i] = val
    return tuple(out)


def _make_norm_cache(H0, ops, with_spectral=False):
    """Host-side operator norms (and, for Chebyshev, per-trajectory
    spectral data) captured while the arrays are still host numpy."""
    K = H0.shape[0]
    cache = {
        "h0": max(
            float(np.abs(H0[k]).sum(axis=0).max()) for k in range(K)
        ),
        "ops": np.asarray([
            max(
                float(np.abs(ops[k, j]).sum(axis=0).max())
                for k in range(K)
            )
            for j in range(ops.shape[1])
        ]),
    }
    if with_spectral:
        eig_lo = np.empty(K)
        eig_hi = np.empty(K)
        op2 = np.empty((K, ops.shape[1]))
        for k in range(K):
            w = np.linalg.eigvalsh(0.5 * (H0[k] + H0[k].conj().T))
            eig_lo[k], eig_hi[k] = w[0], w[-1]
            for j in range(ops.shape[1]):
                op2[k, j] = np.linalg.norm(ops[k, j], 2)
        cache["spec"] = {"eig_lo": eig_lo, "eig_hi": eig_hi, "op2": op2}
    return cache



def _slots_aligned(generators, controls):
    """True when all generators share a slot-aligned term structure: same
    dimension, same term count, slot-wise the same control coupling, and
    slot-wise the SAME object for nonlinear (CustomAmplitude) slots.
    Linear slots may differ in amplitude shape/operator across
    trajectories (handled by per-trajectory coefficient tables)."""
    from .amplitudes import CustomAmplitude

    g0 = generators[0]
    idx0 = g0.term_control_indices(controls)
    for g in generators[1:]:
        if g.dim != g0.dim or len(g.terms) != len(g0.terms):
            return False
        if g.term_control_indices(controls) != idx0:
            return False
        for (_, a), (_, a0) in zip(g.terms, g0.terms):
            c, c0 = (
                isinstance(a, CustomAmplitude),
                isinstance(a0, CustomAmplitude),
            )
            if c != c0 or (c and a is not a0):
                return False
    return True


def _coeff_tables(cp: CompiledProblem, eps):
    """Per-interval term coefficients and their control derivatives for
    the CURRENT pulse values ``eps (L, N_T)``:

        ``(coeffs_all, dM)`` with shapes ``(N_T, T)`` / ``(N_T, T, L)``
        (leading ``K`` axis when ``cp.per_traj_coeffs``).

    For linear amplitudes these are the static tables ``M @ ε + Mfix`` /
    ``M``; ``CustomAmplitude`` slots are traced per-step evaluations of
    ``a(ε_n, t_n)`` and the chain-rule factor ``∂a/∂ε`` (the reference's
    per-step ``evaluate(μ; vals_dict)``, ``src/optimize.jl:946-957``).

    Items ``[2]``/``[3]`` carry the traced operator constants
    ``(H0_, ops_)`` — created HERE, once per ``_coeff_tables`` call, and
    threaded to every consumer so one program embeds the (potentially
    tens-of-MB) operator arrays once instead of once per phase."""
    M_ = jnp.asarray(cp.M)
    Mfix_ = jnp.asarray(cp.Mfix)
    H0_, ops_ = _op_constants(cp)
    if cp.per_traj_coeffs:
        coeffs = jnp.einsum("kntl,ln->knt", M_, eps) + Mfix_
    else:
        coeffs = jnp.einsum("ntl,ln->nt", M_, eps) + Mfix_
    dM = M_
    if not cp.custom_terms:
        return coeffs, dM, H0_, ops_
    tl = jnp.asarray(cp.tlist)
    # interval times: midpoints, except t=0 / t=T for the first / last
    # interval (reference convention, docs/src/background.md; same as
    # discretize_on_midpoints)
    tmid = (0.5 * (tl[:-1] + tl[1:])).at[0].set(tl[0]).at[-1].set(tl[-1])
    tmid = tmid.astype(eps.dtype)
    for j, amp, idxs in cp.custom_terms:
        vals = eps[jnp.asarray(idxs), :]  # (n_j, N_T)
        aj = jax.vmap(amp.func, in_axes=(1, 0))(vals, tmid)  # (N_T,)
        aj = jnp.reshape(aj, (cp.n_timesteps,)).astype(coeffs.dtype)
        dfun = amp.deriv
        if dfun is None:
            dfun = jax.jacfwd(amp.func, argnums=0)
        dj = jax.vmap(dfun, in_axes=(1, 0))(vals, tmid)
        dj = jnp.reshape(dj, (cp.n_timesteps, len(idxs))).astype(dM.dtype)
        if cp.per_traj_coeffs:
            coeffs = coeffs.at[:, :, j].set(aj[None, :])
            dM = dM.at[:, :, j, jnp.asarray(idxs)].set(dj[None])
        else:
            coeffs = coeffs.at[:, j].set(aj)
            dM = dM.at[:, j, jnp.asarray(idxs)].set(dj)
    return coeffs, dM, H0_, ops_


def _coeff_env(cp: CompiledProblem, amp_max):
    """Host-side envelope of the per-interval coefficients and their
    control derivatives over the pulse box ``|ε_l| ≤ amp_max_l``:
    ``(cmax (T,), dmax (T, L))`` numpy.  Feeds every static-envelope
    quantity (Chebyshev spectral range, Taylor order, squaring counts).
    Memoized per ``amp_max``: CustomAmplitude envelopes are sampled with
    eager jax calls, which must never run inside a traced program body —
    ``build_f``/``build_fg`` pre-warm the memo at build time."""
    amp_max = np.asarray(amp_max, dtype=np.float64)
    key = tuple(amp_max.ravel().tolist())
    if key in cp.env_cache:
        return cp.env_cache[key]
    absM = np.abs(np.asarray(cp.M))
    absMfix = np.abs(np.asarray(cp.Mfix))
    if cp.per_traj_coeffs:
        cmax = (
            np.einsum("kntl,l->knt", absM, amp_max) + absMfix
        ).max(axis=(0, 1))
        dmax = absM.max(axis=(0, 1))
    else:
        cmax = (np.einsum("ntl,l->nt", absM, amp_max) + absMfix).max(axis=0)
        dmax = absM.max(axis=0)
    for j, amp, idxs in cp.custom_terms:
        sub = amp_max[list(idxs)]
        if amp.bound is not None:
            ca, da = amp.bound(sub)
        else:
            if not getattr(amp, "_env_sample_warned", False):
                import warnings

                warnings.warn(
                    "CustomAmplitude envelope is being SAMPLED (17-point"
                    " grids / 256 random points x 1.25 margin): a spiky"
                    " amplitude between samples can under-size the"
                    " static Taylor order (the honest last-term check"
                    " catches divergence at the cost of re-jits)."
                    "  Supply CustomAmplitude(bound=...) for an analytic"
                    " envelope if a(eps, t) has high curvature."
                )
                amp._env_sample_warned = True
            ca, da = _sample_amp_env(amp, sub, np.asarray(cp.tlist))
        cmax[j] = float(ca)
        dmax[j, :] = 0.0
        dmax[j, list(idxs)] = np.asarray(
            da, dtype=np.float64
        ).reshape(-1)
    cp.env_cache[key] = (cmax, dmax)
    return cmax, dmax


def _warm_env_cache(cp: CompiledProblem, amp_max=None):
    """Pre-compute the coefficient envelopes a program build will need,
    OUTSIDE any trace (CustomAmplitude envelope sampling runs eager jax)."""
    if not cp.custom_terms:
        return
    _coeff_env(cp, 2.0 * _default_amp_max(cp))
    if amp_max is not None:
        _coeff_env(cp, np.asarray(amp_max, dtype=np.float64))


def _sample_amp_env(amp, amp_max, tlist, margin=1.25):
    """Envelope of ``|a|`` and ``|∂a/∂ε|`` for a CustomAmplitude by
    sampling the pulse box (×``margin`` safety factor; an envelope
    over-estimate only costs extra Taylor orders/squarings and stays
    mathematically exact).  Supply ``CustomAmplitude(bound=...)`` for an
    analytic envelope when extrema could fall between samples."""
    import itertools

    n = len(amp_max)
    amp_max = np.maximum(np.asarray(amp_max, dtype=np.float64), 1e-12)
    if n <= 2:
        axes = [np.linspace(-a, a, 17) for a in amp_max]
        pts = np.array(list(itertools.product(*axes)))
    else:
        rng = np.random.default_rng(0)
        pts = np.concatenate([
            rng.uniform(-1.0, 1.0, size=(256, n)) * amp_max,
            np.where(rng.uniform(size=(64, n)) < 0.5, -1.0, 1.0) * amp_max,
            np.diag(amp_max),
            -np.diag(amp_max),
            np.zeros((1, n)),
        ])
    from .controls import midpoints

    tmid = midpoints(tlist)
    if len(tmid) > 33:
        tmid = tmid[np.linspace(0, len(tmid) - 1, 33).astype(int)]
    dfun = amp.deriv
    if dfun is None:
        dfun = jax.jacfwd(amp.func, argnums=0)
    # evaluate on the host CPU backend: these are a few hundred tiny
    # eager evaluations feeding host-side numpy, not device work
    try:
        import contextlib

        cpu = jax.devices("cpu")[0]
        ctx = jax.default_device(cpu)
    except Exception:  # pragma: no cover - cpu backend always present
        import contextlib

        ctx = contextlib.nullcontext()
    with ctx:
        fv = jax.vmap(
            jax.vmap(amp.func, in_axes=(0, None)), in_axes=(None, 0)
        )
        dv = jax.vmap(
            jax.vmap(dfun, in_axes=(0, None)), in_axes=(None, 0)
        )
        av = np.asarray(fv(pts, tmid))          # (n_t, n_pts)
        gv = np.abs(np.asarray(dv(pts, tmid)))  # (n_t, n_pts, n)
    ca = float(np.max(np.abs(av)))
    da = gv.reshape(-1, n).max(axis=0)
    return margin * ca, margin * da


def _check_fw_prop_callback(fw_prop_callback, storage_mode):
    if fw_prop_callback is not None and storage_mode == "recompute":
        raise ValueError(
            "fw_prop_callback requires storage_mode='full' (the recompute "
            "mode does not materialize the per-step forward states)"
        )
    return fw_prop_callback


def _fw_observables(cp: CompiledProblem, storage):
    """Per-step observable values over the stored forward states.

    The reference invokes the ``fw_prop_`` callback after every
    ``prop_step!`` inside the propagation loop
    (``/root/reference/src/optimize.jl:733-737``); under jit the forward
    pass is one fused scan, so the observables are instead evaluated
    (vectorized over the whole time grid, inside the device program) on the
    stored states, and the host callback receives all per-step values at
    once after each evaluation — a documented deviation with identical
    information content.  With no explicit observables, the states
    themselves are passed (the reference's ``_StoreState()`` default)."""
    tlist_j = jnp.asarray(cp.tlist)
    ns = jnp.arange(cp.n_timesteps + 1)
    if not cp.fw_prop_observables:
        return (pack_complex(storage),)
    out = []
    for obs in cp.fw_prop_observables:
        vals = jax.vmap(lambda n, _o=obs: _o(storage[n], tlist_j, n))(ns)
        # packed real/imag planes, like every complex program output;
        # the host side unpacks to complex arrays uniformly
        out.append(pack_complex(vals.astype(cp.psi0.dtype)))
    return tuple(out)


def pack_complex(x):
    """Split a complex array into a stacked (2, ...) real array: every
    complex program output leaves the device in this form, and
    :func:`unpack_complex` reassembles it on the host."""
    return jnp.stack([jnp.real(x), jnp.imag(x)])


def unpack_complex(arr):
    arr = np.asarray(arr)
    return arr[0] + 1j * arr[1]


def _op_constants(cp: CompiledProblem):
    """``(H0_, ops_)`` as traced arrays.  For shared generators only the
    ``[:1]`` slice is embedded — keeping the length-1 leading axis so the
    shared code paths' ``[0]`` indexing is unchanged.  Embedding the
    K-tiled copies would inflate the program's constants K-fold (at
    K=64, dim=1024 the tiled operators alone are 2.1 GB)."""
    if cp.shared_generator:
        return jnp.asarray(cp.H0[:1]), jnp.asarray(cp.ops[:1])
    return jnp.asarray(cp.H0), jnp.asarray(cp.ops)


def _step_ops(cp: CompiledProblem, n, tables, cdtype):
    """(H_n (K,d,d), mu_n (K,L,d,d)) for time interval index ``n`` from
    the per-evaluation coefficient tables (see ``_coeff_tables``)."""
    coeffs_all, dM, H0_, ops_ = tables
    if not cp.shared_generator:
        H0_, ops_ = _pertraj_ops(cp, H0_, ops_)
    if cp.per_traj_coeffs:
        c = coeffs_all[:, n].astype(cdtype)  # (K, T)
        H = H0_ + jnp.einsum("kt,ktij->kij", c, ops_)
        mu = jnp.einsum("ktl,ktij->klij", dM[:, n].astype(cdtype), ops_)
    elif cp.shared_generator:
        # length-1 operator constants: compute once, broadcast to K (the
        # per-step fallback contract is (K, ...) blocks)
        c = coeffs_all[n].astype(cdtype)  # (T,)
        H1 = H0_[0] + jnp.einsum("t,tij->ij", c, ops_[0])
        mu1 = jnp.einsum("tl,tij->lij", dM[n].astype(cdtype), ops_[0])
        H = jnp.broadcast_to(H1, (cp.n_traj,) + H1.shape)
        mu = jnp.broadcast_to(mu1, (cp.n_traj,) + mu1.shape)
    else:
        c = coeffs_all[n].astype(cdtype)  # (T,)
        H = H0_ + jnp.einsum("t,ktij->kij", c, ops_)
        mu = jnp.einsum("tl,ktij->klij", dM[n].astype(cdtype), ops_)
    return H, mu



def _normalize_prop_method(prop_method):
    if prop_method is None:
        return "expprop"
    name = getattr(prop_method, "__name__", str(prop_method)).lower()
    if name in ("expprop", "exp", "expm"):
        return "expprop"
    if name in ("cheby", "chebyshev", "chebychev"):
        return "cheby"
    if name in ("newton", "krylov", "arnoldi"):
        return "newton"
    raise ValueError(f"Unknown prop_method: {prop_method!r}")


def _cheby_data(cp: CompiledProblem, amp_max):
    """Static Chebyshev data for a pulse-amplitude envelope `amp_max (L,)`.

    Mirrors the reference's re-initialization of the Cheby propagator with
    control-range hints (``src/optimize.jl:656-662,722``): the spectral
    envelope is derived from the amplitude bounds, and the per-step Bessel
    coefficient tables are computed on host so the jitted scan stays free of
    special functions.
    """
    import numpy as _np

    amp_max = _np.asarray(amp_max, dtype=_np.float64)
    cmax, _ = _coeff_env(cp, amp_max)  # (T,)
    spec = (cp.norm_cache or {}).get("spec")
    if spec is not None:
        # compile-time spectral cache: no device read-back needed once the
        # operator arrays live sharded on the mesh
        lo = spec["eig_lo"] - spec["op2"] @ cmax  # (K,)
        hi = spec["eig_hi"] + spec["op2"] @ cmax
        E_min, E_max = float(lo.min()), float(hi.max())
        span = max(E_max - E_min, 1e-12)
        E_min, E_max = E_min - 0.05 * span, E_max + 0.05 * span
    else:
        E_min, E_max = spectral_envelope(
            _np.asarray(cp.H0), _np.asarray(cp.ops), -cmax, cmax
        )
    dE = E_max - E_min
    shift = E_max + E_min  # normalization H_norm = (2H - shift)/dE
    dt = _np.diff(_np.asarray(cp.tlist, dtype=_np.float64))
    rows_fw, rows_bw, ph_fw, ph_bw = [], [], [], []
    for dtn in dt:
        alpha = 0.5 * dE * dtn
        rows_fw.append(cheby_coeffs(alpha, tol=cp.cheby_tol))
        rows_bw.append(cheby_coeffs(-alpha, tol=cp.cheby_tol))
        # overall phase e^{-i (dE/2 + E_min) dt} (forward), conj for backward
        ph = _np.exp(-1j * 0.5 * (E_max + E_min) * dtn)
        ph_fw.append(ph)
        ph_bw.append(_np.conj(ph))
    Kt = max(max(len(r) for r in rows_fw), max(len(r) for r in rows_bw))
    tab_fw = _np.zeros((len(dt), Kt), dtype=_np.complex128)
    tab_bw = _np.zeros((len(dt), Kt), dtype=_np.complex128)
    for n, (rf, rb) in enumerate(zip(rows_fw, rows_bw)):
        tab_fw[n, : len(rf)] = rf
        tab_bw[n, : len(rb)] = rb
    cdtype = cp.psi0.dtype
    # host-side numpy (like the problem arrays): traced closures convert
    # with jnp.asarray before indexing
    return {
        "dE": dE,
        "shift": shift,
        "tab_fw": _np.asarray(tab_fw, dtype=cdtype),
        "tab_bw": _np.asarray(tab_bw, dtype=cdtype),
        "ph_fw": _np.asarray(ph_fw, dtype=cdtype),
        "ph_bw": _np.asarray(ph_bw, dtype=cdtype),
    }


def _prop_data_for(cp: CompiledProblem, method, amp_max=None, cache=None):
    if cache is not None and method in cache:
        return cache[method]
    if method == "cheby":
        if amp_max is None:
            amp_max = 2.0 * _default_amp_max(cp)
        pd = _cheby_data(cp, amp_max)
        pd["kind"] = "cheby"
    elif method == "newton":
        pd = {"kind": "newton", "m": cp.newton_m,
              "substeps": cp.newton_substeps}
    else:
        pd = None
    if cache is not None:
        cache[method] = pd
    return pd


def _prop_data(cp: CompiledProblem, amp_max=None):
    # Per-direction propagator data following the reference prefix
    # override chain (prop_ < fw_prop_/bw_prop_/grad_prop_,
    # src/docstring.jl:201-225).
    cache = {}
    return {
        "fw": _prop_data_for(cp, cp.fw_prop_method, amp_max, cache),
        "bw": _prop_data_for(cp, cp.bw_prop_method, amp_max, cache),
        "grad": _prop_data_for(cp, cp.grad_prop_method, amp_max, cache),
        "amp_max": amp_max,
    }


def _default_amp_max(cp: CompiledProblem):
    import numpy as _np

    return _np.maximum(
        _np.max(_np.abs(cp.guess_pulsevals), axis=1), 0.1
    )



def _pick_segments(storage_mode, storage_segments, N_T):
    """Segment count for checkpoint/recompute storage: a divisor of N_T
    near sqrt(N_T) (memory ~ 2*sqrt(N_T) states instead of N_T)."""
    if storage_mode != "recompute":
        return 0
    if storage_segments:
        if N_T % int(storage_segments) != 0:
            raise ValueError(
                f"storage_segments ({storage_segments}) must divide the "
                f"number of time steps ({N_T})"
            )
        return int(storage_segments)
    target = max(1, int(np.sqrt(N_T)))
    divisors = [s for s in range(1, N_T + 1) if N_T % s == 0]
    return min(divisors, key=lambda s: abs(s - target))


def _make_fwd_step(cp: CompiledProblem, pds, tables, with_U=False):
    """One forward step ``psi -> U_n psi`` as a traced closure.

    With ``with_U`` (ExpProp only), the closure returns ``(psi_new, U_n)``
    so the backward pass can propagate the co-states with the exact adjoint
    ``U_n†`` instead of recomputing the matrix exponential
    (``expm(+i dt H†) ≡ expm(-i dt H)†``)."""
    pd = pds["fw"] if isinstance(pds, dict) and "fw" in pds else pds
    cdtype = cp.psi0.dtype
    coeffs_all, H0_, ops_ = tables[0], tables[2], tables[3]
    dt = jnp.diff(jnp.asarray(cp.tlist))

    if with_U and pd is not None:
        raise ValueError("with_U requires the ExpProp forward propagator")

    shared = cp.shared_generator
    # grouped generators (gate ensembles: contiguous runs of gs
    # trajectories share one H): ExpProp computes one expm per GROUP and
    # applies it to the group's (gs, d) state block — a gs-fold expm
    # saving (including the recompute inner loops)
    gsz = (
        _effective_group_size(cp)
        if (pd is None and not shared and not cp.per_traj_coeffs)
        else 1
    )

    if gsz > 1:
        H0g, opsg = _group_ops(cp, H0_, ops_)
    elif not shared:
        H0_, ops_ = _pertraj_ops(cp, H0_, ops_)

    def step(psi, n):
        if gsz > 1:
            c = coeffs_all[n].astype(cdtype)  # (T,)
            H = H0g + jnp.einsum("t,gtij->gij", c, opsg)
            U = expm((-1j * dt[n].astype(cdtype)) * H)  # (G, d, d)
            G = H.shape[0]
            psig = psi.reshape(G, gsz, -1)
            psi_new = jnp.einsum("gij,gkj->gki", U, psig).reshape(psi.shape)
            if with_U:
                return psi_new, U
            return psi_new
        if cp.per_traj_coeffs:
            c = coeffs_all[:, n].astype(cdtype)  # (K, T)
            H = H0_ + jnp.einsum("kt,ktij->kij", c, ops_)
            mv = "kij,kj->ki"
        elif shared:
            # one generator for all K trajectories (gate optimization):
            # one expm per step, applied to the (K, d) state block
            coeffs = coeffs_all[n].astype(cdtype)
            H = H0_[0] + jnp.einsum("t,tij->ij", coeffs, ops_[0])
            mv = "ij,kj->ki"
        else:
            coeffs = coeffs_all[n].astype(cdtype)
            H = H0_ + jnp.einsum("t,ktij->kij", coeffs, ops_)
            mv = "kij,kj->ki"
        if pd is None:
            U = expm((-1j * dt[n].astype(cdtype)) * H)
            psi_new = jnp.einsum(mv, U, psi)
            if with_U:
                return psi_new, U
            return psi_new
        if pd["kind"] == "newton":
            a = (-1j * dt[n]).astype(cdtype)
            return arnoldi_expmv(
                lambda v: a * jnp.einsum(mv, H, v),
                psi, m=pd["m"], substeps=pd["substeps"],
            )
        d = cp.dim
        Hn = (2.0 * H - pd["shift"] * jnp.eye(d, dtype=cdtype)) / pd["dE"]
        return cheby_apply(
            lambda v: jnp.einsum(mv, Hn, v),
            psi, jnp.asarray(pd["tab_fw"])[n], jnp.asarray(pd["ph_fw"])[n],
        )

    return step


def _apply_bw_prop(cp: CompiledProblem, pd_bw, Hd, chi, dt_n, n, U_n=None):
    """One backward co-state propagation step ``χ ← exp(+i dt_n H†) χ``
    via the chosen ``bw_prop`` method (adjoint ExpProp / Chebyshev /
    Krylov), or — when the forward propagator ``U_n`` is stored — its
    exact adjoint (one matvec).  ``Hd`` is the adjoint generator, shaped
    ``(d, d)`` for a shared generator, ``(G, d, d)`` for grouped
    generators, or ``(K, d, d)``; ``chi (K, d)``."""
    cdtype = cp.psi0.dtype
    if U_n is not None:
        # expm(+i dt H†) ≡ U_n†; U_n is (d, d) for a shared generator,
        # (G, d, d) for grouped generators, (K, d, d) otherwise
        if U_n.ndim == 2:
            return jnp.einsum("ji,kj->ki", jnp.conj(U_n), chi)
        if U_n.shape[0] != chi.shape[0]:  # grouped
            G = U_n.shape[0]
            cg = chi.reshape(G, chi.shape[0] // G, -1)
            return jnp.einsum(
                "gji,gkj->gki", jnp.conj(U_n), cg
            ).reshape(chi.shape)
        return jnp.einsum("kji,kj->ki", jnp.conj(U_n), chi)
    if Hd.ndim == 3 and Hd.shape[0] != chi.shape[0]:
        # grouped adjoint generator: one expm per group applied to the
        # group's (gs, d) co-state block (U-free phase A of the
        # segment-vectorized recompute backward)
        if pd_bw is not None:
            raise ValueError(
                "grouped bw propagation requires ExpProp"
            )
        G = Hd.shape[0]
        U = expm((1j * dt_n).astype(cdtype) * Hd)  # (G, d, d)
        cg = chi.reshape(G, chi.shape[0] // G, -1)
        return jnp.einsum("gij,gkj->gki", U, cg).reshape(chi.shape)
    mv = "ij,kj->ki" if Hd.ndim == 2 else "kij,kj->ki"
    if pd_bw is None:
        U = expm((1j * dt_n).astype(cdtype) * Hd)
        return jnp.einsum(mv, U, chi)
    if pd_bw["kind"] == "newton":
        a = (1j * dt_n).astype(cdtype)
        return arnoldi_expmv(
            lambda v: a * jnp.einsum(mv, Hd, v),
            chi, m=pd_bw["m"], substeps=pd_bw["substeps"],
        )
    d = cp.dim
    Hn = (2.0 * Hd - pd_bw["shift"] * jnp.eye(d, dtype=cdtype)) / pd_bw["dE"]
    return cheby_apply(
        lambda v: jnp.einsum(mv, Hn, v),
        chi, jnp.asarray(pd_bw["tab_bw"])[n], jnp.asarray(pd_bw["ph_bw"])[n],
    )


def _make_bw_step(cp: CompiledProblem, pds, tables, rho, safe_rho,
                  amp_max=None):
    """One backward gradient step as a traced closure:
    ``(chi, n, psi_at_tn) -> (chi_new, grad_n)``.

    The co-state propagation uses the ``bw`` propagator; the gradgen
    extended-state propagation uses the ``grad`` propagator (the
    reference prefixes ``bw_prop_`` / ``grad_prop_``)."""
    pd_bw = pds["bw"] if isinstance(pds, dict) and "bw" in pds else pds
    pd = pds["grad"] if isinstance(pds, dict) and "grad" in pds else pds
    cdtype = cp.psi0.dtype
    rdtype = cp.tlist.dtype
    use_taylor = cp.gradient_method == "taylor"
    dt = jnp.diff(jnp.asarray(cp.tlist))
    h_scale = (
        max(_h_norm_bound(cp, amp_max), 1e-30) if use_taylor else None
    )

    def bw_step(chi, n, psi_prev, U_n=None):
        H, mu = _step_ops(cp, n, tables, cdtype)
        Hd = jnp.conj(jnp.swapaxes(H, -1, -2))
        mud = jnp.conj(jnp.swapaxes(mu, -1, -2))
        ndt = -dt[n].astype(rdtype)
        taylor_ok = jnp.asarray(True)
        if use_taylor:
            chi_prime, taylor_ok = taylor_grad_step(
                Hd, mud, chi, ndt,
                max_order=cp.taylor_grad_max_order,
                tolerance=cp.taylor_grad_tolerance,
                check_convergence=cp.taylor_grad_check_convergence,
                with_status=True,
                scale=h_scale,
            )
            chi_new = _apply_bw_prop(cp, pd_bw, Hd, chi, dt[n], n, U_n)
        elif pd is None:
            chi_prime, chi_new = gradgen_step(Hd, mud, chi, ndt)
        elif pd["kind"] == "newton":
            # gradgen via the augmented ("gradient generator") operator
            # under the Krylov propagator: matvec of G[H†] on the flattened
            # extended state (χ'_1..χ'_L, χ)
            d = cp.dim
            L = cp.n_controls
            a = (-1j * ndt).astype(cdtype)

            def aug_mv(vflat):
                v = vflat.reshape(cp.n_traj, L + 1, d)
                out = jnp.einsum("kij,klj->kli", Hd, v)
                add = jnp.einsum("klij,kj->kli", mud, v[:, -1, :])
                out = out.at[:, :-1, :].add(add)
                return (a * out).reshape(cp.n_traj, (L + 1) * d)

            ext0 = jnp.concatenate(
                [
                    jnp.zeros((cp.n_traj, L, d), dtype=cdtype),
                    chi[:, None, :],
                ],
                axis=1,
            ).reshape(cp.n_traj, (L + 1) * d)
            ext = arnoldi_expmv(
                aug_mv, ext0, m=pd["m"], substeps=pd["substeps"]
            ).reshape(cp.n_traj, L + 1, d)
            chi_prime = ext[:, :-1, :]
            chi_new = ext[:, -1, :]
        else:
            # Cheby gradgen: Chebyshev series in the normalized augmented
            # ("gradient generator") operator on the extended state
            # (χ'_1..χ'_L, χ) — background.md Eq. (gradprop-bw).
            d = cp.dim
            Hn = (
                2.0 * Hd - pd["shift"] * jnp.eye(d, dtype=cdtype)
            ) / pd["dE"]
            mun = (2.0 / pd["dE"]) * mud

            def gmatvec(v):
                out = jnp.einsum("kij,klj->kli", Hn, v)
                add = jnp.einsum("klij,kj->kli", mun, v[:, -1, :])
                return out.at[:, :-1, :].add(add)

            ext0 = jnp.concatenate(
                [
                    jnp.zeros(
                        (cp.n_traj, cp.n_controls, d), dtype=cdtype
                    ),
                    chi[:, None, :],
                ],
                axis=1,
            )
            ext = cheby_apply(
                gmatvec, ext0, jnp.asarray(pd["tab_bw"])[n],
                jnp.asarray(pd["ph_bw"])[n]
            )
            chi_prime = ext[:, :-1, :]
            chi_new = ext[:, -1, :]
        # ∇τ_{knl} = ρ_k ⟨χ'_{kl}|Ψ(t_n)⟩   (src/optimize.jl:893-895)
        grad_n = rho[:, None].astype(cdtype) * jnp.einsum(
            "kli,ki->kl", jnp.conj(chi_prime), psi_prev
        )
        if cp.xi is not None:
            # inhomogeneity λ_b Δt_n ξ(t_n)/ρ_k at interior grid points
            # (src/optimize.jl:897-908); skip the n == 0 endpoint.
            w = _grid_weights(jnp.asarray(cp.tlist))[n]
            xi_n = cp.xi(psi_prev, cp.trajectories, jnp.asarray(cp.tlist), n)
            inhom = (
                cp.lambda_b * w / safe_rho[:, None]
            ).astype(cdtype) * xi_n
            chi_new = jnp.where(n > 0, chi_new + inhom, chi_new)
        return chi_new, (grad_n, taylor_ok)

    return bw_step


def _forward(cp: CompiledProblem, tables, pds=None, with_U=False):
    """Forward propagation storing all states.

    Returns ``storage (N_T+1, K, d)`` — the reference's per-trajectory
    ``fw_storage`` (``src/workspace.jl:215``, ``src/optimize.jl:731-738``) —
    plus, with ``with_U``, the per-step propagators for backward reuse
    (``(N_T, d, d)`` for a shared generator, ``(N_T, K, d, d)`` otherwise).

    The step exponentials do not depend on the state, so a time-batched
    expm ahead of a matvec-only scan is an alternative to this per-step
    form; it has not been measured on the GPU (ROADMAP §1).
    """
    psi0_ = jnp.asarray(cp.psi0)
    fwd_step = _make_fwd_step(cp, pds, tables, with_U=with_U)

    if with_U:
        def step_u(psi, n):
            psi_new, U = fwd_step(psi, n)
            return psi_new, (psi_new, U)

        _, (ys, Us) = lax.scan(step_u, psi0_, jnp.arange(cp.n_timesteps))
        storage = jnp.concatenate([psi0_[None], ys], axis=0)
        return storage, Us

    def step(psi, n):
        psi_new = fwd_step(psi, n)
        return psi_new, psi_new

    _, ys = lax.scan(step, psi0_, jnp.arange(cp.n_timesteps))
    storage = jnp.concatenate([psi0_[None], ys], axis=0)
    return storage


def _grid_weights(tlist):
    """Trapezoid weights over grid points: ``[dt_1/2, Δt_1.., dt_NT/2]``
    with ``Δt_n = (t_{n+1} - t_{n-1})/2`` (background.md trapezoid expansion).
    """
    dt = jnp.diff(tlist)
    w_interior = 0.5 * (dt[:-1] + dt[1:])
    return jnp.concatenate(
        [0.5 * dt[:1], w_interior, 0.5 * dt[-1:]]
    )


def _J_parts(cp: CompiledProblem, pulsevals, storage):
    """``[J_T, λ_a J_a, λ_b J_b]`` and tau values from the forward storage."""
    psi_T = storage[-1]
    tau = taus(psi_T, cp.trajectories) if cp.has_targets else None
    if cp.J_T_takes_tau:
        J_T_val = cp.J_T(psi_T, cp.trajectories, tau=tau)
    else:
        J_T_val = cp.J_T(psi_T, cp.trajectories)
    zero = jnp.zeros((), dtype=J_T_val.dtype)
    J_a_val = zero
    if cp.J_a is not None:
        J_a_val = cp.lambda_a * cp.J_a(pulsevals, cp.tlist)
    J_b_val = zero
    if cp.g_b is not None:
        tlist_j = jnp.asarray(cp.tlist)
        w = _grid_weights(tlist_j)

        def gb_at(n):
            return cp.g_b(storage[n], cp.trajectories, tlist_j, n)

        gvals = jax.vmap(gb_at)(jnp.arange(cp.n_timesteps + 1))  # (N_T+1, K)
        J_b_val = cp.lambda_b * jnp.sum(w[:, None] * gvals)
    return J_T_val, J_a_val, J_b_val, tau


def _traj_shards(cp: CompiledProblem):
    """Number of shards the trajectory axis splits into: the product of
    the mesh axis sizes named in ``cp.mesh_axis`` (NOT the total device
    count — they differ when the trajectory axis shards over a subset of
    a multi-axis mesh's axes)."""
    if cp.mesh is None:
        return 1
    ax = cp.mesh_axis
    if ax is None:
        return int(cp.mesh.devices.size)
    names = ax if isinstance(ax, (tuple, list)) else (ax,)
    n = 1
    for name in names:
        n *= int(cp.mesh.shape[name])
    return n


def _local_traj(cp: CompiledProblem):
    """Per-shard trajectory count on a mesh-sharded build
    (``shard_problem`` guarantees divisibility)."""
    return cp.n_traj // _traj_shards(cp)


def _h_norm_bound(cp: CompiledProblem, amp_max=None):
    """Host-side envelope bound on ``‖H_n‖_1``:
    ``||H0||_1 + sum_j cmax_j ||Op_j||_1``."""
    if amp_max is None:
        amp_max = 2.0 * _default_amp_max(cp)
    cmax, _ = _coeff_env(cp, amp_max)
    h0n, opn = _op_norms(cp)
    coupling = float(np.dot(cmax, opn)) if len(opn) else 0.0
    return h0n + coupling


def _op_norms(cp: CompiledProblem):
    """``(‖H0‖_1 max over k, per-term ‖Op_j‖_1 max over k)`` — from the
    compile-time cache when available (the arrays may live sharded on
    device, where a host read-back would be a collective + transfer)."""
    if cp.norm_cache is not None:
        return cp.norm_cache["h0"], np.asarray(cp.norm_cache["ops"])
    k_ops = cp.H0.shape[0]  # 1 for shared generators, K otherwise
    h0n = max(
        float(np.abs(np.asarray(cp.H0[k])).sum(axis=0).max())
        for k in range(k_ops)
    )
    opn = np.asarray([
        max(
            float(np.abs(np.asarray(cp.ops[k, j])).sum(axis=0).max())
            for k in range(k_ops)
        )
        for j in range(cp.ops.shape[1])
    ])
    return h0n, opn


def _mu_norm_bound(cp: CompiledProblem, amp_max=None):
    """Host-side bound on ``max_{n,l,k} ‖μ_knl‖_1`` with
    ``μ_nl = Σ_j (∂a_j/∂ε_l)·Op_j`` over the pulse envelope (for linear
    amplitudes ``∂a_j/∂ε_l = M[n,j,l]``, amplitude-independent)."""
    if np.asarray(cp.M).shape[-2] == 0 or cp.n_controls == 0:
        return 0.0
    if amp_max is None:
        amp_max = 2.0 * _default_amp_max(cp)
    _, dmax = _coeff_env(cp, amp_max)  # (T, L)
    _, opn = _op_norms(cp)
    return float(np.einsum("tl,t->l", dmax, opn).max())


def _dt_h_norm_bound(cp: CompiledProblem, amp_max=None):
    """Host-side envelope bound on ``|dt|·‖H_n‖_1``."""
    dt_max = float(np.max(np.diff(np.asarray(cp.tlist))))
    return dt_max * _h_norm_bound(cp, amp_max)


def _taylor_prefactor(cp: CompiledProblem, amp_max=None):
    """``‖μ‖/‖H‖`` prefactor for the static Taylor-order bound (see
    ``taylor_order_for_bound``)."""
    return (
        _mu_norm_bound(cp, amp_max)
        / max(_h_norm_bound(cp, amp_max), 1e-30)
    )


def _expm_squarings(cp: CompiledProblem, amp_max=None):
    """Static squaring count from the host-side amplitude envelope."""
    bound = _dt_h_norm_bound(cp, amp_max)
    theta = 2.0
    return max(0, int(np.ceil(np.log2(max(bound, 1e-30) / theta))))


def _taylor_tol_effective(cp: CompiledProblem):
    """Effective tolerance for static-order Taylor paths: the user tolerance,
    floored at 1e-9 for complex64 (f32 terms below ~1e-9·‖H·dt‖ are numeric
    noise; demanding them would spuriously fail the honest last-term check)."""
    tol = cp.taylor_grad_tolerance
    if np.dtype(cp.psi0.dtype) == np.complex64:
        tol = max(tol, 1e-9)
    return tol


def _reuse_U_enabled(cp: CompiledProblem, pds):
    """Reuse the forward step propagators ``U_n`` for the backward co-state
    propagation (``χ ← U_n†χ``, exact identity): applies to the taylor
    gradient with ExpProp forward AND backward propagation.  ``"auto"``
    gates on the storage cost ``N_T·K·d²`` staying under ~4 GiB (beyond
    that, ``storage_mode="recompute"`` with segment-local reuse is the
    right tool anyway)."""
    if cp.reuse_propagators is False:
        return False
    pd_fw = pds["fw"] if isinstance(pds, dict) and "fw" in pds else pds
    pd_bw = pds["bw"] if isinstance(pds, dict) and "bw" in pds else pds
    if pd_fw is not None or pd_bw is not None:
        return False
    if cp.gradient_method != "taylor":
        return False
    if cp.reuse_propagators == "auto":
        n_stored = cp.n_timesteps
        if cp.storage_mode == "recompute" and cp.storage_segments:
            n_stored = cp.n_timesteps // cp.storage_segments  # per segment
        k_u = 1 if cp.shared_generator else cp.n_traj
        nbytes = (
            n_stored * k_u * cp.dim * cp.dim
            * np.dtype(cp.psi0.dtype).itemsize
        )
        return nbytes <= 4 * 1024**3
    return bool(cp.reuse_propagators)


def _vectorized_taylor_orders(cp: CompiledProblem, amp_max=None):
    """Static Taylor order count for the time-vectorized backward pass,
    from the host amplitude envelope (plus the ‖μ‖/‖H‖ prefactor and a
    +2 margin).  Returns None when no order within
    ``taylor_grad_max_order`` reaches the tolerance — the caller then uses
    the per-step scan path with its dynamic ``lax.while_loop`` convergence
    check (which raises on non-convergence like the reference)."""
    return taylor_order_for_bound(
        _dt_h_norm_bound(cp, amp_max),
        tolerance=_taylor_tol_effective(cp),
        max_order=cp.taylor_grad_max_order,
        prefactor=_taylor_prefactor(cp, amp_max),
    )


def uses_static_envelope(cp: CompiledProblem):
    """True when the compiled fg/f programs derive STATIC data from the
    pulse-amplitude envelope — Chebyshev coefficient tables, expm
    squaring counts, or the vectorized-Taylor order count.  The workspace
    must then re-jit (grow the envelope bucket) when the optimizer pushes
    pulses past the current envelope; see ``GrapeWrk._ensure_envelope``."""
    if hasattr(cp, "parts"):  # heterogeneous grouped compile
        return any(uses_static_envelope(p) for p in cp.parts)
    if "cheby" in (
        cp.fw_prop_method, cp.bw_prop_method, cp.grad_prop_method
    ):
        return True
    # the time-vectorized backward passes pick static counts from the
    # envelope: the Taylor order (taylor) and the expm_frechet squaring
    # count (gradgen) — in BOTH storage modes (the recompute backward
    # runs segment-vectorized).  Without the bucketing, pulses
    # outgrowing the guess envelope trip the honest last-term check.
    if cp.gradient_method == "taylor" and cp.vectorize_backward:
        return True
    if _vec_gradgen_enabled(cp):
        return True
    return False


def _chi_trajectory(cp: CompiledProblem, psis, Us, chi_hat, safe_rho,
                    ns=None):
    """Phase A of the vectorized backward passes: the normalized co-state
    trajectory via the stored propagators — one batched matvec per step
    (``χ ← U_n†χ``) plus the ξ inhomogeneity injection
    (``src/optimize.jl:897-908``).  ``psis (C, K, d)`` holds the states
    at the step STARTS (``ψ(t_n)``; full storage callers pass
    ``storage[:-1]``); with ``ns`` (a traced ``(C,)`` global-step index
    vector, ascending), the chain runs over that time WINDOW only —
    ``chi_hat`` is then ``χ`` entering the window from the later side
    (the segment-vectorized recompute backward).  Returns
    ``chis (C, K, d)`` with ``chis[j] = χ(t_{ns[j]+1})`` (what step
    ``ns[j]``'s gradient consumes), and the χ carried out of the
    window."""
    cdtype = cp.psi0.dtype
    tlist_j = jnp.asarray(cp.tlist)
    C = psis.shape[0]
    if ns is None:
        ns = jnp.arange(cp.n_timesteps)
    if cp.xi is not None:
        w = _grid_weights(tlist_j)

    shared_U = Us.ndim == 3  # (C, d, d): one U_n for all trajectories
    # grouped stored propagators (C, G, d, d): one U_n per generator
    # group of _effective_group_size trajectories
    grp_U = Us.ndim == 4 and Us.shape[1] != chi_hat.shape[0]
    def chi_body(chi, j):
        chi_in = chi  # χ(t_{n+1}) — what step n's recursion consumes
        n = ns[j]
        if shared_U:
            chi_new = jnp.einsum("ji,kj->ki", jnp.conj(Us[j]), chi)
        elif grp_U:
            G = Us.shape[1]
            cg = chi.reshape(G, chi.shape[0] // G, -1)
            chi_new = jnp.einsum(
                "gji,gkj->gki", jnp.conj(Us[j]), cg
            ).reshape(chi.shape)
        else:
            chi_new = jnp.einsum("kji,kj->ki", jnp.conj(Us[j]), chi)
        if cp.xi is not None:
            xi_n = cp.xi(psis[j], cp.trajectories, tlist_j, n)
            inhom = (
                cp.lambda_b * w[n] / safe_rho[:, None]
            ).astype(cdtype) * xi_n
            chi_new = jnp.where(n > 0, chi_new + inhom, chi_new)
        return chi_new, chi_in

    js = jnp.arange(C - 1, -1, -1)
    chi_out, chis_rev = lax.scan(chi_body, chi_hat, js)
    return chis_rev[::-1], chi_out  # chis[j] = χ(t_{ns[j]+1})


def _chi_prop_scan(cp: CompiledProblem, pds, tables, psis, chi_hat,
                   safe_rho, ns=None):
    """Phase A without stored propagators: the normalized co-state
    trajectory via per-step backward propagation (adjoint ExpProp /
    Chebyshev / Krylov — the reference's ``bw_prop`` loop,
    ``src/optimize.jl:920-922``) plus the ξ inhomogeneity injection.
    One matvec-series per step — cheap and sequential; the expensive
    gradient work then runs time-vectorized on the result.  With
    grouped generators the adjoint expm is derived once per GROUP.
    ``psis``/``ns`` as in :func:`_chi_trajectory`.  Returns
    ``(chis (C, K, d), chi_out)`` with ``chis[j] = χ(t_{ns[j]+1})``."""
    pd_bw = pds["bw"] if isinstance(pds, dict) and "bw" in pds else pds
    cdtype = cp.psi0.dtype
    tlist_j = jnp.asarray(cp.tlist)
    dt = jnp.diff(tlist_j)
    coeffs_all, H0_, ops_ = tables[0], tables[2], tables[3]
    shared = cp.shared_generator
    C = psis.shape[0]
    if ns is None:
        ns = jnp.arange(cp.n_timesteps)
    if cp.xi is not None:
        w = _grid_weights(tlist_j)
    gsz = (
        _effective_group_size(cp)
        if (pd_bw is None and not shared and not cp.per_traj_coeffs)
        else 1
    )
    if gsz > 1:
        H0g, opsg = _group_ops(cp, H0_, ops_)
    elif not shared:
        H0_, ops_ = _pertraj_ops(cp, H0_, ops_)

    def body(chi, j):
        chi_in = chi  # χ(t_{n+1})
        n = ns[j]
        if gsz > 1:
            c = coeffs_all[n].astype(cdtype)
            H = H0g + jnp.einsum("t,gtij->gij", c, opsg)
        elif cp.per_traj_coeffs:
            c = coeffs_all[:, n].astype(cdtype)
            H = H0_ + jnp.einsum("kt,ktij->kij", c, ops_)
        elif shared:
            coeffs = coeffs_all[n].astype(cdtype)
            H = H0_[0] + jnp.einsum("t,tij->ij", coeffs, ops_[0])
        else:
            coeffs = coeffs_all[n].astype(cdtype)
            H = H0_ + jnp.einsum("t,ktij->kij", coeffs, ops_)
        Hd = jnp.conj(jnp.swapaxes(H, -1, -2))
        chi_new = _apply_bw_prop(cp, pd_bw, Hd, chi, dt[n], n)
        if cp.xi is not None:
            xi_n = cp.xi(psis[j], cp.trajectories, tlist_j, n)
            inhom = (
                cp.lambda_b * w[n] / safe_rho[:, None]
            ).astype(cdtype) * xi_n
            chi_new = jnp.where(n > 0, chi_new + inhom, chi_new)
        return chi_new, chi_in

    js = jnp.arange(C - 1, -1, -1)
    chi_out, chis_rev = lax.scan(body, chi_hat, js)
    return chis_rev[::-1], chi_out


def _stored_u_entries(cp: CompiledProblem):
    """Per-step stored-propagator count: 1 for a shared generator, one
    per GROUP for grouped generators (the grouped ExpProp step emits
    group-level U), K otherwise."""
    if cp.shared_generator:
        return 1
    gs = _effective_group_size(cp)
    return cp.n_traj // gs if gs > 1 else cp.n_traj


def _gg_u_bytes_ok(cp: CompiledProblem):
    """U-storage bound for the stored-propagator phase A of the
    vectorized gradgen pass (``N_T · k_u · d²`` complex entries)."""
    nbytes = (
        cp.n_timesteps * _stored_u_entries(cp) * cp.dim * cp.dim
        * np.dtype(cp.psi0.dtype).itemsize
    )
    return nbytes <= 4 * 1024**3


def _all_expprop(cp: CompiledProblem, pds=None):
    """True when forward, backward, and gradient propagation are all
    ExpProp (the formulation the stored-propagator / Fréchet paths
    need)."""
    if pds is None:
        return (
            cp.fw_prop_method == "expprop"
            and cp.bw_prop_method == "expprop"
            and cp.grad_prop_method == "expprop"
        )
    for key in ("fw", "bw", "grad"):
        pd = pds[key] if isinstance(pds, dict) and key in pds else pds
        if pd is not None:
            return False
    return True


def _vec_gradgen_enabled(cp: CompiledProblem, pds=None):
    """Time-vectorized gradgen backward: requires ExpProp
    forward/backward/grad and propagator reuse not explicitly disabled.
    Full storage additionally needs bounded U-storage for phase A; in
    recompute mode the pass runs segment-vectorized, where
    phase A is always feasible (per-segment stored or recomputed
    propagators)."""
    if not cp.vectorize_backward or cp.gradient_method != "gradgen":
        return False
    if cp.reuse_propagators is False:
        # the user opted out of storing per-step propagators
        return False
    if not _all_expprop(cp, pds):
        return False
    if cp.storage_mode == "recompute":
        return True
    return _gg_u_bytes_ok(cp)


def _seg_reuse_U(cp: CompiledProblem, pds=None):
    """Store the per-step propagators of ONE recomputed segment for the
    segment-local χ chain (phase A)?  Requires ExpProp everywhere and a
    bounded per-segment U block (``seg_len · k_u · d²`` complex
    entries, one per generator GROUP); beyond the budget, phase A
    recomputes the (grouped) adjoint expm per step instead.  Budget
    4 GiB (same as ``_gg_u_bytes_ok``), which keeps the stored path
    through the 1024-sample config-5 letter (seg U = 4.1 GB there)."""
    if cp.reuse_propagators is False or not _all_expprop(cp, pds):
        return False
    seg_len = cp.n_timesteps // max(cp.storage_segments, 1)
    nbytes = (
        seg_len * _stored_u_entries(cp) * cp.dim * cp.dim
        * np.dtype(cp.psi0.dtype).itemsize
    )
    return nbytes <= 4 * 1024**3


def _effective_group_size(cp: CompiledProblem):
    """Group size the grouped compute paths may actually use: detected
    contiguous generator groups, provided shard boundaries do not
    straddle a group (per-shard trajectory count divisible;
    ``shard_problem`` expands group-level operator storage to
    per-trajectory before sharding whenever they would)."""
    gs = getattr(cp, "gen_group_size", 1) or 1
    if gs <= 1 or cp.per_traj_coeffs:
        return 1
    if _local_traj(cp) % gs != 0:
        return 1
    return gs


def _group_ops(cp: CompiledProblem, H0_, ops_):
    """Operator arrays with ONE entry per generator group (for the
    grouped ExpProp steps)."""
    if cp.ops_grouped:
        return H0_, ops_
    gs = _effective_group_size(cp)
    if gs > 1:
        return H0_[::gs], ops_[::gs]
    return H0_, ops_


def _pertraj_ops(cp: CompiledProblem, H0_, ops_):
    """Operator arrays with ONE entry per trajectory (for the per-K
    compute paths), expanding group-level storage by repetition."""
    if cp.ops_grouped:
        gs = cp.gen_group_size
        return (
            jnp.repeat(H0_, gs, axis=0), jnp.repeat(ops_, gs, axis=0)
        )
    return H0_, ops_


def _gradgen_chunk(cp: CompiledProblem, n_steps=None, n_intermediates=8,
                   budget_bytes=1 * 1024**3):
    """Time-chunk length for the vectorized gradgen pass: a divisor of
    ``n_steps`` sized so the chunk's (C, K, d, d) intermediates stay
    within the memory budget while batching enough matrices per matmul
    to keep the device busy."""
    if n_steps is None:
        n_steps = cp.n_timesteps
    per_step = (
        cp.n_traj * cp.dim * cp.dim * np.dtype(cp.psi0.dtype).itemsize
        * n_intermediates
    )
    target = max(1, min(n_steps, int(budget_bytes // max(per_step, 1))))
    divisors = [c for c in range(1, n_steps + 1) if n_steps % c == 0]
    return max(c for c in divisors if c <= target)


def _backward_vectorized_gradgen(cp: CompiledProblem, tables, psis,
                                 chis, rho, amp_max=None, ns=None):
    """Time-vectorized gradgen backward pass.

    The per-step gradient only needs the scalar
    ``∇τ_{nl} = ρ·χ(t_{n+1})† L(A_n, B_nl) ψ(t_n)`` with
    ``A_n = -i dt H_n`` and ``B_nl = -i dt μ_nl`` (the Fréchet derivative
    of the FORWARD propagator; the reference gets it from the augmented
    extended-state propagation, ``src/optimize.jl:873-911``).  By the
    trace-adjoint identity of the Fréchet derivative,

        tr(L(A, B)·M) = tr(B·L(A, M)),

    ``χ† L(A, B_l) ψ = tr(L(A, B_l)·ψχ†) = tr(B_l·L(A, ψχ†))`` — so ONE
    Fréchet evaluation per (n, k) in the rank-1 direction ``R = ψχ†``
    serves ALL ``L`` control directions, each reduced to a trace-dot with
    ``μ_nl``.  Phase A recovers every χ(t_{n+1}) with one matvec per step;
    phase B runs the batched ``expm_frechet`` over time chunks sized to
    memory (big batched matmuls).

    ``psis (C, K, d)`` holds the states at the step starts (full storage
    callers pass ``storage[:-1]``); ``chis (C, K, d)`` the matching
    co-states.  With ``ns`` (a traced ``(C,)`` global-step index
    vector), the pass covers that time WINDOW only — the
    segment-vectorized recompute backward.

    Returns ``tau_grads (C, K, L)`` (ρ-scaled).
    """
    from .ops.frechet import expm_frechet

    cdtype = cp.psi0.dtype
    H0_, ops_ = tables[2], tables[3]
    C_loc = psis.shape[0]

    dt = jnp.diff(jnp.asarray(cp.tlist))
    co_t, dM_t = tables[0], tables[1]
    if ns is not None:
        dt = dt[ns]
        co_t = co_t[:, ns] if cp.per_traj_coeffs else co_t[ns]
        dM_t = dM_t[:, ns] if cp.per_traj_coeffs else dM_t[ns]
    coeffs_all = co_t.astype(cdtype)  # (C, T) or (K, C, T)
    dMc = dM_t.astype(cdtype)         # (C, T, L) or (K, C, T, L)

    if not cp.shared_generator:
        H0_, ops_ = _pertraj_ops(cp, H0_, ops_)
    C = _gradgen_chunk(cp, n_steps=C_loc)
    S = C_loc // C
    idx = jnp.arange(C_loc).reshape(S, C)
    # static squaring count from the host amplitude envelope (bucketed by
    # the workspace): static trip counts schedule better under the scan,
    # and an envelope over-estimate is mathematically exact
    n_sq = _expm_squarings(cp, amp_max)

    def chunk_body(_, cs):
        # cs: LOCAL step indices into the (already windowed) per-step
        # arrays (identical to the global indices when ns is None)
        a = (-1j * dt[cs]).astype(cdtype)  # (C,)
        # rank-1 direction R[b, a] = ψ_b(t_n) conj(χ_a(t_{n+1}))
        R = jnp.einsum(
            "ckb,cka->ckba", psis[cs], jnp.conj(chis[cs])
        )
        if cp.shared_generator:
            # one generator: ONE expm base per step shared by all K
            # trajectories — the K rank-1 directions ride the Fréchet
            # direction axis of expm_frechet
            Hc = H0_[0][None] + jnp.einsum(
                "ct,tij->cij", coeffs_all[cs], ops_[0]
            )  # (C, d, d)
            Af = a[:, None, None] * Hc
            _E, G = expm_frechet(Af, R, squarings=n_sq)  # (C, K, d, d)
            trj = jnp.einsum("tab,ckba->ckt", ops_[0], G)
        elif cp.per_traj_coeffs:
            Hc = H0_[None] + jnp.einsum(
                "kct,ktij->ckij", coeffs_all[:, cs], ops_
            )  # (C, K, d, d)
            Af = a[:, None, None, None] * Hc
            _E, G = expm_frechet(Af, R, squarings=n_sq)
            trj = jnp.einsum("ktab,ckba->ckt", ops_, G)
        else:
            Hc = H0_[None] + jnp.einsum(
                "ct,ktij->ckij", coeffs_all[cs], ops_
            )  # (C, K, d, d)
            Af = a[:, None, None, None] * Hc
            _E, G = expm_frechet(Af, R, squarings=n_sq)  # G = L(A_n, R_n)
            trj = jnp.einsum("ktab,ckba->ckt", ops_, G)
        # tr(Op_j G) then contract the control-derivative table:
        # ∇τ_{nl} = ρ (-i dt_n) Σ_j (∂a_j/∂ε_l)(ε_n) tr(Op_j G_n)
        if cp.per_traj_coeffs:
            grads_c = a[:, None, None] * jnp.einsum(
                "kctl,ckt->ckl", dMc[:, cs], trj
            )
        else:
            grads_c = a[:, None, None] * jnp.einsum(
                "ctl,ckt->ckl", dMc[cs], trj
            )
        return None, grads_c

    _, grads = lax.scan(chunk_body, None, idx)  # (S, C, K, L)
    grads = grads.reshape(C_loc, cp.n_traj, cp.n_controls)
    return rho[None, :, None].astype(cdtype) * grads


def _backward_vectorized(cp: CompiledProblem, tables, psis, chis,
                         rho, amp_max=None, ns=None):
    """Time-vectorized backward gradient pass (phase B).

    The reference's backward loop (``src/optimize.jl:913-994``) — and our
    scan counterpart — is sequential in time because the co-state χ carries
    across steps.  But the χ chain is ONE cheap propagation per step
    (``chis``, from phase A: ``_chi_trajectory`` with stored propagators,
    or ``_chi_prop_scan`` under cheby/newton); everything expensive (the
    Taylor χ'-recursion and the gradient dots) depends only on per-step
    data and runs here batched over the WHOLE time axis: one Taylor
    recursion on ``(N_T, K, L, d)`` tensors — ~30 orders × a few large
    einsums instead of N_T × ~100 small ops.

    ``psis (C, K, d)``: states at the step starts (full storage callers
    pass ``storage[:-1]``); with ``ns`` (traced ``(C,)`` global-step
    indices) the pass covers that WINDOW only (segment-vectorized
    recompute backward).

    Returns ``(tau_grads (C, K, L) [ρ-scaled], taylor_ok)``.
    """
    cdtype = cp.psi0.dtype
    tlist_j = jnp.asarray(cp.tlist)
    dt = jnp.diff(tlist_j)
    H0_, ops_ = tables[2], tables[3]
    if not cp.shared_generator:
        H0_, ops_ = _pertraj_ops(cp, H0_, ops_)

    # ---- phase B: batched Taylor recursion over all steps -----------
    co_t, dM_t = tables[0], tables[1]
    if ns is not None:
        dt = dt[ns]
        co_t = co_t[:, ns] if cp.per_traj_coeffs else co_t[ns]
        dM_t = dM_t[:, ns] if cp.per_traj_coeffs else dM_t[ns]
    coeffs_all = co_t.astype(cdtype)  # (C, T) or (K, C, T)
    dMc = dM_t.astype(cdtype)         # (C, T, L) or (K, C, T, L)
    # Scaled recursion (see taylor_grad_step): iterate with H†/h so the
    # iterates stay O(1) — unscaled, Φ_m ~ ‖H‖^m overflows f32 while the
    # coefficient underflows, and flushing denormals to zero then
    # silently truncates the series.
    h = max(_h_norm_bound(cp, amp_max), 1e-30)
    inv_h = np.dtype(cdtype).type(1.0 / h)
    # Static-operator decomposition of H†@Z at large dim: instead of
    # materializing H_n (N_T·d² memory — 840 MB at d=1024) and running
    # N_T separate thin (d,d)@(d, K(L+1)) matmuls, apply the T+1 STATIC
    # operators to the whole (N_T·K·(L+1), d) block — one wide matmul
    # each — and combine with the per-(n,t) coefficients elementwise.
    # Gated on a thin column count, (T+1)·K·(L+1) ≤ 256, and on d large
    # enough that matmuls (not dispatch) dominate.
    T_terms = int(np.asarray(cp.M).shape[-2])
    static_h = (
        cp.dim >= _STATIC_H_MIN_DIM
        and (T_terms + 1) * cp.n_traj * (cp.n_controls + 1) <= 256
    )
    if cp.shared_generator:
        opsd = jnp.conj(jnp.swapaxes(ops_[0], -1, -2))  # (T, d, d)

        def mu_apply(v):
            u = jnp.einsum("tij,nkj->nkti", opsd, v)
            return jnp.einsum("ntl,nkti->nkli", dMc, u)

        if static_h:
            H0d = jnp.conj(H0_[0].T) * inv_h
            opsd_h = opsd * inv_h

            def h_apply(Z):  # H†/h @ Z without materializing H_n
                out = jnp.einsum("ij,nkmj->nkmi", H0d, Z)
                U = jnp.einsum("tij,nkmj->ntkmi", opsd_h, Z)
                return out + jnp.einsum(
                    "nt,ntkmi->nkmi", jnp.conj(coeffs_all), U
                )
        else:
            Hs = H0_[0][None] + jnp.einsum(
                "nt,tij->nij", coeffs_all, ops_[0]
            )
            Hds = jnp.conj(jnp.swapaxes(Hs, -1, -2)) * inv_h

            def h_apply(Z):  # H†/h @ Z over the stacked (k, m) axes
                return jnp.einsum("nij,nkmj->nkmi", Hds, Z)
    elif cp.per_traj_coeffs:
        opsd = jnp.conj(jnp.swapaxes(ops_, -1, -2))  # (K, T, d, d)

        def mu_apply(v):
            u = jnp.einsum("ktij,nkj->nkti", opsd, v)
            return jnp.einsum("kntl,nkti->nkli", dMc, u)

        if static_h:
            H0d = jnp.conj(jnp.swapaxes(H0_, -1, -2)) * inv_h
            opsd_h = opsd * inv_h

            def h_apply(Z):
                out = jnp.einsum("kij,nkmj->nkmi", H0d, Z)
                U = jnp.einsum("ktij,nkmj->ntkmi", opsd_h, Z)
                return out + jnp.einsum(
                    "knt,ntkmi->nkmi", jnp.conj(coeffs_all), U
                )
        else:
            Hs = H0_[None] + jnp.einsum(
                "knt,ktij->nkij", coeffs_all, ops_
            )
            Hds = jnp.conj(jnp.swapaxes(Hs, -1, -2)) * inv_h

            def h_apply(Z):
                return jnp.einsum("nkij,nkmj->nkmi", Hds, Z)
    else:
        opsd = jnp.conj(jnp.swapaxes(ops_, -1, -2))  # (K, T, d, d)

        def mu_apply(v):
            """μ† @ v for all (n, k, l) without materializing μ:
            μ_nl† = Σ_j (∂a_j/∂ε_l)·Op_j†."""
            u = jnp.einsum("ktij,nkj->nkti", opsd, v)
            return jnp.einsum("ntl,nkti->nkli", dMc, u)

        if static_h:
            H0d = jnp.conj(jnp.swapaxes(H0_, -1, -2)) * inv_h
            opsd_h = opsd * inv_h

            def h_apply(Z):
                out = jnp.einsum("kij,nkmj->nkmi", H0d, Z)
                U = jnp.einsum("ktij,nkmj->ntkmi", opsd_h, Z)
                return out + jnp.einsum(
                    "nt,ntkmi->nkmi", jnp.conj(coeffs_all), U
                )
        else:
            Hs = H0_[None] + jnp.einsum(
                "nt,ktij->nkij", coeffs_all, ops_
            )
            Hds = jnp.conj(jnp.swapaxes(Hs, -1, -2)) * inv_h

            def h_apply(Z):
                return jnp.einsum("nkij,nkmj->nkmi", Hds, Z)

    cdt = (1j * dt * h).astype(cdtype)  # = -i·(-dt_n)·h, per step (N_T,)
    Hm = chis  # (H†/h)^{m-1} χ  (m=1)
    phi = mu_apply(chis)  # (N_T, K, L, d), scaled by h^{-(m-1)}
    coeff = cdt  # (N_T,) — (i dt_n h)^m / m!
    acc = coeff[:, None, None, None] * phi  # h · χ'
    # STATIC order count from the host-side envelope, unrolled in Python:
    # n_orders is small (~25-40), so the unrolled program stays compact.
    n_orders = _vectorized_taylor_orders(cp, amp_max)

    for m in range(2, n_orders + 1):
        # one fused H†@[φ | H̃m] einsum per order: H̃ds (the big operand)
        # is read once instead of twice per order (HBM-bandwidth bound)
        Z = jnp.concatenate([phi, Hm[:, :, None, :]], axis=2)
        Z = h_apply(Z)
        Hm = Z[:, :, -1, :]
        phi = mu_apply(Hm) + Z[:, :, :-1, :]
        coeff = coeff * cdt / m
        acc = acc + coeff[:, None, None, None] * phi
    acc = acc * inv_h
    # converged iff the LAST term was already below tolerance (the static
    # bound is chosen so this holds; report honestly like the reference's
    # non-convergence check, src/optimize.jl:640-646).  The comparison uses
    # the SAME effective tolerance that sized the static order (f32 floor
    # included) — a stricter runtime check than the selection criterion
    # would fail by construction.
    last_term = coeff[:, None, None, None] * phi
    term_norm = jnp.sqrt(jnp.max(jnp.sum(jnp.abs(last_term) ** 2, axis=-1)))
    taylor_ok = jnp.logical_or(
        jnp.logical_not(jnp.asarray(cp.taylor_grad_check_convergence)),
        term_norm < _taylor_tol_effective(cp) * h,
    )

    # ∇τ_{nkl} = ρ_k ⟨χ'_{nkl} | ψ(t_n)⟩
    grads = jnp.einsum("nkli,nki->nkl", jnp.conj(acc), psis)
    return rho[None, :, None].astype(cdtype) * grads, taylor_ok


def _evaluate_forward(cp: CompiledProblem, pd, pulsevals, want_U=False,
                      tables=None):
    """Forward pass in either storage mode.

    Returns ``(storage, checkpoints, psi_T, (J_T, J_a, J_b, tau), Us)``:
    ``storage (N_T+1, K, d)`` for ``storage_mode="full"`` (checkpoints None),
    or ``checkpoints (S, K, d)`` — the state at each segment start — for
    ``"recompute"`` (storage None), with the state running cost accumulated
    inline.  ``Us (N_T, K, d, d)`` holds the per-step propagators when
    ``want_U`` (full-storage ExpProp only); else None.
    """
    if tables is None:
        eps = jnp.reshape(
            pulsevals, (cp.n_controls, cp.n_timesteps)
        ).astype(cp.tlist.dtype)
        tables = _coeff_tables(cp, eps)
    tlist_j = jnp.asarray(cp.tlist)
    if cp.storage_mode != "recompute":
        Us = None
        if want_U:
            storage, Us = _forward(cp, tables, pd, with_U=True)
        else:
            storage = _forward(cp, tables, pd)
        J_T_val, J_a_val, J_b_val, tau = _J_parts(cp, pulsevals, storage)
        return (
            storage, None, storage[-1], (J_T_val, J_a_val, J_b_val, tau), Us
        )

    S = cp.storage_segments
    seg_len = cp.n_timesteps // S
    fwd_step = _make_fwd_step(cp, pd, tables)
    w = _grid_weights(tlist_j)
    psi0_ = jnp.asarray(cp.psi0)

    def seg_fwd(carry, s):
        psi, acc = carry
        ckpt = psi

        def inner(c2, j):
            psi2, a2 = c2
            n = s * seg_len + j
            if cp.g_b is not None:
                a2 = a2 + w[n] * jnp.sum(
                    cp.g_b(psi2, cp.trajectories, tlist_j, n)
                )
            return (fwd_step(psi2, n), a2), None

        (psi, acc), _ = lax.scan(inner, (psi, acc), jnp.arange(seg_len))
        return (psi, acc), ckpt

    (psi_T, gb_acc), checkpoints = lax.scan(
        seg_fwd, (psi0_, jnp.zeros((), dtype=cp.tlist.dtype)),
        jnp.arange(S),
    )
    tau = taus(psi_T, cp.trajectories) if cp.has_targets else None
    if cp.J_T_takes_tau:
        J_T_val = cp.J_T(psi_T, cp.trajectories, tau=tau)
    else:
        J_T_val = cp.J_T(psi_T, cp.trajectories)
    zero = jnp.zeros((), dtype=J_T_val.dtype)
    J_a_val = zero
    if cp.J_a is not None:
        J_a_val = cp.lambda_a * cp.J_a(pulsevals, cp.tlist)
    J_b_val = zero
    if cp.g_b is not None:
        gb_acc = gb_acc + w[cp.n_timesteps] * jnp.sum(
            cp.g_b(psi_T, cp.trajectories, tlist_j, cp.n_timesteps)
        )
        J_b_val = cp.lambda_b * gb_acc
    return None, checkpoints, psi_T, (J_T_val, J_a_val, J_b_val, tau), None


def build_f(cp: CompiledProblem, amp_max=None):
    """Jitted functional-only evaluation (reference
    ``evaluate_functional``, used for line-search F-only probes)."""
    if hasattr(cp, "parts"):  # heterogeneous grouped compile
        from .fg_hetero import build_f_hetero

        return build_f_hetero(cp, amp_max=amp_max)
    _warm_env_cache(cp, amp_max)
    pd = _prop_data(cp, amp_max)

    @jax.jit
    @jax.default_matmul_precision("highest")
    def f(pulsevals):
        pulsevals = jnp.asarray(pulsevals, dtype=cp.tlist.dtype)
        storage, _, psi_T, (J_T_val, J_a_val, J_b_val, tau), _ = (
            _evaluate_forward(cp, pd, pulsevals)
        )
        J = J_T_val + J_a_val + J_b_val
        aux = {
            "J_parts": jnp.stack([J_T_val, J_a_val, J_b_val]),
            "tau": pack_complex(
                tau if tau is not None else jnp.zeros(cp.n_traj)
            ),
            "psi_T": pack_complex(psi_T),
        }
        if cp.fw_prop_callback is not None:
            aux["fw_observables"] = _fw_observables(cp, storage)
        return J, aux

    return f


def _chi_boundary(cp: CompiledProblem, psi_T, tau):
    """``χ(T)`` including the ``λ_b (dt_NT / 2) ξ(T)`` boundary term
    (``src/optimize.jl:856-866``)."""
    if cp.chi_takes_tau:
        chi = cp.chi(psi_T, cp.trajectories, tau=tau)
    else:
        chi = cp.chi(psi_T, cp.trajectories)
    if cp.xi is not None:
        dt_last = cp.tlist[-1] - cp.tlist[-2]
        chi = chi + cp.lambda_b * 0.5 * dt_last * cp.xi(
            psi_T, cp.trajectories, jnp.asarray(cp.tlist), cp.n_timesteps
        )
    return chi


def build_fg(cp: CompiledProblem, amp_max=None):
    """Jitted function-and-gradient program (reference ``fg!`` /
    ``evaluate_gradient!``).

    Returns ``fg(pulsevals_flat) -> (J, grad_flat, aux)`` with the flat
    l-major pulse layout ``[ε_11.. ε_{N_T}1, ε_12..]`` matching
    ``src/workspace.jl:158-162``.

    With ``storage_mode="recompute"``, forward states are not stored in
    full: only ``S ~ sqrt(N_T)`` segment checkpoints are kept and each
    segment is re-propagated on the fly during the backward pass (memory
    ``O(sqrt(N_T))`` instead of ``O(N_T)`` states — the remat policy for
    large time grids absent from the reference, SURVEY §7).
    """
    if hasattr(cp, "parts"):  # heterogeneous grouped compile
        from .fg_hetero import build_fg_hetero

        return build_fg_hetero(cp, amp_max=amp_max)
    cdtype = cp.psi0.dtype
    rdtype = cp.tlist.dtype
    _warm_env_cache(cp, amp_max)
    pd = _prop_data(cp, amp_max)
    recompute = cp.storage_mode == "recompute"

    vec_gg = _vec_gradgen_enabled(cp, pd)
    reuse_U = _reuse_U_enabled(cp, pd) or vec_gg
    vec_bw = (
        cp.vectorize_backward
        and _vectorized_taylor_orders(cp, amp_max) is not None
    )

    # "highest": full float32 products.  On the GPU the default lets
    # XLA run float32 (complex64) matmuls in TF32, which keeps ~10
    # mantissa bits — the error then compounds over the N_T-step scans
    # by orders of magnitude and breaks unitarity.  build_f and
    # build_fg_multicall keep the same setting.
    @jax.jit
    @jax.default_matmul_precision("highest")
    def fg(pulsevals):
        pulsevals = jnp.asarray(pulsevals, dtype=rdtype)
        # ONE tables tuple for the whole program: forward and backward
        # share the traced operator constants (a second _coeff_tables
        # call would embed a second copy in the serialized program)
        eps = jnp.reshape(
            pulsevals, (cp.n_controls, cp.n_timesteps)
        ).astype(rdtype)
        tables = _coeff_tables(cp, eps)
        storage, checkpoints, psi_T, (J_T_val, J_a_val, J_b_val, tau), Us = (
            _evaluate_forward(
                cp, pd, pulsevals, want_U=reuse_U and not recompute,
                tables=tables,
            )
        )
        J = J_T_val + J_a_val + J_b_val

        chi_T = _chi_boundary(cp, psi_T, tau).astype(cdtype)
        rho = jnp.sqrt(
            jnp.sum(jnp.abs(chi_T) ** 2, axis=-1)
        )  # (K,) norms, reference :867-868
        chi_ok = jnp.all(rho > cp.chi_min_norm)
        safe_rho = jnp.where(rho > 0, rho, 1.0)
        chi_hat = chi_T / safe_rho[:, None].astype(cdtype)

        tau_grads, taylor_ok_all = _tau_grads_pass(
            cp, pd, tables, amp_max, storage, checkpoints, Us,
            chi_hat, rho, safe_rho,
        )

        grad_Tb = -2.0 * jnp.real(jnp.sum(tau_grads, axis=1))  # (N_T, L)
        grad_Tb_flat = grad_Tb.T.reshape(-1)  # l-major flat layout
        grad = grad_Tb_flat
        if cp.grad_J_a is not None:
            grad_J_a_flat = jnp.reshape(
                cp.grad_J_a(pulsevals, cp.tlist), grad.shape
            ).astype(grad.dtype)
            grad = grad + cp.lambda_a * grad_J_a_flat
        else:
            grad_J_a_flat = jnp.zeros_like(grad)
        aux = {
            "grad_J_Tb": grad_Tb_flat,
            "grad_J_a": grad_J_a_flat,
            "J_parts": jnp.stack([J_T_val, J_a_val, J_b_val]),
            "tau": pack_complex(
                tau if tau is not None else jnp.zeros(cp.n_traj)
            ),
            "psi_T": pack_complex(psi_T),
            "chi_ok": chi_ok,
            "taylor_ok": taylor_ok_all,
            "chi_norms": rho,
        }
        if cp.fw_prop_callback is not None:
            aux["fw_observables"] = _fw_observables(cp, storage)
        return J, grad, aux

    return fg


def _seg_bwd_vectorized(cp: CompiledProblem, pd, tables, checkpoints,
                        chi_carry, rho, safe_rho, amp_max, seg_idx_desc):
    """Segment-vectorized recompute backward over the (traced,
    DESCENDING) segment indices ``seg_idx_desc``: per segment, recompute
    the forward states (storing the per-step propagators when the
    segment-U budget allows), run the χ chain, then phase B
    time-vectorized over the segment window.  Returns
    ``(chi_out, (seg_grads, seg_oks))`` with
    ``seg_grads (n_scanned, seg_len, K, L)`` in scan order (descending
    segments, ascending steps within each).  ``chi_carry`` is χ entering
    the highest scanned segment from the later side — which lets
    :func:`build_fg_multicall` split one evaluation into several device
    calls."""
    seg_len = cp.n_timesteps // cp.storage_segments
    seg_vec_gg = _vec_gradgen_enabled(cp, pd)
    seg_u = _seg_reuse_U(cp, pd)
    fwd_step = _make_fwd_step(cp, pd, tables, with_U=seg_u)

    def seg_bwd(chi, s):
        ns = s * seg_len + jnp.arange(seg_len)

        def inner_fwd(psi2, j):
            n = s * seg_len + j
            if seg_u:
                psi_new, U = fwd_step(psi2, n)
                return psi_new, (psi2, U)
            return fwd_step(psi2, n), psi2

        _, seg_out = lax.scan(
            inner_fwd, checkpoints[s], jnp.arange(seg_len)
        )
        seg_psis, seg_Us = seg_out if seg_u else (seg_out, None)
        if seg_Us is not None:
            chis_seg, chi_out = _chi_trajectory(
                cp, seg_psis, seg_Us, chi, safe_rho, ns=ns
            )
        else:
            chis_seg, chi_out = _chi_prop_scan(
                cp, pd, tables, seg_psis, chi, safe_rho, ns=ns,
            )
        if seg_vec_gg:
            grads_seg = _backward_vectorized_gradgen(
                cp, tables, seg_psis, chis_seg, rho, amp_max, ns=ns,
            )
            t_ok = jnp.asarray(True)
        else:
            grads_seg, t_ok = _backward_vectorized(
                cp, tables, seg_psis, chis_seg, rho, amp_max, ns=ns,
            )
        return chi_out, (grads_seg, t_ok)

    return lax.scan(seg_bwd, chi_carry, seg_idx_desc)


def _tau_grads_pass(cp: CompiledProblem, pd, tables, amp_max, storage,
                    checkpoints, Us, chi_hat, rho, safe_rho):
    """The traced backward gradient pass shared by :func:`build_fg` and
    the heterogeneous grouped-compile builder: from the forward results
    and the normalized boundary co-states, produce
    ``(tau_grads (N_T, K, L), taylor_ok)`` via the selected path
    (time-vectorized gradgen/taylor — full-storage or
    segment-vectorized recompute — or the per-step scan fallback)."""
    cdtype = cp.psi0.dtype
    recompute = cp.storage_mode == "recompute"
    vec_gg = _vec_gradgen_enabled(cp, pd)
    reuse_U = _reuse_U_enabled(cp, pd) or vec_gg
    vec_bw = (
        cp.vectorize_backward
        and _vectorized_taylor_orders(cp, amp_max) is not None
    )
    bw_step = _make_bw_step(cp, pd, tables, rho, safe_rho, amp_max)

    if not recompute and vec_gg:
        # time-vectorized gradgen (one rank-1 Fréchet per step serves
        # all L directions): phase A via the stored propagators (full
        # storage selects this pass only within the U-storage budget)
        chis, _ = _chi_trajectory(cp, storage[:-1], Us, chi_hat, safe_rho)
        tau_grads = _backward_vectorized_gradgen(
            cp, tables, storage[:-1], chis, rho, amp_max
        )
        taylor_ok_all = jnp.asarray(True)
    elif (
        not recompute and cp.gradient_method == "taylor" and vec_bw
    ):
        # time-vectorized taylor backward: phase A via stored
        # propagators when available, else a cheap per-step
        # propagation scan (cheby/newton/expm adjoint)
        if Us is not None:
            chis, _ = _chi_trajectory(
                cp, storage[:-1], Us, chi_hat, safe_rho
            )
        else:
            chis, _ = _chi_prop_scan(
                cp, pd, tables, storage[:-1], chi_hat, safe_rho
            )
        tau_grads, taylor_ok_all = _backward_vectorized(
            cp, tables, storage[:-1], chis, rho, amp_max
        )
    elif not recompute:
        def bw_body(chi, n):
            U_n = Us[n] if Us is not None else None
            return bw_step(chi, n, storage[n], U_n)

        ns = jnp.arange(cp.n_timesteps - 1, -1, -1)
        _, (grads_rev, taylor_oks) = lax.scan(bw_body, chi_hat, ns)
        tau_grads = grads_rev[::-1]  # (N_T, K, L)
        taylor_ok_all = jnp.all(taylor_oks)
    else:
        S = cp.storage_segments
        seg_len = cp.n_timesteps // S
        # segment-vectorized recompute backward: per segment,
        # recompute the forward states, run the χ chain, then phase B
        # time-vectorized over the segment window
        seg_vec_gg = vec_gg
        seg_vec_taylor = (
            cp.gradient_method == "taylor" and vec_bw
        )
        if seg_vec_gg or seg_vec_taylor:
            _, (seg_grads, seg_oks) = _seg_bwd_vectorized(
                cp, pd, tables, checkpoints, chi_hat, rho, safe_rho,
                amp_max, jnp.arange(S - 1, -1, -1),
            )
            taylor_ok_all = jnp.all(seg_oks)
            # (S, seg_len, K, L): segments reversed, steps ascending
            tau_grads = seg_grads[::-1].reshape(
                cp.n_timesteps, cp.n_traj, cp.n_controls
            )
        else:
            fwd_step = _make_fwd_step(cp, pd, tables, with_U=reuse_U)

            def seg_bwd(chi, s):
                # recompute the forward states of segment s from its
                # checkpoint, then run the backward gradient steps
                # over it (with segment-local propagator reuse when
                # applicable)
                def inner_fwd(psi2, j):
                    n = s * seg_len + j
                    if reuse_U:
                        psi_new, U = fwd_step(psi2, n)
                        return psi_new, (psi2, U)  # Ψ(t_n), U_n
                    return fwd_step(psi2, n), psi2

                _, seg_out = lax.scan(
                    inner_fwd, checkpoints[s], jnp.arange(seg_len)
                )
                seg_psis, seg_Us = (
                    seg_out if reuse_U else (seg_out, None)
                )

                def inner_bwd(chi2, jj):
                    U_n = seg_Us[jj] if seg_Us is not None else None
                    n = s * seg_len + jj
                    return bw_step(chi2, n, seg_psis[jj], U_n)

                chi, (grads_rev, t_oks) = lax.scan(
                    inner_bwd, chi, jnp.arange(seg_len - 1, -1, -1)
                )
                return chi, (grads_rev, jnp.all(t_oks))

            _, (seg_grads, seg_oks) = lax.scan(
                seg_bwd, chi_hat, jnp.arange(S - 1, -1, -1)
            )
            taylor_ok_all = jnp.all(seg_oks)
            # (S, seg_len, K, L), segments and steps both reversed
            tau_grads = seg_grads[::-1, ::-1].reshape(
                cp.n_timesteps, cp.n_traj, cp.n_controls
            )

    return tau_grads, taylor_ok_all


def build_fg_multicall(cp: CompiledProblem, amp_max=None, n_calls=4):
    """Function-and-gradient evaluation split across ``n_calls + 1``
    device executions (recompute storage, vectorized backward only).

    This function keeps the math of :func:`build_fg` while bounding the
    length of each device execution (``optimize(...,
    eval_device_calls=n)``): one jitted
    forward program (recompute checkpoints + functional + boundary
    co-states), then ``n_calls`` invocations of ONE jitted
    backward-block program, each covering ``S/n_calls`` segments with
    the χ carry chained between calls (device-resident — no host
    round-trip of the large arrays).

    Returns ``fg(pulsevals) -> (J, grad, aux)`` with the same contract
    as :func:`build_fg` (J/grad/aux as host-ready values).
    """
    if cp.storage_mode != "recompute":
        raise ValueError("build_fg_multicall requires recompute storage")
    S = cp.storage_segments
    n_calls = int(n_calls)
    while S % n_calls != 0:
        n_calls += 1
    B = S // n_calls
    rdtype = cp.tlist.dtype
    cdtype = cp.psi0.dtype
    _warm_env_cache(cp, amp_max)
    pd = _prop_data(cp, amp_max)
    if not (
        _vec_gradgen_enabled(cp, pd)
        or (
            cp.gradient_method == "taylor" and cp.vectorize_backward
            and _vectorized_taylor_orders(cp, amp_max) is not None
        )
    ):
        raise ValueError(
            "build_fg_multicall requires the segment-vectorized "
            "backward (ExpProp gradgen, or taylor with static orders)"
        )

    if cp.mesh is not None:
        # device-argument mode: the sharded arrays enter as arguments
        import dataclasses

        from jax.sharding import NamedSharding

        dev = {
            "psi0": cp.psi0, "H0": cp.H0, "ops": cp.ops,
        }
        repl = NamedSharding(cp.mesh, P())
        arr_shardings = {k: v.sharding for k, v in dev.items()}

        def with_arrs(fn):
            def call(*args):
                *rest, arrs = args
                cp_t = dataclasses.replace(cp, **arrs)
                return fn(cp_t, *rest)
            return call
    else:
        dev = None

        def with_arrs(fn):
            def call(*args):
                return fn(cp, *args)
            return call

    def fwd_impl(cp_t, pulsevals):
        pulsevals = jnp.asarray(pulsevals, dtype=rdtype)
        eps = jnp.reshape(
            pulsevals, (cp_t.n_controls, cp_t.n_timesteps)
        ).astype(rdtype)
        tables = _coeff_tables(cp_t, eps)
        _st, checkpoints, psi_T, (J_T_val, J_a_val, J_b_val, tau), _u = (
            _evaluate_forward(cp_t, pd, pulsevals, tables=tables)
        )
        chi_T = _chi_boundary(cp_t, psi_T, tau).astype(cdtype)
        rho = jnp.sqrt(jnp.sum(jnp.abs(chi_T) ** 2, axis=-1))
        chi_ok = jnp.all(rho > cp_t.chi_min_norm)
        safe_rho = jnp.where(rho > 0, rho, 1.0)
        chi_hat = chi_T / safe_rho[:, None].astype(cdtype)
        if cp_t.grad_J_a is not None:
            grad_J_a_flat = jnp.reshape(
                cp_t.grad_J_a(pulsevals, cp_t.tlist), (-1,)
            ).astype(rdtype)
        else:
            grad_J_a_flat = jnp.zeros(
                cp_t.n_controls * cp_t.n_timesteps, dtype=rdtype
            )
        return (
            checkpoints, chi_hat, rho, safe_rho, chi_ok,
            jnp.stack([J_T_val, J_a_val, J_b_val]),
            pack_complex(tau if tau is not None else jnp.zeros(cp.n_traj)),
            pack_complex(psi_T),
            grad_J_a_flat,
        )

    def bwd_impl(cp_t, pulsevals, checkpoints, chi, rho, safe_rho, s0):
        pulsevals = jnp.asarray(pulsevals, dtype=rdtype)
        eps = jnp.reshape(
            pulsevals, (cp_t.n_controls, cp_t.n_timesteps)
        ).astype(rdtype)
        tables = _coeff_tables(cp_t, eps)
        seg_idx = s0 + jnp.arange(B - 1, -1, -1)
        chi_out, (seg_grads, seg_oks) = _seg_bwd_vectorized(
            cp_t, pd, tables, checkpoints, chi, rho, safe_rho,
            amp_max, seg_idx,
        )
        # (B, seg_len, K, L) scan order (segments descending) ->
        # ascending steps, reduced over trajectories on device
        seg_len = cp_t.n_timesteps // cp_t.storage_segments
        g_block = -2.0 * jnp.real(jnp.sum(seg_grads[::-1], axis=2))
        g_block = g_block.reshape(B * seg_len, cp_t.n_controls)
        return chi_out, g_block.astype(rdtype), jnp.all(seg_oks)

    hp = jax.default_matmul_precision("highest")  # used as a decorator
    if cp.mesh is not None:
        fwd = jax.jit(
            hp(with_arrs(fwd_impl)),
            in_shardings=(repl, arr_shardings),
            out_shardings=repl,
        )
        bwd = jax.jit(
            hp(with_arrs(bwd_impl)),
            in_shardings=(
                repl, repl, repl, repl, repl, repl, arr_shardings,
            ),
            out_shardings=repl,
        )

        def fwd_call(x):
            return fwd(x, dev)

        def bwd_call(x, ckpt, chi, rho, srho, s0):
            return bwd(x, ckpt, chi, rho, srho, s0, dev)
    else:
        fwd_call = jax.jit(hp(with_arrs(fwd_impl)))
        bwd_call = jax.jit(hp(with_arrs(bwd_impl)))

    def fg(pulsevals):
        x = np.asarray(pulsevals, dtype=np.float64)
        (ckpt, chi, rho, srho, chi_ok, J_parts, tau_p, psi_T_p,
         grad_J_a_flat) = fwd_call(x)
        blocks = []
        oks = []
        for c in range(n_calls - 1, -1, -1):
            chi, g_block, ok = bwd_call(
                x, ckpt, chi, rho, srho,
                jnp.asarray(c * B, dtype=jnp.int32),
            )
            blocks.append(g_block)
            oks.append(ok)
        # blocks were produced from the LAST time block down to the
        # first; each block is ascending in time internally
        grad_Tb = np.concatenate(
            [np.asarray(b) for b in reversed(blocks)], axis=0
        )  # (N_T, L)
        grad = grad_Tb.T.reshape(-1).astype(np.float64)
        grad_J_a_np = np.asarray(grad_J_a_flat, dtype=np.float64)
        grad = grad + cp.lambda_a * grad_J_a_np
        J_parts_np = np.asarray(J_parts, dtype=np.float64)
        aux = {
            "grad_J_Tb": grad_Tb.T.reshape(-1),
            "grad_J_a": grad_J_a_np,
            "J_parts": J_parts_np,
            "tau": np.asarray(tau_p),
            "psi_T": np.asarray(psi_T_p),
            "chi_ok": np.asarray(chi_ok),
            "taylor_ok": np.asarray(
                all(bool(np.asarray(o)) for o in oks)
            ),
            "chi_norms": np.asarray(rho),
        }
        return float(J_parts_np.sum()), grad, aux

    return fg
