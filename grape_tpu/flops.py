"""Analytic FLOP model for the fg evaluation (auditable MFU).

XLA's ``cost_analysis()`` undercounts loop bodies (``lax.scan`` /
``fori_loop`` trip counts are not always folded in).  This module counts
the algorithmic complex-arithmetic FLOPs of one function-and-gradient
evaluation from the SAME host-side path-selection logic ``build_fg`` uses
(shared-generator detection, vectorized-backward gating, static
Taylor-order / squaring counts), so every benchmark row carries a
formula-derived, nonzero FLOP count.

Conventions
-----------
- one complex multiply-add = 8 real FLOPs;
- a ``d×d @ d×d`` complex matmul = ``8·d³``, a matvec = ``8·d²``;
- the count is the ALGORITHMIC work (what the textbook formula costs),
  independent of how XLA lowers the complex products;
- O(d) and O(L·N_T) bookkeeping terms (coefficient tables, trapezoid
  weights, functionals) are omitted: they are ≤ 1e-3 of any entry here.

Per-path formulas (cited against the implementations):

- ``expm`` (f32 Taylor-PS, ``ops/expm.py:79-101``): degree-16
  Paterson–Stockmeyer = A²,A³,A⁴ (3 matmuls) + 4 Horner blocks (4) = 7
  matmuls, + ``s`` squaring matmuls.
- ``expm_frechet`` (``ops/frechet.py:32-78,128-186``): base = 3 (powers)
  + 6·Ldir (M-chain) + 4 (Horner E) + 7·Ldir (Horner dE; the first block
  has no dE carry) = 7 + 13·Ldir matmul-equivalents (the Ldir direction
  axis batches into single HLO dots); each squaring = 1 + 2·Ldir.
- Chebyshev (``ops/cheby.py:73-95``): ``n_c`` coefficient terms = ``n_c −
  1`` matvecs of the state block per step.
- vectorized Taylor backward (``fg.py:_backward_vectorized``): per order,
  ``h_apply`` = K·(L+1) matvecs/step, ``mu_apply`` = K·T matvecs/step +
  the (T→L) contraction ``8·K·L·T·d``/step.
"""

import numpy as np

__all__ = ["fg_flops"]

_EXPM_F32_MATMULS = 7     # degree-16 Taylor-PS (see module docstring)
_EXPM_F64_MATMULS = 9     # Padé-13: A2/A4/A6 + 3 products + ~3 for the solve


def _expm_matmuls(cp):
    return (
        _EXPM_F32_MATMULS
        if np.dtype(cp.psi0.dtype) == np.complex64
        else _EXPM_F64_MATMULS
    )


def fg_flops(cp, amp_max=None):
    """Formula-derived FLOPs of ONE fg evaluation of `cp` (float)."""
    from . import fg as _fg

    pd = _fg._prop_data(cp, amp_max)
    vec_gg = _fg._vec_gradgen_enabled(cp, pd)
    reuse_U = _fg._reuse_U_enabled(cp, pd) or vec_gg
    n_ord = _fg._vectorized_taylor_orders(cp, amp_max)
    vec_bw = cp.vectorize_backward and n_ord is not None
    s = _fg._expm_squarings(cp, amp_max)

    d, K, L, N_T = cp.dim, cp.n_traj, cp.n_controls, cp.n_timesteps
    T = int(np.asarray(cp.M).shape[-2])
    k_u = 1 if cp.shared_generator else K
    MM = 8.0 * d**3
    MV = 8.0 * d**2
    e_mm = _expm_matmuls(cp)

    def cheby_terms(pd_dir, key):
        return int(np.asarray(pd_dir[key]).shape[1])

    total = 0.0

    # ---- forward propagation -------------------------------------------
    pd_fw = pd["fw"]
    # generator grouping (gate ensembles): the grouped ExpProp step
    # derives one expm per (step, group) — executed-work accounting
    k_fw = k_u
    if (
        not cp.shared_generator
        and pd_fw is None
        and _fg._effective_group_size(cp) > 1
    ):
        k_fw = K // _fg._effective_group_size(cp)
    total += N_T * k_fw * T * MV  # H_n assembly from the T term operators
    if pd_fw is None:  # ExpProp
        total += N_T * (k_fw * (e_mm + s) * MM + K * MV)
    elif pd_fw["kind"] == "cheby":
        n_c = cheby_terms(pd_fw, "tab_fw")
        total += N_T * (n_c - 1) * K * MV
    else:  # newton/arnoldi: m substep matvecs + small-matrix expm
        m = pd_fw["m"] * pd_fw["substeps"]
        total += N_T * K * m * MV

    # ---- backward gradient ----------------------------------------------
    recompute = cp.storage_mode == "recompute"
    if recompute:
        # segment re-propagation duplicates the forward work once
        total *= 2.0

    if vec_gg:
        # phase A: chi chain — one U†χ matvec/step with stored
        # propagators (full storage within budget, or per-segment
        # within the segment budget), else a per-step (grouped) adjoint
        # expm scan; phase B: one rank-1 Fréchet per step (directions =
        # K when the base shares).  Identical per-step accounting in
        # both storage modes — recompute only re-runs the forward.
        k_a = 1 if cp.shared_generator else (
            K // _fg._effective_group_size(cp)
        )
        u_stored = (
            _fg._seg_reuse_U(cp, pd) if recompute
            else _fg._gg_u_bytes_ok(cp)
        )
        if u_stored:
            total += N_T * K * MV
        else:
            total += N_T * (k_a * (e_mm + s) * MM + K * MV)
        total += N_T * K * MV  # R = psi chi† outer products
        if cp.shared_generator:
            fre_mm = (7 + 13 * K) + s * (1 + 2 * K)
            total += N_T * fre_mm * MM
        else:
            fre_mm = 20 + 3 * s  # one direction, per (n, k)
            total += N_T * K * fre_mm * MM
            total += N_T * k_u * T * MV  # H_n reassembly
        total += N_T * K * T * MV  # tr(Op_j G) contractions
        return total

    if cp.gradient_method == "taylor" and vec_bw:
        # phase A
        pd_bw = pd["bw"]
        k_a = 1 if cp.shared_generator else (
            K // _fg._effective_group_size(cp)
        )
        u_avail = (
            _fg._seg_reuse_U(cp, pd) if recompute
            else (reuse_U and pd_bw is None)
        )
        if u_avail and pd_bw is None:
            total += N_T * K * MV  # U† chi matvecs
        elif pd_bw is not None and pd_bw["kind"] == "cheby":
            n_c = cheby_terms(pd_bw, "tab_bw")
            total += N_T * ((n_c - 1) * K * MV + k_u * T * MV)
        else:
            total += N_T * (k_a * (e_mm + s) * MM + K * MV + k_a * T * MV)
        # phase B: n_ord orders of the batched recursion
        per_order = N_T * (
            K * (L + 1) * MV + K * T * MV + 8.0 * K * L * T * d
        )
        total += (n_ord + 1) * per_order
        total += N_T * k_u * T * MV  # H_n† assembly
        return total

    # per-step scan fallbacks (and recompute mode)
    total += N_T * k_u * T * MV  # H_n reassembly in the backward scan
    if cp.gradient_method == "taylor":
        # dynamic while_loop: bound the order from the envelope (the
        # static-order estimate; the loop exits at the same tolerance)
        orders = n_ord if n_ord is not None else cp.taylor_grad_max_order
        per_step = K * orders * ((L + 2) * MV + T * MV + 8.0 * L * T * d)
        total += N_T * per_step
        # co-state propagation
        if reuse_U:
            total += N_T * K * MV
        else:
            pd_bw = pd["bw"]
            if pd_bw is not None and pd_bw["kind"] == "cheby":
                n_c = cheby_terms(pd_bw, "tab_bw")
                total += N_T * (n_c - 1) * K * MV
            else:
                total += N_T * (k_u * (e_mm + s) * MM + K * MV)
    else:  # gradgen
        pd_g = pd["grad"]
        if pd_g is None:
            total += N_T * K * ((20 + 3 * s) * MM + (L + 1) * MV)
        elif pd_g["kind"] == "cheby":
            n_c = cheby_terms(pd_g, "tab_bw")
            # extended-state (L+1)·d matvec + L mu-injections per term
            total += N_T * (n_c - 1) * K * (2 * L + 1) * MV
        else:
            m = pd_g["m"] * pd_g["substeps"]
            total += N_T * K * m * (2 * L + 1) * MV
    return total
