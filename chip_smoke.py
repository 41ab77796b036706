"""Smoke test of the GRAPE main path on one GPU.

Run from the root of a checkout:

    python chip_smoke.py               # one GPU: the phases below, in order
    python chip_smoke.py --four-cards  # four GPUs: trajectory sharding only

Phases (one process, one JSON line each, every line naming the card and
its power limit as ``nvidia-smi`` reports them):

- ``env``: the default JAX device must be a GPU (no CPU fallback);
- ``cz_solve``: ``optimize_problem`` on the two-transmon CZ gate at its
  full width (dim=100, 4 trajectories, 4 controls, N_T=2000) through the
  native C++ L-BFGS-B; J_T must fall below the guess's (with the
  compile time and synced ms of its fg at the guess);
- ``cz_parity``, ``ensemble_parity``, ``cheby_parity``,
  ``smalld_parity``: fg on the GPU in complex64 against the same fg on
  the host CPU in complex128, at the same pulses (guess plus a seeded
  perturbation), within the stated tolerances;
- ``device_loop``: ``optimizer="device-lbfgs"`` for two chunks.

``--four-cards`` runs the trajectory-sharded ensemble through
``optimize(..., mesh=make_mesh(4))`` and compares ``build_fg_sharded``
with ``build_fg`` on one card.

Any failure propagates and the script exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import subprocess
import time
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# starting tolerances (complex64 on the card vs complex128 on the host)
J_TOL = 1e-4
GRAD_TOL = 1e-3


def card_label():
    """``name, power.limit`` of the first GPU, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def require_platform(platform="gpu", count=1):
    """The ``env`` phase: fail (SystemExit, non-zero) unless JAX's default
    devices are ``count`` or more devices of ``platform``."""
    import jax

    devs = jax.devices()
    if devs[0].platform != platform or len(devs) < count:
        raise SystemExit(
            f"chip_smoke: need {count} {platform} device(s), JAX found "
            f"{len(devs)} {devs[0].platform} device(s)"
        )
    import grape_tpu
    from grape_tpu.compile_cache import enable_compile_cache

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        grape_tpu.__file__)))
    if pkg_root != HERE:
        raise SystemExit(
            f"chip_smoke: grape_tpu imported from {pkg_root}, not from "
            f"this checkout ({HERE})"
        )
    return {
        "jax": jax.__version__,
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "compile_cache_dir": enable_compile_cache(),
    }


def _time_calls(fn, x, n_reps):
    """(compile seconds incl. the first call, median synced ms/call)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(x))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(n_reps):
        t1 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t1)
    return compile_s, 1e3 * float(np.median(ts))


def _perturbed_guess(cp, seed=0, rel=0.05):
    x0 = cp.guess_pulsevals.reshape(-1)
    rng = np.random.default_rng(seed)
    amp = max(float(np.max(np.abs(x0))), 1e-3)
    return x0 + rel * amp * rng.standard_normal(x0.shape)


def parity(trajectories, tlist, n_reps=5, j_tol=J_TOL, grad_tol=GRAD_TOL,
           **compile_kwargs):
    """fg on the default device in complex64 against fg on the host CPU
    in complex128, at the guess plus a seeded perturbation."""
    import jax

    from grape_tpu.fg import build_fg, compile_problem

    cp = compile_problem(trajectories, tlist, dtype=np.complex64,
                         **compile_kwargs)
    x = _perturbed_guess(cp)
    fg = build_fg(cp)
    compile_s, ms = _time_calls(fg, x, n_reps)
    J, g, _ = jax.device_get(fg(x))

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            cp_ref = compile_problem(trajectories, tlist,
                                     dtype=np.complex128, **compile_kwargs)
            t0 = time.perf_counter()
            J_ref, g_ref, _ = jax.device_get(build_fg(cp_ref)(x))
            ref_s = time.perf_counter() - t0
    finally:
        jax.config.update("jax_enable_x64", x64)
    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    dJ = abs(float(J) - float(J_ref))
    rel_grad = float(np.max(np.abs(g - g_ref)) / max(np.max(np.abs(g_ref)),
                                                     1e-300))
    out = {
        "dim": cp.dim, "K": cp.n_traj, "N_T": cp.n_timesteps,
        "gradient_method": cp.gradient_method,
        "prop_method": cp.fw_prop_method,
        "J": float(J), "J_ref": float(J_ref),
        "dJ": dJ, "dJ_tol": j_tol,
        "rel_grad_err": rel_grad, "rel_grad_tol": grad_tol,
        "compile_s": round(compile_s, 3), "ms_per_eval": round(ms, 3),
        "cpu_ref_s": round(ref_s, 3),
    }
    if not (np.isfinite(J) and np.all(np.isfinite(g))):
        raise AssertionError(f"non-finite fg on the device: {out}")
    if dJ > j_tol or rel_grad > grad_tol:
        raise AssertionError(f"parity outside tolerance: {out}")
    return out


def cz_solve(d=10, n_steps=2000, T=50.0, iter_stop=10, n_reps=5):
    """The main path: ``optimize_problem`` on the CZ gate, native
    L-BFGS-B, J_T below the guess's; plus the compile time and synced ms
    of the problem's fg at the guess."""
    from grape_tpu import optimize_problem
    from grape_tpu.fg import build_fg, compile_problem
    from grape_tpu.models import two_transmon_cz_problem
    from grape_tpu.optimize import _get_optimizer

    # the backend optimize() selects for these kwargs (no "optimizer"):
    # the native library, or the scipy fallback when it did not build
    backend = type(_get_optimizer(SimpleNamespace(kwargs={}))).__name__
    if backend != "LBFGSB":
        raise AssertionError(
            f"native C++ L-BFGS-B did not build (backend {backend})"
        )
    problem = two_transmon_cz_problem(d=d, n_steps=n_steps, T=T)
    cp = compile_problem(problem.trajectories, problem.tlist,
                         dtype=np.complex64, **problem.kwargs)
    compile_s, ms = _time_calls(build_fg(cp), cp.guess_pulsevals.reshape(-1),
                                n_reps)
    stamps, J_trace = [], []

    def cb(wrk, iteration):
        stamps.append(time.perf_counter())
        J_trace.append(float(wrk.result.J_T))

    t0 = time.perf_counter()
    res = optimize_problem(
        problem, dtype=np.complex64, iter_stop=iter_stop,
        rethrow_exceptions=True, callback=cb, print_iters=False,
    )
    first_s = stamps[0] - t0
    per_iter = np.diff(np.asarray(stamps[1:]))
    out = {
        "dim": d * d, "N_T": n_steps, "optimizer": backend,
        "gradient_method": cp.gradient_method,
        "compile_s": round(compile_s, 3), "ms_per_eval": round(ms, 3),
        "iters": int(res.iter), "fg_calls": int(res.fg_calls),
        "J_T_guess": J_trace[0], "J_T": float(res.J_T),
        "iter0_s": round(first_s, 3),
        "median_s_per_iter_after_1": (
            round(float(np.median(per_iter)), 4) if len(per_iter) else None
        ),
    }
    if not (np.isfinite(res.J_T) and res.J_T < J_trace[0]):
        raise AssertionError(f"J_T did not decrease: {out}")
    return out


def cz_parity(d=10, n_steps=800, T=50.0, **kw):
    """Shared generator (the CZ gate), taylor and gradgen."""
    from grape_tpu.models import two_transmon_cz_problem

    p = two_transmon_cz_problem(d=d, n_steps=n_steps, T=T)
    return {
        m: parity(p.trajectories, p.tlist, gradient_method=m, **p.kwargs,
                  **kw)
        for m in ("taylor", "gradgen")
    }


def _cut(out, n_steps, full_n_steps):
    if n_steps != full_n_steps:
        out["N_T_cut_from"] = full_n_steps
    return out


def ensemble_parity(n_samples=8, d=10, n_steps=200, full_n_steps=800,
                    **kw):
    """K = 4·n_samples distinct Hamiltonians, gradgen.  The CPU
    reference costs one d×d Fréchet derivative per (step, trajectory),
    so N_T is cut (at the full problem's time step) to keep it near a
    minute."""
    from grape_tpu.models import two_transmon_cz_ensemble_problem

    T = 50.0 * n_steps / full_n_steps
    p = two_transmon_cz_ensemble_problem(n_samples=n_samples, d=d,
                                         n_steps=n_steps, T=T)
    out = parity(p.trajectories, p.tlist, gradient_method="gradgen",
                 **p.kwargs, **kw)
    return _cut(out, n_steps, full_n_steps)


def cheby_parity(d=32, n_basis=64, n_steps=10, full_n_steps=100, **kw):
    """Chebyshev propagation at dim=d², taylor.  N_T is cut (at the full
    problem's time step, T=1.0 over 100 steps) to keep the complex128
    CPU reference near a minute."""
    from grape_tpu.models import two_transmon_subspace_gate_problem

    T = 1.0 * n_steps / full_n_steps
    p = two_transmon_subspace_gate_problem(d=d, n_basis=n_basis,
                                           n_steps=n_steps, T=T)
    out = parity(p.trajectories, p.tlist, prop_method="cheby",
                 gradient_method="taylor", **p.kwargs, **kw)
    return _cut(out, n_steps, full_n_steps)


def smalld_parity(n_samples=1024, d=3, T=20.0, n_steps=400, **kw):
    """Small-d ensemble (K distinct qutrit Hamiltonians), taylor."""
    from grape_tpu.functionals import J_T_sm
    from grape_tpu.models import transmon_ensemble_trajectories

    trajs = transmon_ensemble_trajectories(n_samples, d=d, T=T)
    tlist = np.linspace(0.0, T, n_steps + 1)
    return parity(trajs, tlist, J_T=J_T_sm, gradient_method="taylor", **kw)


def device_loop(d=10, n_steps=2000, T=50.0, chunk=5, bound=0.5):
    """``optimizer="device-lbfgs"`` for two chunks on the CZ gate.  The
    box bounds (10× the guess amplitude, never active) fix the amplitude
    envelope, so the second chunk reuses the first chunk's program: its
    time is the loop's steady state (the first chunk's holds the
    compilation)."""
    from grape_tpu import optimize_problem
    from grape_tpu.models import two_transmon_cz_problem

    stamps, J_trace = {}, []

    def cb(wrk, iteration):
        stamps[iteration] = (time.perf_counter(), int(wrk.result.fg_calls))
        J_trace.append(float(wrk.result.J_T))

    t0 = time.perf_counter()
    res = optimize_problem(
        two_transmon_cz_problem(d=d, n_steps=n_steps, T=T),
        dtype=np.complex64, optimizer="device-lbfgs",
        device_loop_iters=chunk, iter_stop=2 * chunk,
        upper_bound=bound, lower_bound=-bound,
        rethrow_exceptions=True, callback=cb, print_iters=False,
    )
    out = {
        "dim": d * d, "N_T": n_steps, "chunk_iters": chunk,
        "iters": int(res.iter), "fg_calls": int(res.fg_calls),
        "J_T_guess": J_trace[0], "J_T": float(res.J_T),
        "first_chunk_s": round(stamps.get(chunk, (t0,))[0] - t0, 3),
    }
    if chunk in stamps and 2 * chunk in stamps:
        (t1, c1), (t2, c2) = stamps[chunk], stamps[2 * chunk]
        out["second_chunk_s"] = round(t2 - t1, 4)
        out["second_chunk_ms_per_eval"] = round(
            1e3 * (t2 - t1) / max(c2 - c1, 1), 3
        )
    if not (res.iter == 2 * chunk and np.isfinite(res.J_T)
            and res.J_T < J_trace[0]):
        raise AssertionError(f"device loop did not run two chunks: {out}")
    return out


def four_cards(n_devices=4, n_samples=8, d=10, n_steps=800, iters=5,
               n_reps=5):
    """Trajectory sharding over ``n_devices``: ``optimize(mesh=...)``,
    sharded fg against the one-device fg, and the placement of the
    sharded problem arrays."""
    import jax

    from grape_tpu import optimize_problem
    from grape_tpu.fg import build_fg, compile_problem
    from grape_tpu.models import two_transmon_cz_ensemble_problem
    from grape_tpu.parallel import build_fg_sharded, make_mesh

    p = two_transmon_cz_ensemble_problem(n_samples=n_samples, d=d,
                                         n_steps=n_steps)
    mesh = make_mesh(n_devices)
    stamps, J_trace = [], []

    def cb(wrk, iteration):
        stamps.append((time.perf_counter(), int(wrk.result.fg_calls)))
        J_trace.append(float(wrk.result.J_T))

    res = optimize_problem(
        p, dtype=np.complex64, mesh=mesh, iter_stop=iters,
        rethrow_exceptions=True, callback=cb, print_iters=False,
    )
    if not (np.isfinite(res.J_T) and res.J_T < J_trace[0]):
        raise AssertionError(f"sharded solve: J_T {J_trace[0]} -> {res.J_T}")
    (t1, c1), (tn, cn) = stamps[1], stamps[-1]
    solve_ms_per_eval = 1e3 * (tn - t1) / max(cn - c1, 1)

    cp = compile_problem(p.trajectories, p.tlist, dtype=np.complex64,
                         **p.kwargs)
    x = _perturbed_guess(cp)
    fg1 = build_fg(cp)
    c1_s, ms1 = _time_calls(fg1, x, n_reps)
    J1, g1, _ = jax.device_get(fg1(x))
    fg_sh, cp_sh = build_fg_sharded(cp, mesh)
    cs_s, ms_sh = _time_calls(fg_sh, x, n_reps)
    Js, gs, _ = jax.device_get(fg_sh(x))

    spans = {
        name: len({s.device for s in getattr(cp_sh, name).addressable_shards})
        for name in ("psi0", "H0", "ops")
    }
    local_K = {
        name: getattr(cp_sh, name).addressable_shards[0].data.shape[0]
        for name in ("psi0", "H0", "ops")
    }
    g1, gs = np.asarray(g1, np.float64), np.asarray(gs, np.float64)
    dJ = abs(float(Js) - float(J1))
    rel_grad = float(np.max(np.abs(gs - g1)) / max(np.max(np.abs(g1)),
                                                   1e-300))
    # reduction-order tolerance: the same complex64 math, summed over
    # trajectories in another order
    j_tol, g_tol = 1e-5 * max(1.0, abs(float(J1))), 1e-4
    out = {
        "n_devices": n_devices, "dim": cp.dim, "K": cp.n_traj,
        "N_T": cp.n_timesteps,
        "solve_iters": int(res.iter), "solve_J_T_guess": J_trace[0],
        "solve_J_T": float(res.J_T),
        "solve_ms_per_eval": round(solve_ms_per_eval, 3),
        "ms_per_eval_1dev": round(ms1, 3),
        "ms_per_eval_sharded": round(ms_sh, 3),
        "compile_s_1dev": round(c1_s, 3), "compile_s_sharded": round(cs_s, 3),
        "dJ": dJ, "dJ_tol": j_tol,
        "rel_grad_err": rel_grad, "rel_grad_tol": g_tol,
        "devices_spanned": spans, "local_leading_dim": local_K,
    }
    if dJ > j_tol or rel_grad > g_tol:
        raise AssertionError(f"sharded fg differs from one device: {out}")
    if any(n != n_devices for n in spans.values()):
        raise AssertionError(f"sharded arrays do not span the mesh: {out}")
    return out


ONE_CARD_PHASES = (
    ("cz_solve", cz_solve),
    ("cz_parity", cz_parity),
    ("ensemble_parity", ensemble_parity),
    ("cheby_parity", cheby_parity),
    ("smalld_parity", smalld_parity),
    ("device_loop", device_loop),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU trajectory-sharding path")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    env = require_platform("gpu", n_cards)
    card = card_label()

    def emit(phase, fields):
        print(json.dumps({"phase": phase, "card": card, **fields}),
              flush=True)

    emit("env", env)
    if args.four_cards:
        phases = (("four_cards", four_cards),)
    else:
        phases = ONE_CARD_PHASES
    for name, fn in phases:
        t0 = time.perf_counter()
        out = fn()
        out["phase_s"] = round(time.perf_counter() - t0, 3)
        emit(name, out)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": env["platform"], "kind": env["kind"],
        "count": env["count"],
    }}), flush=True)


if __name__ == "__main__":
    main()
