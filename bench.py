"""GRAPE benchmark — prints ONE JSON line.

Headline metric (BASELINE.json): propagation steps/s/device for the fused
function-and-gradient evaluation (forward expm scan + backward gradient
scan) on the two-transmon CZ configuration (dim=100, 4 trajectories,
4 drive controls).  ``vs_baseline`` is the speedup of the accelerator
(complex64) over the same program on one CPU host in float64 — a
proxy for the reference, which is a CPU/Float64 code with no published
numbers (BASELINE.md).

The ``sweep`` field carries the BASELINE dim sweep (2 → 1024; Chebyshev
propagation where a dense expm per step stops making sense) with
per-config achieved FLOP/s and MFU so the performance claims are
auditable.  FLOP counts are ANALYTIC (``grape_tpu.flops.fg_flops``:
formula-derived from the compiled problem's path selection — expm degree
× squarings × d³, Chebyshev order × d², Taylor orders × d²·L — with the
per-kernel matmul constants pinned against compiled HLO in
``tests/test_flops_model.py``); XLA's ``cost_analysis()`` estimate is
reported alongside as ``flops_xla`` where available (it undercounts loop
bodies).  Utilization is quoted against the device's peak at the
precision the program runs (see ``PEAK_FLOPS``).

Every timed evaluation is synced by transferring the scalar J to host;
the first execution of a program (compilation) is excluded via a warmup
evaluation.  The sweep stops early (entries marked ``skipped``) if the
wall-clock budget runs out, so the headline number always lands.
"""

import json
import os
import time

import numpy as np
import jax

from grape_tpu.compile_cache import enable_compile_cache

N_STEPS = 800
K_TRAJ = 4
SWEEP_BUDGET_S = float(os.environ.get("GRAPE_BENCH_SWEEP_BUDGET", "1500"))

# Peak FLOP/s at the precision the program runs, keyed by
# ``device.device_kind``.  Every fg program runs complex64 products under
# ``jax.default_matmul_precision("highest")``, i.e. on the float32 CUDA
# cores, not the tensor cores.  Source: NVIDIA H100 data sheet, SXM part,
# FP32 67 TFLOP/s (at the 700 W power limit).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,
}


def peak_flops(device):
    """Peak FLOP/s of ``device`` from ``PEAK_FLOPS``; an unknown device
    kind is an error, not a guess."""
    kind = getattr(device, "device_kind", "")
    if kind not in PEAK_FLOPS:
        raise KeyError(
            f"no peak FLOP/s for device kind {kind!r}: add it to "
            "bench.PEAK_FLOPS with its source"
        )
    return PEAK_FLOPS[kind]


def _env_info():
    """Platform/device labels attached to every row, so that a CPU capture
    and an on-device capture of the same metric cannot be confused."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": getattr(d, "device_kind", ""),
    }


def _build_cz(n_steps, dtype, gradient_method="taylor"):
    from grape_tpu.fg import build_fg, compile_problem
    from grape_tpu.models import two_transmon_cz_problem

    problem = two_transmon_cz_problem(d=10, n_steps=n_steps, T=50.0)
    cp = compile_problem(
        problem.trajectories, problem.tlist, dtype=dtype,
        gradient_method=gradient_method,
        **problem.kwargs
    )
    return build_fg(cp), cp


def _time_fg(fg, x, n_iter, pipelined=False):
    """Timing stats dict: ``mean``/``std`` of per-evaluation synced wall
    time over ``n_reps`` repeats (each evaluation hard-synced by the
    scalar J transfer), plus ``pipelined`` mean (n dispatches, ONE sync —
    amortizes the per-call launch+sync latency) when requested.  Repeat
    counts and dispersion ride every bench row so runs are
    self-describing."""
    rng = np.random.default_rng(0)
    J = float(fg(x)[0])  # warmup: trace + device compile + first execution
    assert np.isfinite(J)
    xs = [x + 0.01 * rng.normal(size=x.shape) for _ in range(n_iter)]
    ts = []
    for xi in xs:
        t1 = time.perf_counter()
        v = float(fg(xi)[0])  # scalar host transfer = hard sync
        ts.append(time.perf_counter() - t1)
        assert np.isfinite(v)
    out = {
        "mean": float(np.mean(ts)),
        "std": float(np.std(ts)),
        "n_reps": int(n_iter),
    }
    if pipelined:
        t0 = time.perf_counter()
        outs = [fg(xi) for xi in xs]
        acc = float(outs[-1][0])
        out["pipelined"] = (time.perf_counter() - t0) / n_iter
        assert np.isfinite(acc)
    return out


def _flops_estimate(fg, x):
    """XLA's own FLOP estimate for one compiled fg evaluation (secondary;
    undercounts loop bodies)."""
    try:
        cost = fg.lower(x).compile().cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        return float(cost.get("flops", 0.0)) or None
    except Exception:
        return None


def _flops_analytic(cp):
    """Formula-derived FLOPs per fg evaluation (primary; auditable)."""
    try:
        from grape_tpu.flops import fg_flops

        return float(fg_flops(cp))
    except Exception:
        return None


def _sweep_configs():
    """BASELINE dim sweep 2 -> 1024 (Chebyshev where expm doesn't fit)."""
    from grape_tpu.fg import build_fg, compile_problem
    from grape_tpu.functionals import J_T_sm
    from grape_tpu.models import tls_problem, two_transmon_cz_problem

    def cz(d, n_steps, method, prop, T=50.0):
        # T shrinks with d: the transmon anharmonicity term grows ~d², so
        # dt·||H|| must stay in the propagator's convergent regime
        problem = two_transmon_cz_problem(d=d, n_steps=n_steps, T=T)
        kw = dict(problem.kwargs)
        if prop != "expprop":
            kw["prop_method"] = prop
        cp = compile_problem(
            problem.trajectories, problem.tlist, dtype=np.complex64,
            gradient_method=method, **kw
        )
        return build_fg(cp), cp

    def tls(n_steps, method):
        problem = tls_problem(n_steps=n_steps)
        cp = compile_problem(
            problem.trajectories, problem.tlist, dtype=np.complex64,
            gradient_method=method, J_T=J_T_sm, **problem.kwargs
        )
        return build_fg(cp), cp

    def subspace_gate(d, n_basis, n_steps, T, method="taylor",
                      prop="cheby"):
        # fat-batch gate synthesis: K=n_basis basis states, ONE shared
        # generator -> the per-term H-apply is one (K, dim)@(dim, dim)
        # matmul instead of K thin ones
        from grape_tpu.models import two_transmon_subspace_gate_problem

        problem = two_transmon_subspace_gate_problem(
            d=d, n_basis=n_basis, n_steps=n_steps, T=T
        )
        kw = dict(problem.kwargs)
        if prop != "expprop":
            kw["prop_method"] = prop
        cp = compile_problem(
            problem.trajectories, problem.tlist, dtype=np.complex64,
            gradient_method=method, **kw
        )
        return build_fg(cp), cp

    def cz_ensemble(n_samples, n_steps, method="gradgen", T=50.0,
                    storage_mode="full"):
        # robust-CZ ensemble: K = 4*n_samples DISTINCT generators, one
        # shared control set (BASELINE config-5 north star)
        # (storage_mode="recompute" → the segment-vectorized backward,
        # the only feasible mode at the 1024-sample letter scale)
        from grape_tpu.models import two_transmon_cz_ensemble_problem

        problem = two_transmon_cz_ensemble_problem(
            n_samples=n_samples, d=10, n_steps=n_steps, T=T
        )
        cp = compile_problem(
            problem.trajectories, problem.tlist, dtype=np.complex64,
            gradient_method=method,
            storage_mode=storage_mode, **problem.kwargs
        )
        if cp.H0.nbytes + cp.ops.nbytes > 256 * 1024**2:
            # letter scale: device-argument build (the operator arrays
            # as sharded buffers, not program constants) + the fg
            # evaluation split across bounded-duration device calls
            from grape_tpu.fg import build_fg_multicall
            from grape_tpu.parallel import make_mesh, shard_problem

            cp = shard_problem(cp, make_mesh(1))
            return build_fg_multicall(cp, n_calls=3), cp
        return build_fg(cp), cp

    def ensemble(K, n_steps):
        from grape_tpu.models import transmon_ensemble_trajectories

        trajs = transmon_ensemble_trajectories(K, d=3, T=20.0)
        tlist = np.linspace(0, 20.0, n_steps + 1)
        cp = compile_problem(
            trajs, tlist, J_T=J_T_sm, dtype=np.complex64,
            gradient_method="taylor",
        )
        return build_fg(cp), cp

    return [
        # ordered by evidence value: the budget cuts from the tail
        ("cz_optimize_iters", None, 800, 4),  # end-to-end GRAPE iters/s
        # out-of-the-box default (no optimizer argument)
        ("cz_auto_iters", None, 800, 4),
        ("dim100_cz_gradgen", lambda: cz(10, 800, "gradgen", "expprop"),
         800, 4),
        # BASELINE config 4 at its SPECIFIED 2000 steps
        ("dim100_cz2000_gradgen",
         lambda: cz(10, 2000, "gradgen", "expprop"), 2000, 4),
        ("dim100_cz2000_taylor",
         lambda: cz(10, 2000, "taylor", "expprop"), 2000, 4),
        # per-trajectory generators at dim=100 (K distinct H)
        ("dim100_cz_ensembleK32_gradgen",
         lambda: cz_ensemble(8, 800), 800, 32),
        ("dim100_cz_ensembleK8_gradgen",
         lambda: cz_ensemble(2, 800), 800, 8),
        ("ensemble1024_qutrit_taylor", lambda: ensemble(1024, 400),
         400, 1024),  # BASELINE config 5 (small-d ensemble)
        ("cz_device_loop_iters", None, 800, 4),  # device-resident loop
        # robust ensemble x device-resident native L-BFGS (BASELINE
        # config-5 pattern)
        ("ens_cz_device_loop_iters", None, 800, 32),
        # BASELINE config-5 AT THE LETTER: 1024 Hamiltonian samples ->
        # K=4096 trajectories, dim=100, 2000 steps, segment-vectorized
        # recompute backward, fg split across bounded-duration device
        # calls
        ("dim100_cz_ens1024samples_recompute",
         lambda: cz_ensemble(
             1024, 2000, storage_mode="recompute"
         ), 2000, 4096),
        ("dim16_cz_taylor", lambda: cz(4, 400, "taylor", "expprop"),
         400, 4),
        ("dim256_cz_cheby_taylor",
         lambda: cz(16, 200, "taylor", "cheby", T=5.0), 200, 4),
        ("dim1024_cz_cheby_taylor",
         lambda: cz(32, 100, "taylor", "cheby", T=1.0), 100, 4),
        # fat-batch regime: K=64 basis-state trajectories under one
        # shared generator (wide matmuls where the K=4 CZ has thin ones)
        ("dim1024_subspace_gate_K64",
         lambda: subspace_gate(32, 64, 100, 1.0), 100, 64),
        ("dim100_subspace_K64_gradgen",
         lambda: subspace_gate(10, 64, 800, 50.0, "gradgen", "expprop"),
         800, 64),
        # large-dim gradgen (extended-state cheby gradient generator)
        ("dim256_cz_cheby_gradgen",
         lambda: cz(16, 200, "gradgen", "cheby", T=5.0), 200, 4),
        ("dim1024_cz_cheby_gradgen",
         lambda: cz(32, 100, "gradgen", "cheby", T=1.0), 100, 4),
        ("dim2_tls_taylor", lambda: tls(800, "taylor"), 800, 1),
        # sharded-vs-unsharded fg on a 1-device mesh: isolates the
        # SPMD/collective-insertion overhead — the psum payload is L*N_T
        # floats
        ("sharded_1dev_overhead", None, 800, 4),
    ]


def _optimize_iters_entry(name):
    """End-to-end GRAPE iterations/s (BASELINE metric): the full
    optimize() loop — jitted fg, host C++ L-BFGS-B, callbacks — on the
    CZ dim=100 configuration.  The first iteration (compilation) is
    excluded via callback timestamps.  ``optimizer="lbfgsb"`` is pinned,
    whatever "auto" selects (the ``cz_auto_iters`` row)."""
    from grape_tpu import optimize_problem
    from grape_tpu.models import two_transmon_cz_problem

    problem = two_transmon_cz_problem(d=10, n_steps=800, T=50.0)
    stamps = []

    def cb(wrk, iteration):
        stamps.append(time.perf_counter())

    res = optimize_problem(
        problem, dtype=np.complex64, gradient_method="taylor",
        optimizer="lbfgsb",
        iter_stop=12, callback=cb, print_iters=False,
        rethrow_exceptions=True,
    )
    # stamps[0] = iteration 0 (first fg: compile).  One iteration
    # typically also pays an amplitude-envelope re-jit (the optimizer
    # grows the pulses past the guess envelope once); report the median
    # per-iteration rate as steady state and the mean including re-jits.
    dts = np.diff(np.asarray(stamps[1:]))
    if len(dts) == 0:  # converged within 2 iterations: no timed window
        steady = incl = 0.0
    else:
        steady = 1.0 / max(float(np.median(dts)), 1e-9)
        incl = len(dts) / max(float(np.sum(dts)), 1e-9)
    return {
        "config": name,
        **_env_info(),
        "dim": 100,
        "n_steps": 800,
        "iters": int(res.iter),
        "fg_calls": int(res.fg_calls),
        "J_T": round(float(res.J_T), 6),
        "grape_iters_per_s": round(steady, 2),
        "grape_iters_per_s_incl_rejit": round(incl, 2),
    }


def _device_loop_iters_entry(name):
    """End-to-end GRAPE iterations/s with the DEVICE-RESIDENT optimizer
    loop (``optimizer="device-lbfgs"``): chunks of the NATIVE traced
    L-BFGS + Moré-Thuente strong-Wolfe iterations (round 4;
    optimizers/jax_lbfgs.py — ~1.55 fg/iteration where the round-3 optax
    zoom spent ~2.1 plus a mandatory re-evaluation) run inside one
    jitted scan with fg inlined, one host sync per chunk instead of one
    per fg evaluation.  Steady state excludes the first chunk (program
    compile):
    rate = iterations after the first chunk boundary / wall time after
    it.  ``fg_evals_per_s`` counts line-search probes."""
    from grape_tpu import optimize_problem
    from grape_tpu.models import (
        two_transmon_cz_ensemble_problem, two_transmon_cz_problem,
    )

    if name == "ens_cz_device_loop_iters":
        # BASELINE config-5 north star end-to-end: robust-CZ ensemble
        # (K=32 DISTINCT Hamiltonians) solved by the device-resident
        # native L-BFGS
        problem = two_transmon_cz_ensemble_problem(
            n_samples=8, d=10, n_steps=800, T=50.0
        )
        dim, K = 100, 32
    else:
        problem = two_transmon_cz_problem(d=10, n_steps=800, T=50.0)
        dim, K = 100, 4
    chunk = 16
    stamps = []

    def cb(wrk, iteration):
        stamps.append((iteration, time.perf_counter(),
                       int(wrk.result.fg_calls)))

    res = optimize_problem(
        problem, dtype=np.complex64, gradient_method="gradgen",
        optimizer="device-lbfgs", device_loop_iters=chunk,
        # finite bounds => bound-derived amplitude envelope: no mid-chunk
        # envelope growth, and the loop projects onto the box after each
        # update (10x the guess amplitude E0=0.05 — never active here)
        upper_bound=0.5, lower_bound=-0.5,
        iter_stop=4 * chunk, callback=cb, print_iters=False,
        rethrow_exceptions=True,
    )
    # stamps at iterations inside a chunk replay in a burst; the chunk
    # boundaries carry the device time.  Steady window: from the last
    # stamp of chunk 1 (iteration == chunk) to the final stamp.
    t_by_iter = {it: t for it, t, _ in stamps}
    fg_by_iter = {it: c for it, _, c in stamps}
    last_it = stamps[-1][0]
    entry = {
        "config": name,
        **_env_info(),
        "dim": dim,
        "n_traj": K,
        "n_steps": 800,
        "iters": int(res.iter),
        "fg_calls": int(res.fg_calls),
        "J_T": round(float(res.J_T), 6),
        "chunk_iters": chunk,
        "optimizer": "native-lbfgs-mt",
    }
    if last_it > chunk and chunk in t_by_iter:
        dt = t_by_iter[last_it] - t_by_iter[chunk]
        n_it = last_it - chunk
        n_fg = fg_by_iter[last_it] - fg_by_iter[chunk]
        entry["grape_iters_per_s"] = round(n_it / max(dt, 1e-9), 2)
        entry["fg_evals_per_s"] = round(n_fg / max(dt, 1e-9), 2)
    else:  # converged inside the first chunk: no steady window
        entry["grape_iters_per_s"] = None
    return entry


def _auto_iters_entry(name):
    """Out-of-the-box end-to-end GRAPE iterations/s: optimize() with NO
    optimizer argument ("auto").  The rate is (iters after the ramp) /
    (wall time after the ramp), with the ramp = the first 7
    iterations."""
    from grape_tpu import optimize_problem
    from grape_tpu.models import two_transmon_cz_problem

    problem = two_transmon_cz_problem(d=10, n_steps=800, T=50.0)
    stamps = []

    def cb(wrk, iteration):
        stamps.append((iteration, time.perf_counter()))

    res = optimize_problem(
        problem, dtype=np.complex64, gradient_method="gradgen",
        upper_bound=0.5, lower_bound=-0.5,
        iter_stop=39, callback=cb, print_iters=False,
        rethrow_exceptions=True,
    )
    t_by_iter = {it: t for it, t in stamps}
    last_it = stamps[-1][0]
    ramp = 7
    entry = {
        "config": name,
        **_env_info(),
        "dim": 100,
        "n_steps": 800,
        "iters": int(res.iter),
        "fg_calls": int(res.fg_calls),
        "J_T": round(float(res.J_T), 6),
        "optimizer": "auto",
    }
    if last_it > ramp and ramp in t_by_iter:
        dt = t_by_iter[last_it] - t_by_iter[ramp]
        entry["grape_iters_per_s"] = round(
            (last_it - ramp) / max(dt, 1e-9), 2
        )
    else:
        entry["grape_iters_per_s"] = None
    return entry


def _sharded_overhead_entry(name):
    """Sharded-vs-unsharded fg on a ONE-device mesh: same math, same
    device — the delta is the cost of SPMD partitioning + the inserted
    (trivial) collectives, on top of which a multi-device run adds the
    psum latency (payload: the L·N_T-float gradient + 3 J-parts)."""
    from grape_tpu.parallel import build_fg_sharded, make_mesh

    fg, cp = _build_cz(N_STEPS, dtype=np.complex64)
    x = cp.guess_pulsevals.reshape(-1)
    t_plain = _time_fg(fg, x, n_iter=10)
    mesh = make_mesh(1)
    fg_sh, cp_sh = build_fg_sharded(cp, mesh)
    t_sh = _time_fg(fg_sh, x, n_iter=10)
    dt_plain, dt_sh = t_plain["mean"], t_sh["mean"]
    grad_bytes = 4 * cp.n_controls * cp.n_timesteps  # f32 psum payload
    return {
        "config": name,
        **_env_info(),
        "dim": cp.dim,
        "n_steps": N_STEPS,
        "n_reps": t_plain["n_reps"],
        "ms_per_eval_unsharded": round(dt_plain * 1000, 2),
        "ms_std_unsharded": round(t_plain["std"] * 1000, 2),
        "ms_per_eval_sharded_1dev": round(dt_sh * 1000, 2),
        "ms_std_sharded_1dev": round(t_sh["std"] * 1000, 2),
        "spmd_overhead_ms": round((dt_sh - dt_plain) * 1000, 2),
        "spmd_overhead_frac": round(dt_sh / dt_plain - 1.0, 4),
        "psum_payload_bytes": grad_bytes,
    }


def _run_sweep_config(name, peak):
    """One sweep config's JSON entry."""
    if name == "cz_optimize_iters":
        return _optimize_iters_entry(name)
    if name == "cz_auto_iters":
        return _auto_iters_entry(name)
    if name in ("cz_device_loop_iters", "ens_cz_device_loop_iters"):
        return _device_loop_iters_entry(name)
    if name == "sharded_1dev_overhead":
        return _sharded_overhead_entry(name)
    for cfg_name, build, n_steps, k_traj in _sweep_configs():
        if cfg_name != name:
            continue
        fg_s, cp_s = build()
        x_s = cp_s.guess_pulsevals.reshape(-1)
        # the letter-scale flagship row costs tens of seconds per eval:
        # 2 reps, no pipelined pass, so it cannot starve the tail
        big = "ens1024samples" in cfg_name
        t_s = _time_fg(
            fg_s, x_s, n_iter=2 if big else 4, pipelined=not big
        )
        dt_s = t_s["mean"]
        dt_pipe = t_s.get("pipelined", dt_s)
        flops = _flops_analytic(cp_s)
        flops_xla = _flops_estimate(fg_s, x_s)
        entry = {
            "config": name,
            **_env_info(),
            "dim": cp_s.dim,
            "n_steps": n_steps,
            "n_reps": t_s["n_reps"],
            "ms_per_eval": round(dt_s * 1000, 2),
            "ms_std": round(t_s["std"] * 1000, 2),
            "ms_per_eval_pipelined": round(dt_pipe * 1000, 2),
            "traj_steps_per_s": round(n_steps * k_traj / dt_s, 1),
        }
        if "ensemble" in name or "ens" in name:
            entry["n_traj"] = k_traj
        if flops:
            entry["flops_per_eval"] = flops
            entry["flops_per_s"] = round(flops / dt_s, 1)
            entry["mfu_vs_fp32_peak"] = round(flops / dt_s / peak, 4)
            entry["mfu_vs_fp32_peak_pipelined"] = round(
                flops / dt_pipe / peak, 4
            )
        if flops_xla:
            entry["flops_xla"] = flops_xla
        return entry
    raise SystemExit(f"unknown sweep config {name}")


def _run_sweep(peak):
    """Run the sweep configs in this process (one process per device)
    under a wall-clock budget."""
    sweep = []
    t0 = time.perf_counter()
    for name, _build, _n, _k in _sweep_configs():
        if time.perf_counter() - t0 > SWEEP_BUDGET_S:
            sweep.append({"config": name, "skipped": "budget"})
            continue
        try:
            sweep.append(_run_sweep_config(name, peak))
        except Exception as exc:
            sweep.append({"config": name, "skipped": f"{exc}"[:120]})
    return sweep


def main():
    enable_compile_cache()
    platform = jax.devices()[0].platform
    peak = peak_flops(jax.devices()[0])

    # ---- headline: CZ dim=100 taylor fg ---------------------------------
    fg, cp = _build_cz(N_STEPS, dtype=np.complex64)
    x = cp.guess_pulsevals.reshape(-1)
    t_h = _time_fg(fg, x, n_iter=5, pipelined=True)
    dt_accel, dt_pipe = t_h["mean"], t_h["pipelined"]
    steps_per_s = N_STEPS * K_TRAJ / dt_accel
    headline_flops = _flops_analytic(cp) or _flops_estimate(fg, x)

    # ---- CPU float64 reference proxy (never kills the headline) ---------
    try:
        cpu = jax.devices("cpu")[0]
        n_cpu = 25
        jax.config.update("jax_enable_x64", True)  # true f64 on CPU
        with jax.default_device(cpu):
            fg_c, cp_c = _build_cz(n_cpu, dtype=np.complex128)
            dt_cpu = _time_fg(
                fg_c, cp_c.guess_pulsevals.reshape(-1), n_iter=2
            )["mean"]
        cpu_steps_per_s = n_cpu * K_TRAJ / dt_cpu
        vs_baseline = round(steps_per_s / cpu_steps_per_s, 2)
    except Exception:
        vs_baseline = None
    finally:
        # back to 32-bit defaults for the accelerator programs below
        jax.config.update("jax_enable_x64", False)

    # ---- second headline: the gradgen gradient method ------------------
    best = None
    try:
        fg_g, cp_g = _build_cz(
            N_STEPS, dtype=np.complex64, gradient_method="gradgen"
        )
        t_g = _time_fg(
            fg_g, cp_g.guess_pulsevals.reshape(-1), n_iter=5,
            pipelined=True,
        )
        dt_g, dt_g_pipe = t_g["mean"], t_g["pipelined"]
        flops_g = _flops_analytic(cp_g)
        best = {
            "method": "gradgen",
            "ms_per_eval": round(dt_g * 1000, 2),
            "ms_per_eval_pipelined": round(dt_g_pipe * 1000, 2),
            "traj_steps_per_s": round(N_STEPS * K_TRAJ / dt_g, 1),
        }
        if flops_g:
            best["mfu_vs_fp32_peak"] = round(flops_g / dt_g / peak, 4)
            best["mfu_vs_fp32_peak_pipelined"] = round(
                flops_g / dt_g_pipe / peak, 4
            )
    except Exception:
        pass

    # ---- dim sweep (in this process, wall-clock budget) -----------------
    sweep = _run_sweep(peak)

    out = {
        "metric": (
            "two-transmon CZ dim=100 fused fg (expm+taylor-grad) "
            f"propagation throughput on {platform}"
        ),
        "value": round(steps_per_s, 1),
        "unit": "traj-steps/s",
        "vs_baseline": vs_baseline,
        **_env_info(),
        "headline_n_reps": t_h["n_reps"],
        "headline_ms_std": round(t_h["std"] * 1000, 2),
        "sweep": sweep,
    }
    if best is not None:
        out["headline_best"] = best
    out["headline_ms_per_eval_pipelined"] = round(dt_pipe * 1000, 2)
    out["headline_traj_steps_per_s_pipelined"] = round(
        N_STEPS * K_TRAJ / dt_pipe, 1
    )
    if headline_flops:
        out["headline_mfu_vs_fp32_peak"] = round(
            headline_flops / dt_accel / peak, 4
        )
        out["headline_mfu_vs_fp32_peak_pipelined"] = round(
            headline_flops / dt_pipe / peak, 4
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
