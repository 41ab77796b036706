"""GRAPE optimization driver.

Analog of the reference driver (``/root/reference/src/optimize.jl:63-228``):
entry points, the ``fg`` closure over the workspace, optimizer-backend
dispatch, the convergence-check protocol, per-iteration result updates, and
result finalization.  The host-side optimizer consumes function/gradient
values from the single jitted device program.
"""

import datetime
import traceback

import numpy as np

from .controls import discretize
from .result import GrapeResult
from .workspace import GrapeWrk

__all__ = ["optimize", "optimize_problem", "run_optimizer"]


def optimize_problem(problem, method="grape", **updates):
    """Optimize a :class:`~grape_tpu.trajectory.ControlProblem`
    (``QuantumControl.optimize(problem; method=GRAPE)`` analog;
    ``method="krotov"`` dispatches to :func:`grape_tpu.optimize_krotov`
    — the framework-level method selection of the reference ecosystem,
    ``/root/reference/src/optimize.jl:63-68``)."""
    kwargs = dict(problem.kwargs)
    kwargs.update(updates)
    method_l = str(method).lower()
    if method_l == "krotov":
        from .krotov import optimize_krotov

        return optimize_krotov(problem.trajectories, problem.tlist,
                               **kwargs)
    if method_l != "grape":
        raise ValueError(
            f"Unknown optimization method {method!r} "
            "(supported: 'grape', 'krotov')"
        )
    return optimize(problem.trajectories, problem.tlist, **kwargs)


def optimize(trajectories, tlist, **kwargs):
    """Run a GRAPE optimization; returns a :class:`GrapeResult`.

    Keyword-argument contract mirrors ``/root/reference/src/docstring.jl``:
    required ``J_T``; optional ``chi``, ``chi_min_norm``, ``J_a``,
    ``grad_J_a``, ``lambda_a``, ``g_b``, ``xi``, ``lambda_b``,
    ``gradient_method`` ("gradgen"/"taylor"/"auto": gradgen where the
    vectorized rank-1 Fréchet path serves, else taylor),
    ``taylor_grad_max_order``,
    ``taylor_grad_tolerance``, ``taylor_grad_check_convergence``,
    ``upper_bound``/``lower_bound``/``pulse_options``, ``callback``,
    ``check_convergence``, ``iter_start``/``iter_stop``, ``continue_from``,
    ``verbose``, ``rethrow_exceptions``, ``print_iters``/``print_iter_info``/
    ``store_iter_info``, optimizer tuning (``lbfgsb_m``, ``lbfgsb_factr``,
    ``lbfgsb_pgtol``, ``lbfgsb_iprint``) and ``optimizer`` backend selection.

    ``fw_prop_callback`` (with optional ``fw_prop_observables``, a list of
    functions ``(Psi (K, d), tlist, n) -> array``) receives per-time-step
    observable values over the stored forward states after every
    evaluation: ``fw_prop_callback(values, tlist)`` with ``values`` a tuple
    of complex ``(N_T+1, ...)`` arrays (the states themselves if no
    observables are given).  Deviation from the reference (which invokes
    the callback inside the propagation loop after each ``prop_step!``,
    ``src/optimize.jl:733-737``): under jit the forward pass is one fused
    scan, so the callback fires once per evaluation with all per-step
    values — identical information, different cadence.

    ``mesh`` (a ``jax.sharding.Mesh``, e.g. from ``parallel.make_mesh`` or
    ``parallel.make_host_chip_mesh``) shards the trajectory axis over the
    mesh devices: the whole optimization loop then runs SPMD with the
    ``Σ_k`` reductions lowered to ``psum`` collectives and the host-side
    optimizer consuming the fully reduced gradient — the multi-chip analog
    of the reference's ``use_threads`` trajectory parallelism
    (``/root/reference/src/optimize.jl:720,876``).  The number of
    trajectories must be divisible by the mesh size.
    """
    if "update_hook" in kwargs or "info_hook" in kwargs:
        raise ValueError(
            "The `update_hook` and `info_hook` arguments have been "
            "superseded by the `callback` argument"
        )
    callback = _wrap_callback(kwargs)
    check_convergence = kwargs.get("check_convergence", lambda res: res)

    if kwargs.get("check", True):
        from .interfaces import check_problem

        check_problem(trajectories, tlist)

    wrk = GrapeWrk(trajectories, tlist, kwargs)

    if wrk.cp.J_a is None and "grad_J_a" in kwargs:
        import warnings
        warnings.warn("Argument `grad_J_a` was given without `J_a`. Ignoring")

    def fg(F, G, x):
        """Reference ``fg!`` closure (``src/optimize.jl:105-111``)."""
        if G is None:
            return wrk.evaluate_functional(x)
        J, _ = wrk.evaluate_gradient(x, G_out=G)
        return J

    optimizer = _get_optimizer(wrk)
    atexit_filename = kwargs.get("atexit_filename", None)
    atexit_hook = None
    if atexit_filename is not None:
        import atexit
        from .io import save_result

        def _crash_save():
            # crash dump: tagged `interrupted` (+ the producing config's
            # digest when known) so optimize_or_load resumes/re-runs
            # instead of returning the partial result as final
            save_result(
                wrk.result, atexit_filename,
                config_digest=kwargs.get("atexit_config_digest", None),
                interrupted=True,
            )

        atexit.register(_crash_save)
        atexit_hook = _crash_save

    profile_dir = kwargs.get("profile_dir", None)
    profile_ctx = None
    if profile_dir is not None:
        # device-level tracing/profiling (the reference's observability is
        # per-iteration `secs` + FG counters, src/optimize.jl:213-215; here
        # we add full jax.profiler traces of the optimization loop)
        import jax.profiler

        profile_ctx = jax.profiler.trace(profile_dir)
        profile_ctx.__enter__()
    try:
        run_optimizer(optimizer, wrk, fg, callback, check_convergence)
    except KeyboardInterrupt:
        wrk.result.message = "Exception: InterruptException"
    except Exception as exc:
        if kwargs.get("rethrow_exceptions", False):
            raise
        wrk.result.message = f"Exception: {exc}"
        if kwargs.get("verbose", False):
            traceback.print_exc()
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)

    finalize_result(wrk)
    if atexit_hook is not None:
        import atexit
        atexit.unregister(atexit_hook)
    return wrk.result


def _wrap_callback(kwargs):
    """Combine user callback(s) and iteration printing into one callable
    (the reference's L5 wrapper, ``src/optimize.jl:42-57``)."""
    from .info_table import make_grape_print_iters

    cbs = []
    user_cb = kwargs.get("callback", None)
    if user_cb is not None:
        if isinstance(user_cb, (tuple, list)):
            cbs.extend(user_cb)
        else:
            cbs.append(user_cb)
    print_iters = kwargs.get("print_iters", True)
    print_iter_info = kwargs.get("print_iter_info", None)
    store_iter_info = kwargs.get("store_iter_info", None)
    if print_iters or store_iter_info is not None:
        cbs.append(
            make_grape_print_iters(
                print_iter_info=print_iter_info,
                store_iter_info=store_iter_info,
                print_iters=print_iters,
                g_b=kwargs.get("g_b", None),
            )
        )

    def combined(wrk, iteration):
        records = ()
        for cb in cbs:
            res = cb(wrk, iteration)
            if res is not None and res != ():
                if not isinstance(res, tuple):
                    res = (res,)
                records = records + res
        return records if records else None

    return combined


def _get_optimizer(wrk):
    """Default optimizer: ``"auto"`` selects the native C++ L-BFGS-B
    reverse-communication backend on every platform (exact reference
    semantics, ``ext/GRAPELBFGSBExt.jl:70-143``; one host round trip per
    function/gradient evaluation).  ``optimizer="device-lbfgs"`` selects
    the device-resident chunked L-BFGS loop, and ``"scipy-lbfgsb"`` a
    scipy-based backend (pluggable-backend parity with the reference's
    Optim.jl extension)."""
    opt = wrk.kwargs.get("optimizer", None)
    explicit = opt is not None
    if opt is None or opt == "auto":
        opt = "lbfgsb"
        explicit = False
    if opt == "lbfgsb":
        try:
            from .optimizers.lbfgsb import LBFGSB
            return LBFGSB(
                m=int(wrk.kwargs.get("lbfgsb_m", 10)),
                factr=float(wrk.kwargs.get("lbfgsb_factr", 1e1)),
                pgtol=float(wrk.kwargs.get("lbfgsb_pgtol", 1e-15)),
                iprint=int(wrk.kwargs.get("lbfgsb_iprint", -1)),
            )
        except Exception:
            if explicit:
                raise
            from .optimizers.scipy_backend import ScipyLBFGSB
            return ScipyLBFGSB(wrk.kwargs)
    if opt == "scipy-lbfgsb":
        from .optimizers.scipy_backend import ScipyLBFGSB
        return ScipyLBFGSB(wrk.kwargs)
    if opt == "device-lbfgs":
        # device-resident chunked loop: one host sync per chunk_iters
        # iterations (amortizes the per-call host<->device latency)
        from .optimizers.device_loop import DeviceLoopBackend
        return DeviceLoopBackend(
            chunk_iters=int(wrk.kwargs.get("device_loop_iters", 10)),
        )
    if type(opt).__module__.startswith("optax") or (
        hasattr(opt, "init") and hasattr(opt, "update")
        and not hasattr(opt, "run")
    ):
        from .optimizers.optax_backend import OptaxBackend
        return OptaxBackend(opt)
    return opt  # custom backend object with .run()


def run_optimizer(optimizer, wrk, fg, callback, check_convergence):
    """Dispatch to the optimizer backend (``src/optimize.jl:147-151``)."""
    if hasattr(optimizer, "run"):
        return optimizer.run(wrk, fg, callback, check_convergence)
    raise ValueError(f"Unknown optimizer: {optimizer!r}")


def apply_convergence_check(result, check_convergence):
    """Convergence-check protocol (``src/optimize.jl:154-182``): the check
    may return a bool, a reason string (empty = not converged), ``None``, or
    the (possibly mutated) result object."""
    if result.converged:
        return
    converged = check_convergence(result)
    if isinstance(converged, (bool, np.bool_)):
        result.converged = bool(converged)
        if converged:
            result.message = "Convergence check returned true"
    elif isinstance(converged, str):
        if converged:
            result.converged = True
            result.message = converged
    elif converged is None or converged is result:
        pass
    else:
        import warnings
        warnings.warn(
            "The check_convergence function did not return a Boolean, "
            "String, None, or modified GrapeResult object"
        )


def update_result(wrk, i):
    """Per-iteration result update (``src/optimize.jl:185-216``)."""
    res = wrk.result
    if wrk.states is not None:
        res.states = [np.asarray(s) for s in wrk.states]
    res.tau_vals = np.asarray(wrk.tau_vals).copy()
    res.J_T_prev = res.J_T
    res.J_T = wrk.J_parts[0]
    res.J_a_prev = res.J_a
    res.J_a = wrk.J_parts[1]
    if res.J_a > 0.0:
        lambda_a = wrk.kwargs.get("lambda_a", 1.0)
        res.J_a /= lambda_a
    res.J_b_prev = res.J_b
    lambda_b = wrk.kwargs.get("lambda_b", 1.0)
    g_b = wrk.kwargs.get("g_b", None)
    if not (lambda_b == 0 and g_b is None):
        res.J_b = wrk.J_parts[2] / lambda_b if lambda_b != 0 else 0.0
    else:
        res.J_b = 0.0
    if i > 0:
        res.iter = i
    if i >= res.iter_stop:
        res.converged = True
        res.message = "Reached maximum number of iterations"
    prev_time = res.end_local_time
    res.end_local_time = datetime.datetime.now()
    res.secs = (res.end_local_time - prev_time).total_seconds()


def finalize_result(wrk):
    """Discretize final midpoint pulses back onto the time-grid points
    (``src/optimize.jl:219-228``)."""
    res = wrk.result
    res.end_local_time = datetime.datetime.now()
    N_T = len(res.tlist) - 1
    res.optimized_controls = [
        discretize(wrk.pulsevals[l * N_T:(l + 1) * N_T], res.tlist)
        for l in range(len(wrk.controls))
    ]
