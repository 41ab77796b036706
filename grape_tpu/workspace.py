"""GRAPE workspace.

Analog of ``GrapeWrk`` (``/root/reference/src/workspace.jl:78-362``), holding
the mutable host-side optimization state around the purely-functional jitted
device program: the flat pulse vector (layout ``pulsevals[l*N_T + n]``,
matching ``src/workspace.jl:158-162``), gradient buffers, bounds, evaluation
counters, the result object, and optimizer-introspection state (step width,
search direction) for callbacks.

Where the reference aliases ``@view``s of the pulse vector into its
propagators, here the pulse vector is simply the argument of the jitted
``fg``; mutation by the optimizer (or by a callback, cf.
``test/test_iterations.jl:128-145``) is honored because every evaluation
passes the current vector to the device program.
"""

import atexit
import weakref

import jax
import numpy as np

from .controls import discretize_on_midpoints
from .fg import build_f, build_fg, compile_problem, unpack_complex
from .result import GrapeResult

# Background envelope-prewarm threads still alive at interpreter exit.
# Joined from an atexit hook: if the interpreter tears down while a
# daemon thread is inside an XLA compile, C++ static destructors run
# under the thread's feet ("pure virtual method called" abort).
_LIVE_PREWARM_THREADS = weakref.WeakSet()


@atexit.register
def _join_prewarm_threads_at_exit():
    # Bounded join: the bound keeps a pathological compile from hanging
    # interpreter exit for minutes.  If the timeout expires the daemon
    # thread is abandoned mid-compile, which risks the C++-static-teardown
    # abort this join exists to prevent; 120 s covers every compile
    # observed on CPU.
    deadline = 120.0
    import time as _time

    t0 = _time.monotonic()
    for t in list(_LIVE_PREWARM_THREADS):
        remaining = deadline - (_time.monotonic() - t0)
        if remaining <= 0:
            break
        if t.is_alive():
            t.join(timeout=remaining)

__all__ = [
    "GrapeWrk", "step_width", "search_direction", "norm_search",
    "gradient", "pulse_update", "vec_angle",
]


class GrapeWrk:
    def __init__(self, trajectories, tlist, kwargs):
        self.kwargs = dict(kwargs)
        self.trajectories = list(trajectories)
        self.tlist = np.asarray(tlist, dtype=np.float64)
        from .fg_hetero import compile_heterogeneous, traj_prop_partition

        partition = traj_prop_partition(self.trajectories, self.kwargs)
        if partition is not None:
            # heterogeneous per-trajectory propagator settings: grouped
            # compile — one sub-problem per settings partition, global
            # functional/co-state assembly (reference initializes
            # propagators per trajectory, src/workspace.jl:216-233)
            self.cp = compile_heterogeneous(
                self.trajectories, tlist, partition, **self.kwargs
            )
        else:
            self.cp = compile_problem(trajectories, tlist, **self.kwargs)
        self.mesh = self.kwargs.get("mesh", None)
        if self.mesh is None and hasattr(self.cp, "H0") and (
            self.cp.H0.nbytes + self.cp.ops.nbytes
            > int(self.kwargs.get(
                "max_embedded_constant_bytes", 256 * 1024**2
            ))
        ):
            # big operator arrays: instead of embedding them as program
            # CONSTANTS (serialized into every program that uses them),
            # a 1-device mesh build passes them as device-resident
            # ARGUMENTS (the same machinery multi-device sharding uses)
            from .parallel import make_mesh

            self.mesh = make_mesh(1)
        if self.mesh is not None:
            # driver-level trajectory parallelism: the problem arrays are
            # sharded over the mesh ONCE; every (re-)built program then
            # runs SPMD with psum-reduced (J, grad) consumed by the
            # host-side optimizer — the reference parallelizes the whole
            # optimization loop the same way (@threadsif around both hot
            # loops, /root/reference/src/optimize.jl:720,876)
            from .parallel import shard_problem

            self.cp = shard_problem(self.cp, self.mesh)
        self.controls = self.cp.controls
        L, N_T = self.cp.n_controls, self.cp.n_timesteps
        self.n = L * N_T

        # bounds (flat, same l-major layout as pulsevals) — built before
        # the envelope bucketing, which uses them as per-control caps
        ub = float(self.kwargs.get("upper_bound", np.inf))
        lb = float(self.kwargs.get("lower_bound", -np.inf))
        self.upper_bounds = np.full(self.n, ub)
        self.lower_bounds = np.full(self.n, lb)
        pulse_options = self.kwargs.get("pulse_options", None)
        if pulse_options:
            for l, control in enumerate(self.controls):
                options = None
                for key, val in pulse_options.items():
                    if key is control:
                        options = val
                        break
                if options is None:
                    continue
                sl = slice(l * N_T, (l + 1) * N_T)
                if "upper_bounds" in options:
                    self.upper_bounds[sl] = np.asarray(
                        options["upper_bounds"], dtype=np.float64
                    )
                if "lower_bounds" in options:
                    self.lower_bounds[sl] = np.asarray(
                        options["lower_bounds"], dtype=np.float64
                    )

        self._amp_bucket = None
        self._program_cache = {}
        self._program_lock = None
        self._warm_thread = None
        self._warm_key = None
        self._prewarm_started = False
        # Pre-warm of the NEXT envelope bucket on a background thread:
        # unbounded problems otherwise pay the full compile cost in the
        # MIDDLE of the optimization when the optimizer first pushes a
        # pulse past the guess envelope.  Disabled for
        # mesh runs: multi-host SPMD requires every process to launch the
        # same programs in the same order, which a per-host background
        # thread would break.
        self._prewarm = bool(self.kwargs.get("prewarm_envelope", True))
        if self.mesh is not None:
            self._prewarm = False
        from .fg import uses_static_envelope

        if uses_static_envelope(self.cp):
            # Amplitude-envelope bucketing: Chebyshev coefficient tables
            # AND the vectorized backward passes' static order/squaring
            # counts are derived from the envelope.  Controls with FINITE box
            # bounds use the bound itself as the envelope (pulses can
            # never exceed it — zero re-jits); unbounded controls get a
            # power-of-two bucket and programs re-jit only when the
            # optimizer pushes a pulse beyond the current bucket (the
            # reference instead re-initializes its Cheby propagators with
            # control-range hints each evaluation,
            # src/optimize.jl:656-662,722).
            self._amp_bucket = self._bucket_for(
                np.max(np.abs(self.cp.guess_pulsevals), axis=1)
            )
        self.fg, self.f = self._programs()

        continue_from = self.kwargs.get("continue_from", None)
        if continue_from is not None:
            import logging
            logging.getLogger(__name__).info(
                "Continuing previous optimization"
            )
            result = continue_from
            if not isinstance(result, GrapeResult):
                result = GrapeResult.from_result(
                    result, self.trajectories, tlist, self.kwargs
                )
            result.iter_stop = int(self.kwargs.get("iter_stop", 5000))
            result.converged = False
            import datetime
            result.start_local_time = datetime.datetime.now()
            result.message = "in progress"
            self.pulsevals = np.concatenate(
                [
                    discretize_on_midpoints(c, result.tlist)
                    for c in result.optimized_controls
                ]
            )
            self.result = result
        else:
            self.result = GrapeResult(self.trajectories, tlist, self.kwargs)
            self.pulsevals = self.cp.guess_pulsevals.reshape(-1).copy()

        self.pulsevals_guess = self.pulsevals.copy()
        self.gradient = np.zeros(self.n)
        self.grad_J_Tb = np.zeros(self.n)
        self.grad_J_a = np.zeros(self.n)
        self.J_parts = np.zeros(3)
        self.tau_vals = np.zeros(self.cp.n_traj, dtype=np.complex128)
        self.states = None  # (K, d) final states of latest evaluation
        self.fg_count = np.zeros(2, dtype=np.int64)  # [fg_calls, f_calls]

        # optimizer-introspection state (filled by the backend)
        self.optimizer = self.kwargs.get("optimizer", None)
        self.optimizer_state = None
        self.alpha = 0.0            # last line-search step width
        self.searchdirection = np.zeros(self.n)
        self.gradient_guess = np.zeros(self.n)  # gradient at start of iter


    # -- Chebyshev amplitude-envelope bucketing ----------------------------

    def _bucket_for(self, amps):
        """Per-control amplitude envelope.

        Controls with a finite box bound in the VICINITY of the current
        amplitudes (within 16× of the natural power-of-two bucket) use
        the bound itself: the L-BFGS-B iterates can never exceed it, so
        those controls never trigger a mid-run re-jit, and the envelope
        is exact.  Loose sanity bounds far above the real amplitudes are
        NOT used (they would over-size the static Taylor orders /
        Chebyshev tables or disable the vectorized backward outright);
        those controls grow power-of-two buckets like unbounded ones.
        Amplitudes beyond the bound (optax line-search probes, callback
        mutation) also fall back to the growing bucket — correctness
        never depends on the iterates respecting the bounds."""
        amps = np.maximum(np.asarray(amps, dtype=np.float64), 0.05)
        L, N_T = self.cp.n_controls, self.cp.n_timesteps
        cap = np.maximum(
            np.abs(self.upper_bounds.reshape(L, N_T)).max(axis=1),
            np.abs(self.lower_bounds.reshape(L, N_T)).max(axis=1),
        )  # (L,) per-control bound envelope; inf where unbounded
        grown = np.exp2(np.ceil(np.log2(2.0 * amps)))
        use_cap = (
            np.isfinite(cap) & (amps <= cap) & (cap <= 16.0 * grown)
        )
        self._bucket_capped = use_cap  # capped controls never re-jit
        return tuple(np.where(use_cap, cap, grown))

    def _next_bucket_key(self):
        """The bucket `_ensure_envelope` would grow into on the next
        marginal overflow (bound-capped controls stay at their cap)."""
        if self._amp_bucket is None:
            return None
        b = np.asarray(self._amp_bucket, dtype=np.float64)
        capped = getattr(self, "_bucket_capped", np.zeros(len(b), bool))
        if np.all(capped):
            return None  # fully bound-derived: zero re-jits possible
        amps = np.where(capped, b, np.nextafter(b, np.inf))
        key = self._bucket_for(np.maximum(amps, b))
        self._bucket_capped = capped  # restore the CURRENT bucket's mask
        return key

    def _start_prewarm(self):
        """Build AND execute the next bucket's programs, so a mid-run
        envelope growth swaps to an already-warm program instead of
        paying compile + the first-execution cost.  A daemon thread warms
        in the background."""
        if not self._prewarm or self._amp_bucket is None:
            return
        key = self._next_bucket_key()
        if key is None or key == self._amp_bucket:
            return
        if key in self._program_cache or key == self._warm_key:
            return
        if self._warm_thread is not None and self._warm_thread.is_alive():
            # a warm for another bucket is still compiling: don't stack a
            # second background compile (the next growth re-triggers)
            return
        import threading

        if self._program_lock is None:
            self._program_lock = threading.Lock()
        self._warm_key = key
        x0 = np.asarray(self.pulsevals, dtype=np.float64).copy()

        def warm():
            try:
                fg, f = self._build_programs(key)
                # execute once: pays device compile AND the first
                # execution off the critical path (any pulse values
                # work — program shapes are envelope-independent)
                float(fg(x0)[0])
                float(f(x0)[0])
                with self._program_lock:
                    self._program_cache[key] = (fg, f)
            except Exception:  # never kill the optimization from here
                pass
            finally:
                # clear only OUR key: a newer warm may have replaced it
                if self._warm_key == key:
                    self._warm_key = None

        self._warm_thread = threading.Thread(
            target=warm, name="grape-envelope-prewarm", daemon=True
        )
        _LIVE_PREWARM_THREADS.add(self._warm_thread)
        self._warm_thread.start()

    def _join_prewarm(self, key=None):
        """Wait for an in-flight pre-warm (of `key`, or any) to finish."""
        t = self._warm_thread
        if t is not None and t.is_alive() and (
            key is None or key == self._warm_key
        ):
            t.join()

    def _build_programs(self, key):
        """Build (fg, f) for an envelope bucket `key` (no cache I/O)."""
        amp_max = np.asarray(key) if key is not None else None
        calls = int(self.kwargs.get("eval_device_calls", 1))
        if calls > 1:
            # split one fg evaluation across multiple device executions,
            # bounding the length of each
            from .fg import build_fg_multicall

            fg = build_fg_multicall(
                self.cp, amp_max=amp_max, n_calls=calls
            )
            if self.mesh is not None:
                from .parallel import build_f_sharded

                f, _ = build_f_sharded(
                    self.cp, self.mesh, amp_max=amp_max, presharded=True
                )
            else:
                f = build_f(self.cp, amp_max=amp_max)
            return fg, f
        if self.mesh is not None:
            from .parallel import build_f_sharded, build_fg_sharded

            fg, _ = build_fg_sharded(
                self.cp, self.mesh, amp_max=amp_max, presharded=True
            )
            f, _ = build_f_sharded(
                self.cp, self.mesh, amp_max=amp_max, presharded=True
            )
            return fg, f
        return (
            build_fg(self.cp, amp_max=amp_max),
            build_f(self.cp, amp_max=amp_max),
        )

    def _programs(self):
        key = self._amp_bucket
        if key not in self._program_cache:
            # a background pre-warm may already be building this bucket:
            # wait for it instead of compiling the same program twice
            self._join_prewarm(key)
            if key not in self._program_cache:
                self._program_cache[key] = self._build_programs(key)
        return self._program_cache[key]

    def _ensure_envelope(self, x):
        """Grow the Chebyshev bucket if the pulse exceeds it."""
        if self._amp_bucket is None:
            return
        N_T = self.cp.n_timesteps
        amps = np.max(
            np.abs(np.reshape(np.asarray(x), (-1, N_T))), axis=1
        )
        if np.any(amps > np.asarray(self._amp_bucket)):
            # prefer an already-(pre)warmed bucket that covers the new
            # amplitudes: an envelope over-estimate is mathematically
            # exact, and the swap is free — without this, an optimizer
            # step overshooting the predicted next bucket would pay a
            # fresh compile despite the warm program in the cache.
            # CACHED programs beat an in-flight warm even when the warm's
            # bucket is tighter: swapping to the cached one is free,
            # while the in-flight one would block on the remaining
            # compile + first-execution cost.
            def covering(keys):
                return [
                    k for k in keys
                    if k is not None and np.all(amps <= np.asarray(k))
                ]

            warmed = covering(list(self._program_cache)) or covering(
                [self._warm_key]
            )
            if warmed:
                self._amp_bucket = min(warmed, key=lambda k: max(k))
            else:
                self._amp_bucket = self._bucket_for(
                    np.maximum(amps, np.asarray(self._amp_bucket))
                )
            self.fg, self.f = self._programs()
            # keep one bucket of headroom warm for the next growth
            self._start_prewarm()

    # -- device evaluation entry points ------------------------------------

    def evaluate_functional(self, x, count_call=True):
        self._ensure_envelope(x)
        # ONE device->host fetch of the whole output tree, instead of a
        # synchronizing transfer per item
        J, aux = jax.device_get(self.f(np.asarray(x, dtype=np.float64)))
        if count_call:
            self.fg_count[1] += 1
            self.result.f_calls += 1
        self.J_parts[:] = np.asarray(aux["J_parts"], dtype=np.float64)
        self.tau_vals[:] = unpack_complex(aux["tau"])
        self.states = unpack_complex(aux["psi_T"])
        self._dispatch_fw_prop_callback(aux)
        if not self._prewarm_started:
            # start warming the next envelope bucket AFTER the first
            # foreground evaluation (no contention with its warmup)
            self._prewarm_started = True
            self._start_prewarm()
        return float(J)

    def _dispatch_fw_prop_callback(self, aux):
        """Post-hoc per-step observables callback: the reference invokes
        the ``fw_prop_`` callback after every forward ``prop_step!``
        (``src/optimize.jl:733-737``); here the jitted program evaluates
        the observables over the whole stored trajectory and the callback
        receives all per-step values once per evaluation (documented
        deviation; identical information).  Signature:
        ``fw_prop_callback(values, tlist)`` with ``values`` a tuple of
        complex ``(N_T+1, ...)`` arrays (the states themselves when no
        ``fw_prop_observables`` were given)."""
        if self.cp.fw_prop_callback is None:
            return
        values = tuple(
            unpack_complex(v) for v in aux["fw_observables"]
        )
        self.cp.fw_prop_callback(values, self.tlist)

    def evaluate_gradient(self, x, G_out=None):
        self._ensure_envelope(x)
        # single overlapped device->host fetch (see evaluate_functional)
        J, G, aux = jax.device_get(
            self.fg(np.asarray(x, dtype=np.float64))
        )
        if not bool(aux.get("taylor_ok", True)) and self._amp_bucket:
            # safety net: the static Taylor order was sized from the
            # amplitude envelope; if the honest last-term check still
            # fails (envelope bound too loose for this problem), grow
            # the bucket once — more orders — before giving up
            self._amp_bucket = self._bucket_for(
                2.0 * np.asarray(self._amp_bucket)
            )
            self.fg, self.f = self._programs()
            J, G, aux = jax.device_get(
                self.fg(np.asarray(x, dtype=np.float64))
            )
        self.fg_count[0] += 1
        self.result.fg_calls += 1
        self.J_parts[:] = np.asarray(aux["J_parts"], dtype=np.float64)
        self.tau_vals[:] = unpack_complex(aux["tau"])
        self.states = unpack_complex(aux["psi_T"])
        if not bool(aux.get("taylor_ok", True)):
            raise RuntimeError(
                "Taylor gradient series did not converge within "
                f"max_order={self.cp.taylor_grad_max_order} terms "
                f"(tolerance={self.cp.taylor_grad_tolerance}); decrease the "
                "time step or increase taylor_grad_max_order"
            )
        if not bool(aux["chi_ok"]):
            raise RuntimeError(
                f"The norm of a state χ(T) is below chi_min_norm="
                f"{self.cp.chi_min_norm}: the gradient is zero"
            )
        G = np.asarray(G, dtype=np.float64)
        if G_out is not None:
            G_out[:] = G
        self.gradient[:] = G
        self.grad_J_Tb[:] = np.asarray(aux["grad_J_Tb"], dtype=np.float64)
        self.grad_J_a[:] = np.asarray(aux["grad_J_a"], dtype=np.float64)
        self._dispatch_fw_prop_callback(aux)
        if not self._prewarm_started:
            self._prewarm_started = True
            self._start_prewarm()
        return float(J), G


# --------------------------------------------------------------------------
# Introspection helpers (``src/workspace.jl:378-511``): callback-safe access
# to optimizer internals.
# --------------------------------------------------------------------------

def step_width(wrk):
    """Line-search step width α of the current iteration
    (``dsave[14]`` analog, ``ext/GRAPELBFGSBExt.jl:205-213``)."""
    return float(wrk.alpha)


def search_direction(wrk):
    """Search direction used in the current iteration (falls back to ``-∇J``
    before the first iteration, ``src/workspace.jl:411``)."""
    s = np.asarray(wrk.searchdirection)
    if not np.any(s):
        return -np.asarray(wrk.gradient)
    return s


def norm_search(wrk):
    return float(np.linalg.norm(search_direction(wrk)))


def gradient(wrk, which="initial"):
    """Gradient associated with the current iteration.

    ``which="initial"``: gradient at the iterate from which the current
    iteration started (what determined the search direction);
    ``which="final"``: gradient at the optimized point of the iteration
    (``src/workspace.jl:449-460``)."""
    if which == "final":
        return np.asarray(wrk.gradient)
    g = np.asarray(wrk.gradient_guess)
    if not np.any(g):
        return np.asarray(wrk.gradient)
    return g


def pulse_update(wrk):
    """``pulsevals - pulsevals_guess`` for the current iteration
    (``src/workspace.jl:474``)."""
    return np.asarray(wrk.pulsevals) - np.asarray(wrk.pulsevals_guess)


def vec_angle(v1, v2, unit="rad"):
    """Angle between two vectors, numerically robust 2·atan form
    (``src/workspace.jl:486-510``)."""
    v1 = np.asarray(v1, dtype=np.float64)
    v2 = np.asarray(v2, dtype=np.float64)
    n1 = np.linalg.norm(v1)
    n2 = np.linalg.norm(v2)
    if n1 == 0 or n2 == 0:
        return 0.0
    u1 = v1 / n1
    u2 = v2 / n2
    angle = 2 * np.arctan2(
        np.linalg.norm(u1 - u2), np.linalg.norm(u1 + u2)
    )
    if unit == "degree":
        return float(np.degrees(angle))
    return float(angle)
