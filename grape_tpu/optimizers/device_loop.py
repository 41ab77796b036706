"""Device-resident optimization loop.

The reverse-communication backends pay one host↔device round trip per
function/gradient evaluation.  For small/medium problems that round trip
can rival the device compute per evaluation.

This backend runs CHUNKS of optimizer iterations entirely on device: one
jitted ``lax.scan`` over ``chunk_iters`` iterations of the NATIVE traced
L-BFGS + Moré–Thuente strong-Wolfe line search by default
(``optimizers/jax_lbfgs.py`` — ~1 fg evaluation/iteration; any optax
``GradientTransformation`` is still accepted via ``transformation=``)
with the fg program inlined, returning the per-iteration trace (J,
J_parts, tau, ψ_T, step widths, updates).  The host syncs ONCE per
chunk, then replays the trace through the normal per-iteration protocol
— ``update_result``, callbacks, the info table, convergence checks — so
the user-visible behavior matches the reference's per-iteration
contract.  Deviations (documented):

- iterations inside a chunk cannot be interrupted by convergence: the
  check runs at replay time and surplus iterations are discarded (the
  returned result is AT the convergence iteration; the discarded device
  work is the price of batching);
- a callback that mutates ``wrk.pulsevals`` takes effect at the next
  CHUNK boundary, not the next iteration (set ``chunk_iters=1`` to
  recover exact per-iteration mutation semantics);
- per-iteration ``secs`` is the chunk wall time divided evenly;
- FG(F) counters use the line-search evaluation counts from the chunk
  trace (the native search's nfev, or the optax state's step count).

Box bounds are honored by projection after each update (as in the optax
backend).  Under ``mesh=...`` the chunk program is built with explicit
shardings (pulse vector / optimizer state replicated, problem arrays
sharded along the trajectory axis as placed by ``shard_problem``) — the
sweet spot of this backend: a sharded ensemble pays ONE host sync per
chunk instead of one per line-search probe, and the psum-reduced
gradient feeds the on-device L-BFGS update directly.
"""

import numpy as np

__all__ = ["DeviceLoopBackend"]


class DeviceLoopBackend:
    def __init__(self, transformation=None, chunk_iters=10,
                 project_bounds=True, m=10, maxls=20,
                 chunk_schedule="fixed"):
        # default: the native traced L-BFGS + Moré-Thuente line search
        # (optimizers/jax_lbfgs.py) — ~1 fg evaluation/iteration where
        # optax.lbfgs's zoom spends ~2.1.  Any optax
        # GradientTransformation is still accepted.
        self.native = transformation is None or transformation == "native"
        if self.native:
            self.tx = None
        else:
            import optax

            self.tx = optax.with_extra_args_support(transformation)
        self.chunk_iters = int(chunk_iters)
        self.project_bounds = project_bounds
        self.m = int(m)
        self.maxls = int(maxls)
        # "auto": grow the chunk 1 -> 2 -> 4 ... -> chunk_iters, doubling
        # after each chunk that replays cleanly, and drop back to 1 when
        # a chunk is cut short by callback pulse mutation or an envelope
        # growth (per-iteration semantics while the run is "eventful",
        # full amortization once it is smooth —
        # surplus-iteration discard at convergence is bounded by the
        # growth schedule).  "fixed": always chunk_iters (round-4
        # behavior).
        if chunk_schedule not in ("fixed", "auto"):
            raise ValueError(
                f"chunk_schedule must be 'fixed' or 'auto', got "
                f"{chunk_schedule!r}"
            )
        self.chunk_schedule = chunk_schedule

    def _init_state(self, x):
        import jax.numpy as jnp

        x = jnp.asarray(x)
        if self.native:
            from .jax_lbfgs import lbfgs_init_state

            return lbfgs_init_state(x, self.m)
        return self.tx.init(x)

    # -- chunk program ------------------------------------------------------

    def _make_chunk(self, wrk, n_iters=None):
        import jax
        import jax.numpy as jnp
        from jax import lax

        tx = self.tx
        if n_iters is None:
            n_iters = self.chunk_iters

        if wrk.mesh is not None:
            # sharded chunk: rebuild fg/f inside the traced program with
            # the problem arrays as sharded ARGUMENTS (the same pattern
            # as parallel.mesh._build_sharded: the arrays stay sharded
            # device buffers instead of program constants)
            import dataclasses

            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..fg import _warm_env_cache, build_f, build_fg
            from ..parallel.mesh import _DEVICE_ARRAY_FIELDS

            cp = wrk.cp
            key = wrk._amp_bucket
            amp_max = np.asarray(key) if key is not None else None
            _warm_env_cache(cp, amp_max)
            dev = {k: getattr(cp, k) for k in _DEVICE_ARRAY_FIELDS}
            repl = NamedSharding(wrk.mesh, P())

            def fg_j(p, arrs):
                cp_t = dataclasses.replace(cp, **arrs)
                return build_fg(cp_t, amp_max=amp_max)(p)

            def f_j(p, arrs):
                cp_t = dataclasses.replace(cp, **arrs)
                return build_f(cp_t, amp_max=amp_max)(p)

            jit_kwargs = dict(
                in_shardings=(
                    repl, repl, repl, repl,
                    {k: v.sharding for k, v in dev.items()},
                ),
                out_shardings=repl,
            )
        else:
            fg_w, f_w = wrk.fg, wrk.f  # jitted programs compose under jit

            def fg_j(p, arrs):
                return fg_w(p)

            def f_j(p, arrs):
                return f_w(p)

            dev = None
            jit_kwargs = {}

        has_bounds = np.any(np.isfinite(wrk.lower_bounds)) or np.any(
            np.isfinite(wrk.upper_bounds)
        )
        lo = jnp.asarray(wrk.lower_bounds)
        hi = jnp.asarray(wrk.upper_bounds)
        project = has_bounds and self.project_bounds

        if self.native:
            from .jax_lbfgs import make_lbfgs_iter

            n_pulse = int(np.asarray(wrk.pulsevals).shape[0])

            def chunk_fn(x, opt_state, J, g, arrs):
                def fg_flat(p):
                    # the L-BFGS carry keeps the iterate's dtype (float64
                    # under x64) even for a complex64 problem
                    J_p, g_p, aux_p = fg_j(p, arrs)
                    return J_p.astype(p.dtype), g_p.astype(p.dtype), aux_p

                _init, lstep = make_lbfgs_iter(
                    fg_flat, n=n_pulse, m=self.m,
                    lower=lo if project else None,
                    upper=hi if project else None,
                    maxls=self.maxls,
                )
                aux_sd = jax.eval_shape(fg_flat, x)[2]
                aux0 = jax.tree_util.tree_map(
                    lambda sd: jnp.zeros(sd.shape, sd.dtype), aux_sd
                )

                def body(carry, _):
                    x, st, J, g, aux = carry
                    x2, st2, J2, g2, aux2, alpha, nfev = lstep(
                        x, st, J, g, aux
                    )
                    out = {
                        "x": x2,
                        "J": J2,
                        "g": g2,
                        "update": x2 - x,
                        "J_parts": aux2["J_parts"],
                        "tau": aux2["tau"],
                        "psi_T": aux2["psi_T"],
                        "chi_ok": aux2["chi_ok"],
                        "taylor_ok": aux2.get(
                            "taylor_ok", jnp.asarray(True)
                        ),
                        "alpha": alpha.astype(jnp.float32),
                        # extra fg evals beyond the accepted one (the
                        # replay counts 1 + ls_steps per iteration)
                        "ls_steps": jnp.maximum(
                            nfev - 1, 0
                        ).astype(jnp.int32),
                    }
                    return (x2, st2, J2, g2, aux2), out

                (x_f, st_f, J_f, g_f, _aux), trace = lax.scan(
                    body, (x, opt_state, J, g, aux0), None,
                    length=n_iters,
                )
                return (x_f, st_f, J_f, g_f), trace

            chunk = jax.jit(chunk_fn, **jit_kwargs)

            def call(x, opt_state, J, g):
                return chunk(x, opt_state, J, g, dev)

            return call

        from .optax_backend import make_exact_value_fn, tree_get_optax

        _ls_info = tree_get_optax

        def chunk_fn(x, opt_state, J, g, arrs):
            # built inside the trace so the line-search value/grad
            # closures see the (possibly sharded, traced) problem arrays
            value_fn = make_exact_value_fn(
                lambda p: f_j(p, arrs)[0], lambda p: fg_j(p, arrs)
            )

            def body(carry, _):
                x, st, J, g = carry
                updates, st = tx.update(
                    g, st, x, value=J, grad=g, value_fn=value_fn
                )
                x2 = x + updates
                if project:
                    x2 = jnp.clip(x2, lo, hi)
                J2, g2, aux = fg_j(x2, arrs)
                out = {
                    "x": x2,
                    "J": J2,
                    "g": g2,
                    "update": x2 - x,
                    "J_parts": aux["J_parts"],
                    "tau": aux["tau"],
                    "psi_T": aux["psi_T"],
                    "chi_ok": aux["chi_ok"],
                    "taylor_ok": aux.get("taylor_ok", jnp.asarray(True)),
                    "alpha": jnp.asarray(
                        _ls_info(st, "learning_rate", 1.0),
                        dtype=jnp.float32,
                    ),
                    "ls_steps": jnp.asarray(
                        _ls_info(st, "num_linesearch_steps", 0),
                        dtype=jnp.int32,
                    ),
                }
                return (x2, st, J2, g2), out

            carry, trace = lax.scan(
                body, (x, opt_state, J, g), None, length=n_iters
            )
            return carry, trace

        chunk = jax.jit(chunk_fn, **jit_kwargs)

        def call(x, opt_state, J, g):
            return chunk(x, opt_state, J, g, dev)

        return call

    # -- driver loop --------------------------------------------------------

    def run(self, wrk, fg, callback, check_convergence):
        import jax
        import jax.numpy as jnp

        from ..fg import unpack_complex
        from ..optimize import apply_convergence_check, update_result

        x = np.asarray(wrk.pulsevals, dtype=np.float64)
        wrk.pulsevals = x
        g = np.zeros_like(x)

        # iteration 0 through the standard path (counts, callback, table)
        J = fg(0.0, g, x)
        wrk.gradient_guess[:] = g
        update_result(wrk, 0)
        rec = callback(wrk, 0)
        wrk.fg_count[:] = 0
        if rec:
            wrk.result.records.append(rec)

        opt_state = self._init_state(x)
        chunk_cache = {}
        import time as _time

        cur_iters = 1 if self.chunk_schedule == "auto" else self.chunk_iters
        while not wrk.result.converged:
            key = (wrk._amp_bucket, cur_iters)
            if key not in chunk_cache:
                chunk_cache[key] = self._make_chunk(wrk, cur_iters)
            chunk = chunk_cache[key]
            t0 = _time.perf_counter()
            # the carry (incl. the optax state) STAYS on device for the
            # next chunk; only the per-iteration trace is fetched
            carry, trace_dev = chunk(
                jnp.asarray(x), opt_state, jnp.asarray(J), jnp.asarray(g)
            )
            trace = jax.device_get(trace_dev)
            chunk_secs = _time.perf_counter() - t0
            _x_dev, opt_state, _J_dev, _g_dev = carry

            n = cur_iters
            per_iter_secs = chunk_secs / max(n, 1)
            stopped = False
            eventful = False  # envelope growth / callback mutation
            for i in range(n):
                if not bool(trace["chi_ok"][i]):
                    raise RuntimeError(
                        "The norm of a state χ(T) is below chi_min_norm: "
                        "the gradient is zero"
                    )
                # np.array (copy): device_get output is read-only when
                # no dtype conversion forces a copy (CPU f64 runs), and
                # x/g are mutated downstream (callback pulse mutation,
                # fg's in-place G_out write)
                x_i = np.array(trace["x"][i], dtype=np.float64)
                # Envelope guard (host backends check before EVERY
                # evaluation via _ensure_envelope; the static chunk
                # program cannot grow mid-chunk): an iterate outside the
                # amplitude bucket was produced by a stale-envelope
                # program — its J/gradient (cheby tables, static taylor
                # orders) are not trustworthy.  Discard it and the rest
                # of the chunk, grow the envelope to cover it, and
                # re-take the step from the last recorded iterate with
                # the grown program (fresh optimizer state: per-iteration
                # optax carries are not retained on host).
                stale = False
                if wrk._amp_bucket is not None:
                    amps = np.max(
                        np.abs(x_i.reshape(-1, wrk.cp.n_timesteps)),
                        axis=1,
                    )
                    stale = bool(
                        np.any(amps > np.asarray(wrk._amp_bucket))
                    )
                if stale or not bool(trace["taylor_ok"][i]):
                    if wrk._amp_bucket is None:
                        raise RuntimeError(
                            "Taylor gradient series did not converge "
                            "within the static order budget; decrease "
                            "the time step or supply finite bounds"
                        )
                    if stale:
                        wrk._ensure_envelope(x_i)
                    else:
                        # in-envelope taylor_ok failure: the bound was
                        # too loose — grow once (the host path's
                        # safety net, workspace.evaluate_gradient)
                        wrk._amp_bucket = wrk._bucket_for(
                            2.0 * np.asarray(wrk._amp_bucket)
                        )
                        wrk.fg, wrk.f = wrk._programs()
                    wrk.pulsevals = x
                    J = fg(0.0, g, x)  # re-sync carry at the re-seed x
                    opt_state = self._init_state(x)
                    stopped = True
                    eventful = True
                    break
                x = x_i
                x_snapshot = x.copy()
                J = float(trace["J"][i])
                g = np.array(trace["g"][i], dtype=np.float64)
                wrk.pulsevals = x
                wrk.gradient[:] = g
                wrk.J_parts[:] = np.asarray(
                    trace["J_parts"][i], dtype=np.float64
                )
                wrk.tau_vals[:] = unpack_complex(trace["tau"][i])
                wrk.states = unpack_complex(trace["psi_T"][i])
                alpha = float(trace["alpha"][i])
                wrk.alpha = alpha if np.isfinite(alpha) and alpha > 0 \
                    else 1.0
                wrk.searchdirection[:] = (
                    np.asarray(trace["update"][i]) / wrk.alpha
                )
                ls = int(trace["ls_steps"][i])
                wrk.fg_count[0] = 1 + max(ls, 0)
                wrk.result.fg_calls += 1 + max(ls, 0)
                it = wrk.result.iter + 1
                update_result(wrk, it)
                wrk.result.secs = per_iter_secs
                rec = callback(wrk, wrk.result.iter)
                if rec:
                    wrk.result.records.append(rec)
                wrk.fg_count[:] = 0
                apply_convergence_check(wrk.result, check_convergence)
                wrk.pulsevals_guess[:] = x
                wrk.gradient_guess[:] = g
                # callback pulse mutation: takes effect from the next
                # chunk (re-seed x and re-evaluate there)
                if not np.array_equal(wrk.pulsevals, x_snapshot):
                    x = np.asarray(wrk.pulsevals, dtype=np.float64)
                    J = fg(0.0, g, x)
                    stopped = True
                    eventful = True
                if wrk.result.converged:
                    stopped = True
                if stopped:
                    break
            # envelope growth between chunks (re-jits the chunk program)
            wrk._ensure_envelope(x)
            if self.chunk_schedule == "auto":
                # eventful chunk (mutation/envelope): back to exact
                # per-iteration semantics; clean chunk: amortize harder.
                # Duration guard: never grow to a chunk whose projected
                # duration could cross ~45 s (a line-search-heavy
                # iteration can triple a chunk's fg count, hence the
                # 1.5× margin on the per-iteration estimate).  When the
                # FULL chunk size projects under the limit, jump straight
                # to it: every distinct chunk LENGTH is a separate
                # compiled program, so the 1→16 jump compiles two
                # programs where a 1→2→4→8→16 ladder compiles five.
                if eventful:
                    cur_iters = 1
                elif not stopped:
                    per_iter = chunk_secs / max(cur_iters, 1)
                    if 1.5 * per_iter * self.chunk_iters < 45.0:
                        cur_iters = self.chunk_iters
                    elif 2 * chunk_secs < 45.0:
                        cur_iters = min(2 * cur_iters, self.chunk_iters)
        return None
