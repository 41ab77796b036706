"""Pulse shape functions.

JAX analog of ``QuantumPropagators.Shapes`` (used by the reference at
e.g. ``test/test_tls_optimization.jl:20`` and
``test/test_state_running_cost.jl:219-227``): ``flattop``, ``blackman``,
``box``.

These are primarily *host-side* functions (guess pulses and static shape
tables are discretized on host before entering the jitted program), so they
compute with numpy for plain inputs; traced/jnp inputs transparently use
``jax.numpy`` so the same functions remain usable inside jit.
"""

import numpy as np

__all__ = ["box", "blackman", "flattop"]


def _xp(t):
    try:
        import jax
        import jax.numpy as jnp

        if isinstance(t, (jax.Array, jax.core.Tracer)):
            return jnp
    except ImportError:  # pragma: no cover
        pass
    return np


def box(t, t0, T):
    """Box shape: 1.0 for ``t0 <= t <= T``, 0.0 otherwise."""
    xp = _xp(t)
    t = xp.asarray(t)
    return xp.where((t >= t0) & (t <= T), 1.0, 0.0)


def blackman(t, t0, T, a=0.16):
    """Blackman window on ``[t0, T]``, zero outside.

    ``0.5 * (1 - a - cos(2π x) + a cos(4π x))`` with ``x = (t - t0)/(T - t0)``.
    """
    xp = _xp(t)
    t = xp.asarray(t)
    x = (t - t0) / (T - t0)
    val = 0.5 * (1.0 - a - xp.cos(2 * np.pi * x) + a * xp.cos(4 * np.pi * x))
    return xp.where((t >= t0) & (t <= T), val, 0.0)


def _sinsq_ramp_up(t, t0, t_rise, xp):
    x = (t - t0) / t_rise
    return xp.sin(0.5 * np.pi * x) ** 2


def flattop(t, T, t_rise, t0=0.0, t_fall=None, func="blackman"):
    """Flat shape with a smooth switch-on/off.

    1.0 in ``[t0 + t_rise, T - t_fall]``, ramping from/to zero over ``t_rise``
    (``t_fall``) using a Blackman half-window (``func="blackman"``) or a
    ``sin²`` ramp (``func="sinsq"``); zero outside ``[t0, T]``.
    """
    if t_fall is None:
        t_fall = t_rise
    xp = _xp(t)
    t = xp.asarray(t)
    if func == "blackman":
        up = blackman(t, t0, t0 + 2 * t_rise)
        down = blackman(t, T - 2 * t_fall, T)
    elif func == "sinsq":
        up = _sinsq_ramp_up(t, t0, t_rise, xp)
        down = _sinsq_ramp_up(t, T, -t_fall, xp)
    else:  # pragma: no cover
        raise ValueError(f"Unknown flattop func: {func!r}")
    val = xp.where(
        t < t0 + t_rise, up, xp.where(t <= T - t_fall, 1.0, down)
    )
    return xp.where((t >= t0) & (t <= T), val, 0.0)
