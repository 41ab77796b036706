"""Multi-device trajectory parallelism.

The reference's only parallel strategy is shared-memory trajectory
parallelism (``@threadsif wrk.use_threads for k = 1:N`` around the
forward/backward loops, ``/root/reference/src/optimize.jl:720,876`` and the
serial ``Σ_k`` gradient reduction at ``src/optimize.jl:574-584``).  The
JAX counterpart shards the trajectory axis ``K`` over a
``jax.sharding.Mesh``:

- all per-trajectory arrays (``psi0``, ``H0``, ``ops``, forward storage,
  co-states, ``tau_grads``) carry a ``P('traj')`` sharding on their ``K``
  axis, so each device propagates its shard of the ensemble;
- the cross-trajectory reductions (``Σ_k ∇τ_knl``, ``J_parts``, ``tau``)
  lower to ``psum``/``all-reduce`` collectives (NCCL between GPUs),
  inserted by XLA's SPMD partitioner from the sharding annotations;
- the pulse vector is replicated: the host-side L-BFGS-B consumes the fully
  reduced gradient, exactly mirroring where the reference splits work
  between ``fg!`` and the Fortran ``setulb`` loop.

The mesh follows the trajectory axis alone: the GPUs of one host are
joined all to all by NVLink, so no device layout is better than another.
Works identically on a virtual CPU mesh
(``--xla_force_host_platform_device_count``).
"""

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fg import CompiledProblem, build_f, build_fg
from ..trajectory import Trajectory

__all__ = [
    "make_mesh", "make_host_chip_mesh", "init_distributed", "shard_problem",
    "build_fg_sharded", "build_f_sharded", "ensemble_trajectories",
    "traj_axes",
]


def make_mesh(n_devices=None, axis="traj", devices=None):
    """A 1D device mesh over the trajectory axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def make_host_chip_mesh(n_hosts=None, devices=None):
    """A 2D ``(host, chip)`` mesh: the trajectory axis shards over BOTH axes
    (``P(('host', 'chip'))``), laid out so the per-host trajectory blocks
    are contiguous — the ``Σ_k`` psum then reduces within each host first
    and crosses the network between hosts only for the per-host partial
    sums.

    With ``jax.distributed`` initialized (see :func:`init_distributed`),
    ``jax.devices()`` spans all hosts and ``n_hosts`` defaults to
    ``jax.process_count()``; on one host this builds an ``(1, n_chips)``
    mesh, useful for testing the 2D code path."""
    if devices is None:
        devices = jax.devices()
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    n_dev = len(devices)
    if n_dev % n_hosts != 0:
        raise ValueError(
            f"device count ({n_dev}) not divisible by host count ({n_hosts})"
        )
    grid = np.array(devices).reshape(n_hosts, n_dev // n_hosts)
    return Mesh(grid, ("host", "chip"))


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kwargs):
    """Initialize multi-host JAX (``jax.distributed.initialize``) so every
    host sees the global device set; afterwards :func:`make_host_chip_mesh`
    builds the global 2D mesh.  Where no cluster environment describes
    the processes, pass ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` explicitly; returns the global
    device list."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    return jax.devices()


def traj_axes(mesh):
    """The mesh axis name (or tuple of names) the trajectory axis shards
    over: all axes of the mesh."""
    names = tuple(mesh.axis_names)
    return names[0] if len(names) == 1 else names


def shard_problem(cp: CompiledProblem, mesh, axis=None):
    """Place the per-trajectory COMPLEX arrays of a compiled problem on
    `mesh`, sharded along ``K``.  ``K`` must be divisible by the mesh
    size.  For a 2D ``(host, chip)`` mesh the trajectory axis shards over
    both mesh axes.

    The real coefficient tables (M, Mfix, tlist) stay host-side numpy:
    they are small, enter the programs as replicated constants, and the
    host-side envelope/bound machinery reads them with numpy.  The
    complex arrays become device-resident and are passed to the sharded
    programs as ARGUMENTS (sharded buffers, not program constants)."""
    if axis is None:
        axis = traj_axes(mesh)
    names = axis if isinstance(axis, (tuple, list)) else (axis,)
    n_dev = 1
    for name in names:
        n_dev *= int(mesh.shape[name])
    if cp.n_traj % n_dev != 0:
        raise ValueError(
            f"number of trajectories ({cp.n_traj}) must be divisible by "
            f"the trajectory-axis shard count ({n_dev}); pad the "
            f"ensemble with zero-weight trajectories"
        )
    traj_sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    import dataclasses

    # group-level operator storage (cp.ops_grouped: one H0/ops entry per
    # generator group): shard the GROUP axis when it divides the shard
    # count, else expand to per-trajectory entries on host first (a
    # shard boundary must never straddle a group's single operator row)
    H0_host, ops_host = cp.H0, cp.ops
    ops_grouped = cp.ops_grouped
    if ops_grouped:
        n_groups = np.asarray(H0_host).shape[0]
        if n_groups % n_dev != 0:
            gs = cp.gen_group_size
            H0_host = np.repeat(np.asarray(H0_host), gs, axis=0)
            ops_host = np.repeat(np.asarray(ops_host), gs, axis=0)
            ops_grouped = False

    # with a shared generator the programs slice H0[0]/ops[0]: replicate
    # the operator arrays so the slice is local on every device
    op_sharding = repl if cp.shared_generator else traj_sharding
    return dataclasses.replace(
        cp,
        psi0=jax.device_put(np.asarray(cp.psi0), traj_sharding),
        H0=jax.device_put(np.asarray(H0_host), op_sharding),
        ops=jax.device_put(np.asarray(ops_host), op_sharding),
        ops_grouped=ops_grouped,
        # recorded so the grouped paths see the per-shard trajectory count
        mesh=mesh,
        mesh_axis=axis,
    )


_DEVICE_ARRAY_FIELDS = ("psi0", "H0", "ops")


def _build_sharded(build, cp, mesh, axis, amp_max, presharded, n_out):
    """Common wrapper: the sharded complex problem arrays enter the
    jitted program as arguments (traced), everything else as host
    constants; outputs are fully reduced (replicated)."""
    import dataclasses

    from .. import fg as _fg

    if not presharded:
        cp = shard_problem(cp, mesh, axis=axis)
    dev = {name: getattr(cp, name) for name in _DEVICE_ARRAY_FIELDS}
    # host-side envelope machinery must run OUTSIDE the trace
    _fg._warm_env_cache(cp, amp_max)
    repl = NamedSharding(mesh, P())
    in_shardings = (repl, {k: v.sharding for k, v in dev.items()})
    # aux outputs replicated too: the host consumes every aux field
    # (tau, psi_T, J_parts, counters), and in MULTI-PROCESS runs a
    # non-replicated output spans non-addressable devices and cannot be
    # device_get at all — the all-gather is the transfer the host would
    # otherwise do anyway
    out_shardings = (repl,) * n_out + (repl,)

    def call(pulsevals, arrs):
        cp_t = dataclasses.replace(cp, **arrs)
        return build(cp_t, amp_max=amp_max)(pulsevals)

    prog = jax.jit(
        call, in_shardings=in_shardings, out_shardings=out_shardings
    )

    def wrapped(pulsevals):
        return prog(pulsevals, dev)

    return wrapped, cp


def build_fg_sharded(cp: CompiledProblem, mesh, axis=None, amp_max=None,
                     presharded=False):
    """The jitted fg program with explicit shardings: pulse vector
    replicated in, ``(J, grad)`` fully reduced (replicated) out.  XLA's SPMD
    partitioner propagates the ``P('traj')`` sharding of the problem arrays
    through the scans and inserts the cross-trajectory ``psum`` collectives
    for the ``Σ_k`` reductions.  With ``presharded``, ``cp``'s arrays
    already live on the mesh (skips the device_put)."""
    return _build_sharded(
        build_fg, cp, mesh, axis, amp_max, presharded, n_out=2
    )


def build_f_sharded(cp: CompiledProblem, mesh, axis=None, amp_max=None,
                    presharded=False):
    """Sharded functional-only program (line-search F probes)."""
    return _build_sharded(
        build_f, cp, mesh, axis, amp_max, presharded, n_out=1
    )


def ensemble_trajectories(base_trajectory, generators, weights=None):
    """Build an ensemble (robustness-sampling) trajectory list: the same
    initial/target states evolving under perturbed generators — the
    reference's 'ensemble optimization' pattern (docs/src/tutorial.md)."""
    K = len(generators)
    if weights is None:
        weights = [1.0] * K
    return [
        Trajectory(
            base_trajectory.initial_state,
            gen,
            target_state=base_trajectory.target_state,
            weight=w,
        )
        for gen, w in zip(generators, weights)
    ]
