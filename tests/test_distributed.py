"""REAL multi-process distributed optimization (multi-host story).

The reference is a single-process code (``@threadsif`` threads,
SURVEY §2); the JAX multi-host counterpart is
``optimize(..., mesh=...)`` over a global mesh built after
``jax.distributed.initialize``.  This test launches TWO separate processes
with Gloo CPU collectives — the cross-trajectory ``psum`` is genuine
inter-process communication — and asserts:

1. both controllers converge in lockstep (identical J_T traces), and
2. the distributed trace equals the single-process trace on the same
   16-trajectory ensemble (the ``Σ_k`` reduction is associative over the
   same f64 addition tree at 16/8 trajectories-per-device).
"""

import json
import os
import subprocess
import sys

import numpy as np


def test_two_process_distributed_optimize_matches_single_process():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = "29517"
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    workers = [
        subprocess.Popen(
            [sys.executable, "-m", "tests.distributed_worker",
             str(pid), "2", port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=here, env=env,
        )
        for pid in range(2)
    ]
    results = {}
    for p in workers:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                results[r["pid"]] = r
    assert set(results) == {0, 1}
    r0, r1 = results[0], results[1]
    assert r0["n_processes"] == 2 and r0["n_devices"] == 8
    # both controllers ran the host L-BFGS-B in lockstep
    np.testing.assert_allclose(r0["trace"], r1["trace"], rtol=0, atol=0)
    assert r0["iter"] == r1["iter"] == 5
    # distributed trace == single-process trace on the same problem
    import jax

    from grape_tpu import optimize
    from grape_tpu.functionals import J_T_sm
    from grape_tpu.models import transmon_ensemble_trajectories
    from grape_tpu.parallel import make_host_chip_mesh

    trajectories = transmon_ensemble_trajectories(16, d=3, T=4.0)
    tlist = np.linspace(0.0, 4.0, 17)
    mesh = make_host_chip_mesh(
        n_hosts=1, devices=jax.devices()[:8]
    )
    trace = []
    res = optimize(
        trajectories, tlist, mesh=mesh, J_T=J_T_sm, iter_stop=5,
        callback=lambda wrk, it: trace.append(float(wrk.result.J_T)),
        print_iters=False, rethrow_exceptions=True,
    )
    assert res.iter == r0["iter"]
    np.testing.assert_allclose(r0["trace"], trace, rtol=1e-12, atol=1e-14)
    assert r0["trace"][-1] < r0["trace"][0]  # real optimization progress
