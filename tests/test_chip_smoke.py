"""``chip_smoke.py`` on the CPU: the phase functions at tiny sizes, the
``env`` phase's refusal of a CPU device, and the compile-cache helper.

On the CPU the "card" side of each parity phase is the CPU device in
complex64, so these tests check control flow and the comparison, not
GPU numerics (those come from running the script on the card)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from grape_tpu import compile_cache  # noqa: E402


def test_env_phase_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_platform("gpu")
    assert exc.value.code not in (0, None)


def test_script_exits_nonzero_without_gpu(tmp_path):
    """Run as the user would, on a machine with no GPU: non-zero exit and
    no result line, both from the checkout and from a directory holding
    nothing but the script."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        proc = subprocess.run(
            [sys.executable, script], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout


def test_require_platform_reports_env(monkeypatch):
    import jax

    monkeypatch.setattr(jax.config, "update", lambda name, value: None)
    env = chip_smoke.require_platform("cpu", count=4)
    assert env["platform"] == "cpu" and env["count"] >= 4
    assert env["compile_cache_dir"]


def test_cz_solve_tiny():
    out = chip_smoke.cz_solve(d=2, n_steps=40, T=10.0, iter_stop=3)
    assert out["optimizer"] == "LBFGSB"
    assert out["iters"] == 3 and out["J_T"] < out["J_T_guess"]


def test_cz_parity_tiny():
    out = chip_smoke.cz_parity(d=2, n_steps=40, T=10.0, n_reps=1)
    assert set(out) == {"taylor", "gradgen"}
    for m, line in out.items():
        assert line["gradient_method"] == m and line["dim"] == 4
        assert line["dJ"] <= line["dJ_tol"]


def test_ensemble_parity_tiny():
    out = chip_smoke.ensemble_parity(n_samples=2, d=2, n_steps=20, n_reps=1)
    assert out["K"] == 8 and out["gradient_method"] == "gradgen"
    assert out["N_T"] == 20 and out["N_T_cut_from"] == 800


def test_cheby_parity_tiny():
    out = chip_smoke.cheby_parity(d=3, n_basis=4, n_steps=10, n_reps=1)
    assert out["prop_method"] == "cheby" and out["dim"] == 9


def test_smalld_parity_tiny():
    out = chip_smoke.smalld_parity(n_samples=16, n_steps=20, n_reps=1)
    assert out["K"] == 16 and out["dim"] == 3


def test_parity_fails_outside_tolerance():
    from grape_tpu.models import two_transmon_cz_problem

    p = two_transmon_cz_problem(d=2, n_steps=20, T=10.0)
    with pytest.raises(AssertionError, match="outside tolerance"):
        chip_smoke.parity(p.trajectories, p.tlist, n_reps=1, j_tol=0.0,
                          grad_tol=0.0, **p.kwargs)


def test_device_loop_tiny():
    out = chip_smoke.device_loop(d=2, n_steps=40, T=10.0, chunk=2)
    assert out["iters"] == 4 and "second_chunk_s" in out


def test_four_cards_tiny():
    """The four-device path on four virtual CPU devices."""
    out = chip_smoke.four_cards(n_devices=4, n_samples=2, d=2, n_steps=20,
                                iters=2, n_reps=1)
    assert out["devices_spanned"] == {"psi0": 4, "H0": 4, "ops": 4}
    assert out["local_leading_dim"]["psi0"] == 2


@pytest.mark.parametrize("env_value", [None, "set"])
def test_compile_cache_dir(env_value, tmp_path, monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    if env_value is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        expect = os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
        expect = str(tmp_path)
    assert compile_cache.default_cache_dir() == os.path.join(
        REPO, ".jax_cache")
    assert compile_cache.enable_compile_cache() == expect
    assert calls == [("jax_compilation_cache_dir", expect)]


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A compilation in a fresh process writes its entry under
    ``JAX_COMPILATION_CACHE_DIR``."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from grape_tpu.compile_cache import enable_compile_cache\n"
        "enable_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           compile_cache.ENV_VAR: str(tmp_path / "cache")}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=300)
    assert os.listdir(tmp_path / "cache")
