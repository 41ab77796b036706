"""Unit tests for the batched expm and Fréchet kernels."""

import numpy as np
import pytest
import scipy.linalg

from grape_tpu.ops import expm, expm_frechet, gradgen_step
from grape_tpu.ops.expm import taylor_order_for_bound


@pytest.mark.parametrize("dim", [2, 4, 10, 32])
def test_expm_vs_scipy(dim):
    rng = np.random.default_rng(42 + dim)
    A = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    E = np.asarray(expm(A))
    E_ref = scipy.linalg.expm(A)
    assert np.linalg.norm(E - E_ref) < 1e-12 * np.linalg.norm(E_ref)


def test_expm_batched():
    rng = np.random.default_rng(7)
    A = rng.normal(size=(5, 3, 8, 8)) + 1j * rng.normal(size=(5, 3, 8, 8))
    E = np.asarray(expm(A))
    for i in range(5):
        for j in range(3):
            E_ref = scipy.linalg.expm(A[i, j])
            assert np.linalg.norm(E[i, j] - E_ref) < 1e-11


def test_expm_large_norm():
    """Scaling-and-squaring must handle norms well above theta13."""
    rng = np.random.default_rng(3)
    A = 50.0 * (rng.normal(size=(6, 6)) + 1j * rng.normal(size=(6, 6)))
    E = np.asarray(expm(A))
    E_ref = scipy.linalg.expm(A)
    assert np.linalg.norm(E - E_ref) < 1e-9 * np.linalg.norm(E_ref)


def test_expm_frechet_vs_scipy():
    rng = np.random.default_rng(11)
    d = 8
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    B = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    E, L = expm_frechet(A, B)
    # scipy's expm_frechet only supports real or complex; compare
    E_ref, L_ref = scipy.linalg.expm_frechet(A, B)
    assert np.linalg.norm(np.asarray(E) - E_ref) < 1e-12 * np.linalg.norm(E_ref)
    assert np.linalg.norm(np.asarray(L) - L_ref) < 1e-10 * max(
        np.linalg.norm(L_ref), 1.0
    )


def test_gradgen_step_matches_finite_difference():
    """(∂/∂ε exp(-i(H+εμ)dt))χ at ε=0 via central finite differences."""
    rng = np.random.default_rng(5)
    d, L = 6, 2
    H = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    mu = rng.normal(size=(L, d, d)) + 1j * rng.normal(size=(L, d, d))
    chi = rng.normal(size=(d,)) + 1j * rng.normal(size=(d,))
    dt = 0.37
    chi_prime, chi_new = gradgen_step(H[None], mu[None], chi[None], dt)
    chi_prime = np.asarray(chi_prime)[0]
    chi_new = np.asarray(chi_new)[0]
    U = scipy.linalg.expm(-1j * dt * H)
    assert np.linalg.norm(chi_new - U @ chi) < 1e-12
    h = 1e-6
    for l in range(L):
        Up = scipy.linalg.expm(-1j * dt * (H + h * mu[l]))
        Um = scipy.linalg.expm(-1j * dt * (H - h * mu[l]))
        dU = (Up - Um) / (2 * h)
        assert np.linalg.norm(chi_prime[l] - dU @ chi) < 1e-7


def test_expm_single_precision_taylor():
    """The complex64 path (matmul-only Taylor/Paterson-Stockmeyer) is
    accurate to f32 roundoff for skew-Hermitian generators."""
    import scipy.linalg as sla

    rng = np.random.default_rng(9)
    H = rng.normal(size=(8, 8))
    H = H + H.T
    for s in (0.3, 5.0, 40.0):
        A = (-1j * s * H).astype(np.complex64)
        E = np.asarray(expm(A[None]))[0]
        ref = sla.expm(A.astype(np.complex128))
        rel = np.linalg.norm(E - ref) / np.linalg.norm(ref)
        assert rel < 5e-5, (s, rel)
        # unitarity preserved
        assert np.linalg.norm(E @ E.conj().T - np.eye(8)) < 1e-4


@pytest.mark.parametrize("bound,prefactor", [(0.05, 1.0), (0.5, 3.0),
                                             (2.0, 0.2)])
def test_taylor_order_for_bound(bound, prefactor):
    """The static order is the first m whose term bound
    prefactor·m·bound^m/m! falls below the tolerance, plus 2."""
    from math import factorial

    tol = 1e-9
    m_star = next(
        m for m in range(1, 100)
        if prefactor * m * bound**m / factorial(m) < tol
    )
    assert taylor_order_for_bound(bound, tolerance=tol,
                                  prefactor=prefactor) == m_star + 2


def test_taylor_order_for_bound_unreachable():
    """No order within max_order reaches the tolerance: None (the caller
    falls back to the dynamic while_loop path); the +2 margin is capped
    at max_order."""
    assert taylor_order_for_bound(50.0, tolerance=1e-12, max_order=20) is None
    assert taylor_order_for_bound(0.5, tolerance=1e-9, max_order=12) == 12
