"""CARMA tests (reference analog: tests/test_celerite.py:22-42 + carma_comp.cc)."""

import numpy as np
import pytest

from celerite_tpu.ops.carma import CARMASolver
from celerite_tpu.ops.kernels import kernel_value
from celerite_tpu.solver import CholeskySolver


def make_data(n=100, seed=42):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, n))
    yerr = rng.uniform(0.1, 0.2, n)
    y = np.sin(t) + yerr * rng.standard_normal(n)
    return t, yerr, y


CASES = [
    (0.1, [0.1], []),  # CAR(1)
    (0.1, [1.0, 0.5], []),  # complex AR pair
    (0.0, [1.0, 0.5], [0.1]),  # CARMA(2,1)
    (0.1, [1.3, 0.4, 0.1], [0.5]),  # CARMA(3,1), mixed roots
]


@pytest.mark.parametrize("log_sigma,arpars,mapars", CASES)
def test_carma_vs_celerite_loglike(log_sigma, arpars, mapars):
    """Kalman ll must equal the semiseparable ll after conversion."""
    t, yerr, y = make_data(100)
    carma = CARMASolver(log_sigma, arpars, mapars)
    ll_kalman = carma.log_likelihood(t, y, yerr)

    coeffs = carma.get_celerite_coeffs()
    chol = CholeskySolver()
    chol.compute(0.0, *coeffs, t=t, diag=yerr**2)
    ll_chol = -0.5 * (
        chol.dot_solve(y)
        + chol.log_determinant()
        + len(t) * np.log(2 * np.pi)
    )
    np.testing.assert_allclose(ll_chol, ll_kalman, rtol=1e-8)


@pytest.mark.parametrize("log_sigma,arpars,mapars", CASES)
def test_carma_covariance_matches_converted_kernel(
    log_sigma, arpars, mapars
):
    carma = CARMASolver(log_sigma, arpars, mapars)
    coeffs = carma.get_celerite_coeffs()
    tau = np.linspace(0, 5, 40)
    k_celerite = np.asarray(kernel_value(*map(np.asarray, coeffs), tau))
    k_carma = carma.covariance(tau)
    np.testing.assert_allclose(k_celerite, k_carma, rtol=1e-8, atol=1e-10)


def test_carma_psd_positive_and_integrates():
    carma = CARMASolver(0.1, [1.0, 0.5], [0.1])
    f = np.linspace(0, 5, 1000)
    psd = carma.psd(f)
    assert np.all(psd >= 0)
    # Parseval-ish check: 2 * integral of PSD over f ~ variance k(0).
    var = 2.0 * np.trapezoid(psd, f)
    np.testing.assert_allclose(var, carma.covariance(0.0), rtol=0.05)


def test_carma_q_must_be_less_than_p():
    with pytest.raises(ValueError):
        CARMASolver(0.0, [0.1], [0.1])


def test_carma_exposed_in_solver_module():
    import celerite_tpu.solver as solver

    assert solver.CARMASolver is CARMASolver


@pytest.mark.parametrize("ar, ma", [
    ([np.log(2.0), np.log(0.7)], [np.log(1.2)]),
    ([np.log(2.0), np.log(0.7), np.log(0.3)], []),
    ([np.log(4.0), np.log(0.5), np.log(1.5), np.log(0.8)],
     [np.log(1.0), np.log(0.9)]),
])
def test_kalman_matches_celerite_loglik(ar, ma):
    """The complex-arithmetic Kalman filter (the one CARMA path) agrees
    with the semiseparable likelihood of the converted celerite
    coefficients (reference analog carma.h:221-239)."""
    import jax.numpy as jnp
    from celerite_tpu.ops import seq
    from celerite_tpu.ops.carma import CARMASolver
    from celerite_tpu.ops.lower import Coefficients, lower

    rng = np.random.default_rng(3)
    n = 256
    t = np.sort(rng.uniform(0, 50, n))
    y = np.sin(0.7 * t) + 0.3 * rng.standard_normal(n)
    yerr = np.full(n, 0.1)
    s = CARMASolver(0.1, ar, ma)
    ll_k = s.log_likelihood(t, y, yerr)
    coeffs = Coefficients(
        *[jnp.asarray(c) for c in s.get_celerite_coeffs()],
        jitter=jnp.asarray(0.0),
    )
    ll_c, ok = seq.gp_log_likelihood(
        lower(coeffs, jnp.asarray(t), jnp.asarray(yerr**2)), jnp.asarray(y)
    )
    assert bool(ok)
    np.testing.assert_allclose(ll_k, float(ll_c), rtol=1e-8)


def test_carma_quiet_negative_variance():
    """quiet=True reports (ll, ok=False) instead of raising when the
    diagonalized filter degenerates (large-p failure mode)."""
    import numpy as np
    import pytest
    from benchmarks.carma import make_problem
    from celerite_tpu.ops.carma import CARMASolver

    ls, ar, ma, t, y, yerr = make_problem(256, 256)
    s = CARMASolver(ls, ar, ma)
    ll, ok = s.log_likelihood(t, y, yerr, quiet=True)
    assert not ok
    with pytest.raises(RuntimeError):
        s.log_likelihood(t, y, yerr)
