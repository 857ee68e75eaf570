"""Temporal-parallel Kalman smoother (ops/pkalman.py) vs the sequential
filter/smoother (ops/smoother.py).

Both are exact algorithms for the same Gauss-Markov model, so in f64
they must agree to roundoff — filtered/smoothed moments, missing-data
handling (the merged train/test grid), and the marginal likelihood.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from celerite_tpu.ops import pkalman, smoother
from celerite_tpu.ops.lower import Coefficients


def _mk_coeffs():
    return Coefficients(
        a_real=jnp.asarray([0.7]),
        c_real=jnp.asarray([0.9]),
        a_comp=jnp.asarray([0.8]),
        b_comp=jnp.asarray([0.2]),
        c_comp=jnp.asarray([0.6]),
        d_comp=jnp.asarray([1.9]),
        jitter=jnp.asarray(0.01),
    )


def _grid(n=257, seed=0, missing=0.3):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 20.0, n))
    dt = np.concatenate([[0.0], np.diff(t)])
    yv = np.sin(0.7 * t) + 0.1 * rng.standard_normal(n)
    rv = 0.05 + 0.02 * rng.random(n)
    obs = (rng.random(n) > missing).astype(float)
    yv = yv * obs
    rv = np.where(obs > 0, rv, 1.0)
    return dt, yv, rv, obs


@pytest.mark.slow
def test_matches_sequential_filter_smoother():
    real_ = smoother.realize(_mk_coeffs())
    assert real_ is not None
    dt, yv, rv, obs = _grid()
    args = [jnp.asarray(x) for x in (dt, yv, rv, obs)]
    m_seq, v_seq, ll_seq = smoother._filter_smoother(real_, *args)
    m_par, v_par, ll_par = pkalman.parallel_filter_smoother(real_, *args)
    np.testing.assert_allclose(
        np.asarray(m_par), np.asarray(m_seq), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(v_par), np.asarray(v_seq), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(float(ll_par), float(ll_seq), rtol=1e-11)


@pytest.mark.slow
def test_all_observed_and_duplicate_times():
    real_ = smoother.realize(_mk_coeffs())
    rng = np.random.default_rng(3)
    t = np.sort(np.concatenate([rng.uniform(0, 5.0, 100),
                                [2.0, 2.0, 2.0]]))
    dt = np.concatenate([[0.0], np.diff(t)])
    yv = np.cos(t)
    rv = np.full(t.shape, 0.04)
    obs = np.ones(t.shape)
    args = [jnp.asarray(x) for x in (dt, yv, rv, obs)]
    m_seq, v_seq, ll_seq = smoother._filter_smoother(real_, *args)
    m_par, v_par, ll_par = pkalman.parallel_filter_smoother(real_, *args)
    np.testing.assert_allclose(
        np.asarray(m_par), np.asarray(m_seq), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(v_par), np.asarray(v_seq), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(float(ll_par), float(ll_seq), rtol=1e-11)


@pytest.mark.slow
def test_predict_var_parallel_matches_sequential():
    coeffs = _mk_coeffs()
    rng = np.random.default_rng(7)
    n, m = 200, 64
    t_train = np.sort(rng.uniform(0, 10.0, n))
    t_test = np.linspace(-0.5, 10.5, m)
    diag = np.full(n, 0.04)
    resid = np.sin(0.8 * t_train) + 0.2 * rng.standard_normal(n)
    mu_s, var_s = smoother.predict_var(coeffs, t_train, diag, resid,
                                       t_test)
    mu_p, var_p = pkalman.predict_var_parallel(coeffs, t_train, diag,
                                               resid, t_test)
    np.testing.assert_allclose(mu_p, mu_s, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var_p, var_s, rtol=1e-9, atol=1e-11)
    assert np.all(var_p >= 0)


@pytest.mark.parametrize("n,L", [(257, None), (1024, 64), (1000, 128),
                                 (64, 16)])
def test_blocked_matches_sequential(n, L):
    """Two-level blocked filter/smoother == sequential, to roundoff,
    across ragged N, explicit block sizes, and missing data."""
    real_ = smoother.realize(_mk_coeffs())
    dt, yv, rv, obs = _grid(n=n, seed=n)
    args = [jnp.asarray(x) for x in (dt, yv, rv, obs)]
    m_seq, v_seq, ll_seq = smoother._filter_smoother(real_, *args)
    m_b, v_b, ll_b = pkalman.blocked_filter_smoother(
        real_, *args, block_size=L
    )
    np.testing.assert_allclose(
        np.asarray(m_b), np.asarray(m_seq), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(v_b), np.asarray(v_seq), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(float(ll_b), float(ll_seq), rtol=1e-11)


def test_blocked_all_observed_and_duplicate_times():
    real_ = smoother.realize(_mk_coeffs())
    rng = np.random.default_rng(3)
    t = np.sort(np.concatenate([rng.uniform(0, 5.0, 100),
                                [2.0, 2.0, 2.0]]))
    dt = np.concatenate([[0.0], np.diff(t)])
    yv = np.cos(t)
    rv = np.full(t.shape, 0.04)
    obs = np.ones(t.shape)
    args = [jnp.asarray(x) for x in (dt, yv, rv, obs)]
    m_seq, v_seq, ll_seq = smoother._filter_smoother(real_, *args)
    m_b, v_b, ll_b = pkalman.blocked_filter_smoother(real_, *args,
                                                     block_size=32)
    np.testing.assert_allclose(
        np.asarray(m_b), np.asarray(m_seq), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(v_b), np.asarray(v_seq), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(float(ll_b), float(ll_seq), rtol=1e-11)


@pytest.mark.parametrize("n_train,n_test", [(150, 40), (6000, 3000)])
def test_gp_predict_size_routing(monkeypatch, n_train, n_test):
    """GP.predict(return_var=True) takes the blocked engine at every
    merged size, small and large, and gives ops/smoother's answer."""
    from celerite_tpu import GP, terms

    calls = []
    real_parallel = pkalman.predict_var_parallel

    def spy(*args, **kwargs):
        calls.append(1)
        return real_parallel(*args, **kwargs)

    monkeypatch.setattr(pkalman, "predict_var_parallel", spy)
    rng = np.random.default_rng(11)
    t = np.sort(rng.uniform(0, 10.0, n_train))
    yerr = np.full_like(t, 0.2)
    y = np.sin(t) + 0.2 * rng.standard_normal(t.size)
    grid = np.linspace(-0.5, 10.5, n_test)
    kernel = terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
    gp = GP(kernel)
    gp.compute(t, yerr)
    mu, var = gp.predict(y, grid, return_var=True)
    assert len(calls) == 1
    coeffs = Coefficients(
        *[jnp.asarray(c) for c in kernel.coefficients],
        jitter=jnp.asarray(kernel.jitter),
    )
    mu_s, var_s = smoother.predict_var(coeffs, t, yerr**2, y, grid)
    np.testing.assert_allclose(mu, mu_s, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var, var_s, rtol=1e-9, atol=1e-11)
