"""Batched light-curve container + masked batched likelihood tests."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from celerite_tpu import GP, terms
from celerite_tpu.data import (
    LightCurveBatch,
    batched_gp_log_likelihood,
    load_lcb,
    save_lcb,
)


def make_ragged(n_curves=5, seed=0):
    rng = np.random.default_rng(seed)
    ts, ys, es = [], [], []
    for i in range(n_curves):
        n = rng.integers(20, 60)
        t = np.sort(rng.uniform(0, 10, n))
        e = rng.uniform(0.1, 0.2, n)
        y = np.sin(t) + e * rng.standard_normal(n)
        ts.append(t)
        ys.append(y)
        es.append(e)
    return ts, ys, es


def test_batch_packing():
    ts, ys, es = make_ragged()
    batch = LightCurveBatch.from_ragged(ts, ys, es)
    assert len(batch) == 5
    nmax = max(len(t) for t in ts)
    assert batch.t.shape == (5, nmax)
    for b, t in enumerate(ts):
        np.testing.assert_array_equal(batch.t[b, : len(t)], t)
        # time padding repeats the final stamp (keeps dt >= 0)
        assert np.all(batch.t[b, len(t):] == t[-1])
        assert np.all(batch.y[b, len(t):] == 0.0)
        assert batch.mask[b].sum() == len(t)


def test_lcb_roundtrip(tmp_path):
    ts, ys, es = make_ragged()
    path = os.path.join(tmp_path, "batch.lcb")
    save_lcb(path, ts, ys, es)
    batch = load_lcb(path)
    ref = LightCurveBatch.from_ragged(ts, ys, es)
    np.testing.assert_array_equal(batch.t, ref.t)
    np.testing.assert_array_equal(batch.y, ref.y)
    np.testing.assert_array_equal(batch.mask, ref.mask)

    rts, rys, res_ = load_lcb(path, batch=False)
    for a, b in zip(rts, ts):
        np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_batched_loglik_matches_per_curve():
    ts, ys, es = make_ragged()
    batch = LightCurveBatch.from_ragged(ts, ys, es)
    kernel = terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
    params = jnp.asarray(kernel.get_parameter_vector())

    lls, oks = batched_gp_log_likelihood(kernel, params, batch)
    assert bool(jnp.all(oks))

    for b in range(len(batch)):
        gp = GP(terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5))
        gp.compute(ts[b], es[b])
        np.testing.assert_allclose(
            float(lls[b]), gp.log_likelihood(ys[b]), rtol=1e-9
        )


def _fleet():
    from celerite_tpu import terms
    from celerite_tpu.data import LightCurveBatch

    rng = np.random.default_rng(3)
    ts, ys, es = [], [], []
    for n in (60, 45, 80):
        t = np.sort(rng.uniform(0, 10, n))
        ts.append(t)
        ys.append(np.sin(t) + 0.1 * rng.standard_normal(n))
        es.append(np.full(n, 0.2))
    batch = LightCurveBatch.from_ragged(ts, ys, es)
    kernel = terms.SHOTerm(log_S0=0.1, log_Q=0.8, log_omega0=0.5)
    return batch, kernel, (ts, ys, es)


def test_make_fleet_loglik_matches_batched():
    """make_fleet_loglik == the vmapped masked-scan batch path == each
    curve's own unpadded likelihood."""
    import jax.numpy as jnp

    from celerite_tpu import GP
    from celerite_tpu.data import (batched_gp_log_likelihood,
                                   make_fleet_loglik)

    batch, kernel, (ts, ys, es) = _fleet()
    theta = jnp.asarray(kernel.get_parameter_vector())
    lls_ref, oks_ref = batched_gp_log_likelihood(kernel, theta, batch)
    lls, oks = make_fleet_loglik(kernel, batch)(theta)
    np.testing.assert_allclose(np.asarray(lls), np.asarray(lls_ref),
                               rtol=1e-12)
    assert bool(np.all(oks))
    for i, (t, y, e) in enumerate(zip(ts, ys, es)):
        gp = GP(kernel)
        gp.compute(t, e)
        np.testing.assert_allclose(float(lls[i]), gp.log_likelihood(y),
                                   rtol=1e-9)


def test_make_fleet_loglik_chains_sum_curves():
    """n_chain > 1: each chain's (ll, ok) is the sum over the fleet of
    its own per-curve likelihoods."""
    import jax.numpy as jnp

    from celerite_tpu.data import (batched_gp_log_likelihood,
                                   make_fleet_loglik)

    batch, kernel, _ = _fleet()
    theta = jnp.asarray(kernel.get_parameter_vector())
    thetas = theta[None, :] + jnp.asarray(
        [[0.0, 0.0, 0.0], [0.1, -0.2, 0.05], [-0.3, 0.1, 0.2]]
    )
    lls, oks = make_fleet_loglik(kernel, batch, n_chain=3)(thetas)
    assert lls.shape == (3,) and bool(np.all(oks))
    for c in range(3):
        per, _ = batched_gp_log_likelihood(kernel, thetas[c], batch)
        np.testing.assert_allclose(float(lls[c]), float(jnp.sum(per)),
                                   rtol=1e-12)
