"""Sampler validation: analytic targets + GP posterior recovery.

Pattern per SURVEY.md section 4.3: posterior-moment checks within MC error
(no reference precedent — the reference delegates MCMC to emcee).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from celerite_tpu import GP, terms
from celerite_tpu.inference import (
    fit_advi,
    laplace_fit,
    sample_nuts,
    sample_smc,
)
from celerite_tpu.inference.hmc import hmc_kernel


COV = np.array([[2.0, 1.2], [1.2, 1.5]])
MU = np.array([1.0, -2.0])
PREC = np.linalg.inv(COV)


def gauss_logprob(x):
    d = x - jnp.asarray(MU)
    return -0.5 * d @ jnp.asarray(PREC) @ d


def test_nuts_gaussian_moments():
    init = jnp.asarray(
        np.random.default_rng(0).standard_normal((4, 2))
    )
    chain, info = sample_nuts(
        gauss_logprob,
        init,
        jax.random.PRNGKey(0),
        num_warmup=400,
        num_samples=600,
    )
    s = np.asarray(chain).reshape(-1, 2)
    se = np.sqrt(np.diag(COV) / (len(s) / 10))  # ~conservative MC error
    np.testing.assert_allclose(s.mean(0), MU, atol=float(4 * se.max()))
    np.testing.assert_allclose(
        np.cov(s.T), COV, rtol=0.25, atol=0.15
    )
    assert float(info["divergences"]) == 0
    assert 0.6 < float(info["accept_prob"]) < 0.99


def test_nuts_dense_mass_correlated_gaussian():
    """Dense metric on an ill-conditioned correlated Gaussian: correct
    moments with a small fraction of the diagonal-metric leapfrogs."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((5, 5))
    cov = A @ A.T + 0.01 * np.eye(5)
    w, V = np.linalg.eigh(cov)
    w[0] *= 1e-3  # condition number ~ 1e4
    cov = (V * w) @ V.T
    prec = jnp.asarray(np.linalg.inv(cov))

    def logprob(th):
        return -0.5 * th @ (prec @ th)

    init = jnp.asarray(rng.standard_normal((4, 5)) * 0.1)
    results = {}
    for dm in (False, True):
        chain, info = sample_nuts(
            logprob, init, jax.random.PRNGKey(1),
            num_warmup=500, num_samples=500, dense_mass=dm,
        )
        samp = np.asarray(chain).reshape(-1, 5)
        emp = np.cov(samp.T)
        err = np.linalg.norm(emp - cov) / np.linalg.norm(cov)
        assert err < 0.15, (dm, err)
        results[dm] = int(info["num_steps"])
    # The whole point of the dense metric: far fewer leapfrogs.
    assert results[True] * 10 < results[False], results
    # Dense path reports a (dim, dim) inverse mass.
    assert info["inv_mass"].shape == (5, 5)


def test_hmc_gaussian_moments():
    key = jax.random.PRNGKey(1)

    def run_chain(q0, key):
        def step(carry, k):
            q = carry
            q, info = hmc_kernel(
                gauss_logprob, q, k, 0.5, jnp.ones(2), num_leapfrog=8
            )
            return q, q

        _, qs = jax.lax.scan(step, q0, jax.random.split(key, 800))
        return qs

    q0s = jnp.asarray(np.random.default_rng(1).standard_normal((4, 2)))
    qs = jax.vmap(run_chain)(q0s, jax.random.split(key, 4))
    s = np.asarray(qs[:, 200:]).reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), MU, atol=0.3)
    np.testing.assert_allclose(np.cov(s.T), COV, rtol=0.3, atol=0.2)


def test_advi_gaussian():
    res = fit_advi(
        gauss_logprob,
        jnp.zeros(2),
        jax.random.PRNGKey(2),
        num_steps=1500,
        num_mc=8,
        learning_rate=5e-2,
    )
    np.testing.assert_allclose(np.asarray(res.mu), MU, atol=0.15)
    # mean-field sigma ~ 1/sqrt(diag(precision))
    target = 1.0 / np.sqrt(np.diag(PREC))
    np.testing.assert_allclose(np.asarray(res.sigma), target, rtol=0.25)
    # ELBO should have improved substantially
    elbo = np.asarray(res.elbo_trace)
    assert elbo[-100:].mean() > elbo[:100].mean()


def test_laplace_gaussian():
    mode, cov = laplace_fit(
        gauss_logprob, jnp.zeros(2), num_steps=3000, learning_rate=5e-2
    )
    np.testing.assert_allclose(np.asarray(mode), MU, atol=0.05)
    np.testing.assert_allclose(np.asarray(cov), COV, rtol=0.05, atol=0.05)


def test_smc_gaussian():
    rng = np.random.default_rng(3)
    init = jnp.asarray(rng.standard_normal((512, 2)) * 3.0)

    def log_prior(x):
        return -0.5 * jnp.sum(x**2) / 25.0  # wide prior

    res = sample_smc(
        log_prior,
        gauss_logprob,
        init,
        jax.random.PRNGKey(3),
        num_mutations=4,
        hmc_step_size=0.5,
    )
    s = np.asarray(res.particles)
    np.testing.assert_allclose(s.mean(0), MU, atol=0.35)
    assert int(res.num_stages) >= 1


def test_smc_bimodal():
    """SMC must populate both modes of a well-separated mixture."""
    rng = np.random.default_rng(4)
    init = jnp.asarray(rng.standard_normal((1024, 1)) * 6.0)
    centers = jnp.asarray([-4.0, 4.0])

    def log_like(x):
        return jax.nn.logsumexp(-0.5 * (x[0] - centers) ** 2 / 0.25)

    def log_prior(x):
        return -0.5 * jnp.sum(x**2) / 36.0

    res = sample_smc(
        log_prior,
        log_like,
        init,
        jax.random.PRNGKey(4),
        num_mutations=5,
        hmc_step_size=0.3,
    )
    s = np.asarray(res.particles)[:, 0]
    frac_left = np.mean(s < 0)
    assert 0.2 < frac_left < 0.8  # both modes survive


@pytest.mark.slow
def test_nuts_gp_posterior_recovery():
    """configs[0]-style: RealTerm GP hyperparameter fit on simulated data.

    The NUTS posterior must cover the true parameters and its moments must
    agree with a Laplace approximation of the same (exact, oracle-verified)
    log-posterior within MC error.
    """
    rng = np.random.default_rng(42)
    n = 128
    t = np.sort(rng.uniform(0, 20, n))
    yerr = np.full(n, 0.3)
    ktrue = terms.RealTerm(log_a=0.5, log_c=-0.5)
    gp_sim = GP(ktrue)
    gp_sim.compute(t, yerr)
    y = gp_sim.sample(seed=7)

    gp = GP(terms.RealTerm(log_a=0.0, log_c=0.0))
    gp.compute(t, yerr)

    # Smooth Gaussian prior: the RealTerm posterior has a long ridge and a
    # hard -inf box wall would (correctly) register as divergences when the
    # ridge reaches it; a smooth prior keeps the geometry NUTS-friendly.
    def log_prior(theta):
        return -0.5 * jnp.sum((theta / 2.0) ** 2)

    logprob = gp.build_logprob(t, y, yerr=yerr, log_prior=log_prior)

    init = jnp.asarray(
        gp.get_parameter_vector()[None, :]
        + 0.1 * rng.standard_normal((4, 2))
    )
    chain, info = sample_nuts(
        logprob,
        init,
        jax.random.PRNGKey(5),
        num_warmup=300,
        num_samples=300,
        max_tree_depth=8,
        target_accept=0.9,
    )
    s = np.asarray(chain).reshape(-1, 2)
    # The log_a/log_c posterior has steep cliffs toward the prior box; a
    # small residual divergence rate is geometry, not a sampler bug.
    assert float(info["divergences"]) < 0.02 * s.shape[0]

    mode, cov = laplace_fit(
        logprob, jnp.asarray([0.3, -0.3]), num_steps=2000,
        learning_rate=2e-2,
    )
    # Posterior mean agrees with the Laplace mode within a few SDs of the
    # Laplace covariance (the posterior is mildly skewed).
    sd = np.sqrt(np.diag(np.asarray(cov)))
    np.testing.assert_allclose(
        s.mean(0), np.asarray(mode), atol=float(3 * sd.max())
    )
    np.testing.assert_allclose(
        s.std(0), sd, rtol=0.5
    )
    # True parameters are inside the 4-sigma posterior box.
    assert np.all(np.abs(s.mean(0) - [0.5, -0.5]) < 4 * s.std(0))


def test_sample_nuts_batch():
    from celerite_tpu.inference.nuts import sample_nuts_batch

    mus = jnp.asarray([[0.0, 0.0], [3.0, -1.0], [-2.0, 2.0]])

    def logprob(mu, th):
        return -0.5 * jnp.sum((th - mu) ** 2)

    rng = np.random.default_rng(0)
    init = jnp.asarray(rng.standard_normal((3, 4, 2)))
    chains, infos = sample_nuts_batch(
        logprob, mus, init, jax.random.PRNGKey(0),
        num_warmup=150, num_samples=150,
    )
    assert chains.shape == (3, 4, 150, 2)
    means = np.asarray(chains).reshape(3, -1, 2).mean(1)
    np.testing.assert_allclose(means, np.asarray(mus), atol=0.25)


def test_map_fit_improves_ll():
    from celerite_tpu.inference.optimize import map_fit

    rng = np.random.default_rng(11)
    t = np.sort(rng.uniform(0, 20, 150))
    yerr = np.full(150, 0.3)
    gp_sim = GP(terms.RealTerm(log_a=0.5, log_c=-0.5))
    gp_sim.compute(t, yerr)
    y = gp_sim.sample(seed=2)

    gp = GP(terms.RealTerm(log_a=-0.5, log_c=0.5))
    gp.compute(t, yerr)
    ll0 = gp.log_likelihood(y)
    params, trace = map_fit(
        gp, t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * jnp.sum((th / 3.0) ** 2),
        num_steps=800,
    )
    gp.compute(t, yerr)
    ll1 = gp.log_likelihood(y)
    assert ll1 >= ll0
    # the optimizer should have converged to a stationary point
    logprob = gp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * jnp.sum((th / 3.0) ** 2),
    )
    g = jax.grad(logprob)(jnp.asarray(params))
    assert np.all(np.abs(np.asarray(g)) < 0.5)


@pytest.mark.slow
def test_sample_nuts_chunked_identical():
    """Host-chunked execution must reproduce the single-launch run."""
    init = jnp.asarray(
        np.random.default_rng(0).standard_normal((4, 2))
    )
    c1, i1 = sample_nuts(
        gauss_logprob, init, jax.random.PRNGKey(0),
        num_warmup=120, num_samples=120,
    )
    c2, i2 = sample_nuts(
        gauss_logprob, init, jax.random.PRNGKey(0),
        num_warmup=120, num_samples=120, chunk_size=50,
    )
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    np.testing.assert_allclose(
        float(i1["accept_prob"]), float(i2["accept_prob"]), rtol=1e-12
    )


def test_smc_host_loop_matches():
    rng = np.random.default_rng(3)
    init = jnp.asarray(rng.standard_normal((256, 2)) * 3.0)

    def log_prior(x):
        return -0.5 * jnp.sum(x**2) / 25.0

    kw = dict(num_mutations=3, hmc_step_size=0.5)
    r1 = sample_smc(log_prior, gauss_logprob, init,
                    jax.random.PRNGKey(3), **kw)
    r2 = sample_smc(log_prior, gauss_logprob, init,
                    jax.random.PRNGKey(3), host_loop=True, **kw)
    np.testing.assert_allclose(
        np.asarray(r1.particles), np.asarray(r2.particles), atol=1e-10
    )
    assert int(r1.num_stages) == int(r2.num_stages)


@pytest.mark.slow
def test_sample_nuts_batch_chunked():
    """chunk_size composes with batching (VERDICT r1 weak item 4)."""
    from celerite_tpu.inference.nuts import sample_nuts_batch

    mus = jnp.asarray([[0.0, 0.0], [3.0, -1.0], [-2.0, 2.0]])

    def logprob(mu, th):
        return -0.5 * jnp.sum((th - mu) ** 2)

    rng = np.random.default_rng(0)
    init = jnp.asarray(rng.standard_normal((3, 4, 2)))
    chains, infos = sample_nuts_batch(
        logprob, mus, init, jax.random.PRNGKey(0),
        num_warmup=150, num_samples=150, chunk_size=40,
    )
    assert chains.shape == (3, 4, 150, 2)
    assert infos["step_size"].shape == (3,)
    means = np.asarray(chains).reshape(3, -1, 2).mean(1)
    np.testing.assert_allclose(means, np.asarray(mus), atol=0.25)


def test_find_reasonable_step_size():
    """HG14 alg. 4: the found eps gives a one-step accept ratio near 1/2
    (within the doubling bracket) on a unit gaussian."""
    import jax
    import jax.numpy as jnp
    from celerite_tpu.inference.nuts import find_reasonable_step_size

    def logprob(th):
        return -0.5 * jnp.sum(th**2)

    q = jnp.asarray([0.3, -1.2, 0.7])
    eps = float(find_reasonable_step_size(
        logprob, q, jax.random.PRNGKey(0)))
    assert 1e-3 < eps < 1e3
    # bracket property: accept(eps) <= 1/2 <= accept(eps / 2) up to the
    # factor-of-two search resolution (or the mirrored version).
    def accept(e):
        from celerite_tpu.inference.nuts import _leapfrog
        g = lambda x: (x, -0.5 * jnp.sum(x**2))
        p0 = jax.random.normal(jax.random.PRNGKey(0), q.shape)
        h0 = 0.5 * jnp.sum(q**2) + 0.5 * jnp.sum(p0**2)
        qn, pn, _, _ = _leapfrog(g, q, p0, q, e, jnp.ones_like(q))
        h1 = 0.5 * jnp.sum(qn**2) + 0.5 * jnp.sum(pn**2)
        return float(jnp.exp(jnp.minimum(0.0, h0 - h1)))
    a1, a2 = accept(eps), accept(eps / 2.0)
    assert (a1 <= 0.55 <= a2 + 0.1) or (a2 <= 0.55 <= a1 + 0.1)


def test_sample_nuts_auto_step_size():
    import jax
    import jax.numpy as jnp
    from celerite_tpu.inference import sample_nuts

    def logprob(th):
        return -0.5 * jnp.sum(th**2 / jnp.asarray([1.0, 4.0]))

    init = jnp.asarray([[0.1, -0.2], [0.5, 0.3]])
    chain, info = sample_nuts(
        logprob, init, jax.random.PRNGKey(1), num_warmup=150,
        num_samples=150, initial_step_size="auto", max_tree_depth=6,
    )
    sd = np.asarray(chain).reshape(-1, 2).std(0)
    np.testing.assert_allclose(sd, [1.0, 2.0], rtol=0.25)


def test_nuts_warmup_depth_cap():
    # Capping tree depth during warmup must leave sampling statistically
    # sound: moments still recover and post-warmup transitions use the
    # full depth.
    init = jnp.asarray(
        np.random.default_rng(3).standard_normal((4, 2))
    )
    chain, info = sample_nuts(
        gauss_logprob,
        init,
        jax.random.PRNGKey(7),
        num_warmup=400,
        num_samples=600,
        max_tree_depth=10,
        warmup_max_tree_depth=5,
    )
    s = np.asarray(chain).reshape(-1, 2)
    se = np.sqrt(np.diag(COV) / (len(s) / 10))
    np.testing.assert_allclose(s.mean(0), MU, atol=float(4 * se.max()))
    assert float(info["divergences"]) == 0
    assert 0.6 < float(info["accept_prob"]) < 0.99


def test_nuts_energy_is_hamiltonian():
    """info["energy"] holds the true Hamiltonian H = -logp + kinetic at
    the accepted point (not logp): for this unnormalized 2-D gaussian,
    E[H] = E[potential] + E[kinetic] = dim/2 + dim/2 = 2, and E-BFMI of a
    well-mixing gaussian chain is ~1."""
    from celerite_tpu.inference.diagnostics import ebfmi

    init = jnp.asarray(
        np.random.default_rng(5).standard_normal((4, 2))
    )
    chain, info = sample_nuts(
        gauss_logprob,
        init,
        jax.random.PRNGKey(11),
        num_warmup=300,
        num_samples=500,
    )
    e = np.asarray(info["energy"])
    assert e.shape == (4, 500)
    assert np.all(np.isfinite(e))
    # H >= potential at the same point; potential >= 0 for this target,
    # so energies must be nonnegative (logp_prop would go negative half
    # the time only if it were mislabeled... it is always >= 0 here).
    assert e.min() >= 0.0
    assert abs(e.mean() - 2.0) < 0.5
    bf = ebfmi(e)
    assert bf.shape == (4,)
    assert np.all(bf > 0.4)


def test_nuts_kernel_energy_logp_consistent():
    """Kernel-level: info.logp equals logprob(q_new) and the energy
    exceeds the potential by the (nonnegative) kinetic term."""
    from celerite_tpu.inference.nuts import nuts_kernel

    q = jnp.asarray([0.3, -0.7])
    qn, info = jax.jit(
        lambda q, k: nuts_kernel(
            gauss_logprob, q, k, 0.4, jnp.ones(2)
        )
    )(q, jax.random.PRNGKey(3))
    np.testing.assert_allclose(
        float(info.logp), float(gauss_logprob(qn)), rtol=1e-10
    )
    assert float(info.energy) >= -float(info.logp) - 1e-12


def test_hmc_kernel_energy_logp_consistent():
    q = jnp.asarray([0.5, 0.1])
    qn, info = jax.jit(
        lambda q, k: hmc_kernel(
            gauss_logprob, q, k, 0.3, jnp.ones(2), num_leapfrog=8
        )
    )(q, jax.random.PRNGKey(4))
    np.testing.assert_allclose(
        float(info.logp), float(gauss_logprob(qn)), rtol=1e-10
    )
    assert float(info.energy) >= -float(info.logp) - 1e-12


def _attach_vag(f):
    """A copy of f carrying value_and_grad (the fused-kernel protocol)."""
    g = lambda x: f(x)
    g.value_and_grad = jax.value_and_grad(f)
    return g


def test_advi_fused_path_matches_ad():
    """fit_advi's closed-form reparameterization gradient over the fused
    value_and_grad path must match AD through the vmapped closure,
    including the clamped non-finite draws."""

    def lp(x):
        # -inf outside a box exercises the clamping equality.
        inside = jnp.all(jnp.abs(x) < 2.5)
        return jnp.where(inside, gauss_logprob(x), -jnp.inf)

    key = jax.random.PRNGKey(0)
    r1 = fit_advi(lp, jnp.zeros(2), key, num_steps=120, num_mc=4)
    r2 = fit_advi(_attach_vag(lp), jnp.zeros(2), key,
                  num_steps=120, num_mc=4)
    np.testing.assert_allclose(
        np.asarray(r1.elbo_trace), np.asarray(r2.elbo_trace), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(r1.mu), np.asarray(r2.mu), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(r1.sigma), np.asarray(r2.sigma), rtol=1e-8
    )


def test_laplace_fused_path_matches_ad():
    from celerite_tpu.inference import laplace_fit

    m1, c1 = laplace_fit(gauss_logprob, jnp.zeros(2), num_steps=300)
    m2, c2 = laplace_fit(
        _attach_vag(gauss_logprob), jnp.zeros(2), num_steps=300
    )
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), atol=1e-10)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), atol=1e-10)


def test_smc_fused_path_matches_ad():
    """The tempered closure's fused value_and_grad (sum-of-vags) must
    reproduce AD-through-the-sum mutation for mutation."""

    def log_prior(x):
        return -0.5 * jnp.sum(x**2) / 25.0

    key = jax.random.PRNGKey(5)
    init = jnp.asarray(
        np.random.default_rng(2).standard_normal((128, 2))
    ) * 5.0
    r1 = sample_smc(log_prior, gauss_logprob, init, key)
    r2 = sample_smc(
        _attach_vag(log_prior), _attach_vag(gauss_logprob), init, key
    )
    p1, p2 = np.asarray(r1.particles), np.asarray(r2.particles)
    assert int(r1.num_stages) == int(r2.num_stages)
    np.testing.assert_allclose(
        float(r1.log_evidence), float(r2.log_evidence), rtol=1e-6
    )
    np.testing.assert_allclose(p1.mean(0), p2.mean(0), atol=0.3)
    np.testing.assert_allclose(
        np.cov(p1.T), np.cov(p2.T), rtol=0.4, atol=0.3
    )


def test_advi_gp_fused_closure():
    """End-to-end: a GP build_logprob closure carrying a one-pass
    value_and_grad (``fast_grad=True``: the blocked solver's AD, as on
    the fused route) optimizes through fit_advi's folded branch."""
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 10, 256))
    yerr = 0.1 * np.ones_like(t)
    gp = GP(terms.SHOTerm(log_S0=0.0, log_Q=0.5, log_omega0=0.5))
    gp.compute(t, yerr)
    y = np.asarray(gp.sample(seed=3))
    lp = gp.build_logprob(t, y, yerr, solver="blocked", fast_grad=True)
    assert hasattr(lp, "value_and_grad")
    res = fit_advi(
        lp, jnp.asarray(gp.get_parameter_vector()),
        jax.random.PRNGKey(0), num_steps=200, num_mc=4,
    )
    elbo = np.asarray(res.elbo_trace)
    assert np.isfinite(elbo[-10:]).all()
    assert elbo[-10:].mean() > elbo[:10].mean()


def test_nuts_progress_metrics():
    """Live metrics (SURVEY.md 5.5): chunked runs emit per-chunk records
    with throughput/acceptance/divergence fields, without perturbing
    results."""
    init = jnp.asarray(
        np.random.default_rng(9).standard_normal((4, 2))
    )
    lines = []
    chain, _ = sample_nuts(
        gauss_logprob, init, jax.random.PRNGKey(2), num_warmup=60,
        num_samples=60, chunk_size=30, progress=lines.append,
    )
    chain2, _ = sample_nuts(
        gauss_logprob, init, jax.random.PRNGKey(2), num_warmup=60,
        num_samples=60, chunk_size=30,
    )
    np.testing.assert_array_equal(np.asarray(chain), np.asarray(chain2))
    phases = [r["phase"] for r in lines]
    assert phases == ["warmup", "warmup", "sample", "sample"]
    assert all("accept" in r for r in lines)
    assert all("samples/s" in r for r in lines if r["phase"] == "sample")
    assert all("step_size" in r for r in lines if r["phase"] == "warmup")


def test_sample_nuts_no_retrace_on_repeat_call():
    """Repeated sample_nuts calls with the same held logprob object reuse
    the cached jitted segments instead of re-tracing/re-compiling
    (ROADMAP: long-lived services re-jitted per call)."""
    traces = {"n": 0}

    def lp(x):
        traces["n"] += 1
        d = x - jnp.asarray(MU)
        return -0.5 * d @ jnp.asarray(PREC) @ d

    init = jnp.asarray(
        np.random.default_rng(3).standard_normal((2, 2))
    )
    chain1, _ = sample_nuts(
        lp, init, jax.random.PRNGKey(0), num_warmup=20, num_samples=20
    )
    n_first = traces["n"]
    assert n_first > 0
    chain2, _ = sample_nuts(
        lp, init, jax.random.PRNGKey(7), num_warmup=20, num_samples=20
    )
    assert traces["n"] == n_first  # no re-trace on the second call
    # Different static config still works (fresh cache entry).
    sample_nuts(
        lp, init, jax.random.PRNGKey(1), num_warmup=20, num_samples=20,
        max_tree_depth=6,
    )
    assert traces["n"] > n_first
