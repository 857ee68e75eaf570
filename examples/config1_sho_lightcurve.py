#!/usr/bin/env python
"""BASELINE config[1]: SHOTerm fit to a Kepler-like light curve.

The reference 'first' tutorial (docs/tutorials/first.rst) fits a
stochastically-driven damped harmonic oscillator to an irregularly sampled
light curve and draws the conditional prediction; this reproduces that
workflow with the JAX stack (NUTS instead of scipy.optimize).
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np
import jax
import jax.numpy as jnp

from celerite_tpu import GP, terms
from celerite_tpu.inference import sample_nuts, summary
from celerite_tpu.utils import enable_persistent_cache

enable_persistent_cache()  # one-time compiles cache to disk


def simulate_lightcurve(n=700, seed=1):
    """Quasi-periodic stellar variability + gaps, Kepler-ish cadence."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 30, n))
    # observing gaps
    keep = (t % 7.0) < 5.5
    t = t[keep]
    yerr = rng.uniform(0.05, 0.1, len(t))
    gp_sim = GP(
        terms.SHOTerm(log_S0=-0.5, log_Q=1.5, log_omega0=np.log(2.5))
    )
    gp_sim.compute(t, yerr)
    return t, gp_sim.sample(seed=seed), yerr


def main(seed=1):
    t, y, yerr = simulate_lightcurve(seed=seed)
    rng = np.random.default_rng(seed)

    kernel = terms.SHOTerm(log_S0=0.0, log_Q=0.5, log_omega0=0.5)
    gp = GP(kernel)
    gp.compute(t, yerr)
    print("N =", len(t), " initial ll:", gp.log_likelihood(y))

    logprob = gp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * jnp.sum((th / 3.0) ** 2),
    )
    init = jnp.asarray(
        gp.get_parameter_vector()[None, :]
        + 0.05 * rng.standard_normal((4, 3))
    )
    chain, info = sample_nuts(
        logprob, init, jax.random.PRNGKey(seed),
        num_warmup=500, num_samples=500,
    )
    names = ["log_S0", "log_Q", "log_omega0"]
    stats = summary(np.asarray(chain), names=names)
    for i, name in enumerate(names):
        print(
            "{0:10s} mean={1:+.3f} sd={2:.3f} ess={3:6.0f}".format(
                name, stats["mean"][i], stats["sd"][i], stats["ess"][i]
            )
        )

    # Conditional prediction at the posterior mean.
    gp.set_parameter_vector(stats["mean"])
    gp.compute(t, yerr)
    x = np.linspace(t.min(), t.max(), 500)
    mu, var = gp.predict(y, x, return_var=True)
    print(
        "prediction band: mean in [{0:.2f}, {1:.2f}], "
        "median sd {2:.3f}".format(
            mu.min(), mu.max(), float(np.median(np.sqrt(var)))
        )
    )


if __name__ == "__main__":
    main()
