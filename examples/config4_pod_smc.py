#!/usr/bin/env python
"""BASELINE config[4]: pod-scale batch — many light curves, sharded SMC.

Builds a batch of light curves (the .lcb container + masked batched
likelihood), then runs adaptive-tempering SMC with particles sharded over
the device mesh on a deliberately multimodal QPO posterior (the oscillator
frequency is ambiguous between omega and a harmonic).

Run with a virtual mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/config4_pod_smc.py

This example is the runnable small-scale tour.  The full-size config[4]
rig is benchmarks/fleet_smc.py: >= 10,240 ragged curves, an
exactly-aliased bimodal frequency posterior (regular cadence, prior
symmetric about pi — true mode weights 0.5/0.5 by construction), and
``sample_smc_sharded`` with ``host_loop=True`` + ``particle_chunk`` for
fleet-scale memory.  Scale this example up with
``--curves 10240 --particles 512`` to approach that regime.
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
from celerite_tpu.data import LightCurveBatch, batched_gp_log_likelihood
from celerite_tpu.parallel import mesh as mesh_lib
from celerite_tpu.parallel.sharded import sample_smc_sharded
from celerite_tpu.utils import enable_persistent_cache

enable_persistent_cache()  # one-time compiles cache to disk


def make_batch(n_curves=32, seed=4):
    """Scale n_curves to 10k+ for the pod-scale configuration; the default
    is sized so the example also runs on a CPU mesh in a few minutes."""
    rng = np.random.default_rng(seed)
    ts, ys, es = [], [], []
    gp_sim = GP(
        terms.SHOTerm(log_S0=0.0, log_Q=2.0, log_omega0=np.log(3.0))
    )
    for i in range(n_curves):
        n = int(rng.integers(100, 160))
        t = np.sort(rng.uniform(0, 20, n))
        e = rng.uniform(0.1, 0.2, n)
        gp_sim.compute(t, e)
        ts.append(t)
        ys.append(gp_sim.sample(seed=seed + i))
        es.append(e)
    return LightCurveBatch.from_ragged(ts, ys, es)


def main(n_particles=512, seed=4, n_curves=32):
    batch = make_batch(n_curves)
    kernel = terms.SHOTerm(log_S0=0.0, log_Q=1.0, log_omega0=1.0)

    # Each particle's likelihood is the masked, vmapped scan over the
    # fleet (data.batched_gp_log_likelihood).
    def log_like(theta):
        lls, oks = batched_gp_log_likelihood(kernel, theta, batch)
        total = jnp.sum(jnp.where(oks, lls, -jnp.inf))
        return jnp.where(jnp.isfinite(total), total, -1e12)

    def log_prior(theta):
        return -0.5 * jnp.sum((theta / 2.0) ** 2)

    rng = np.random.default_rng(seed)
    init = jnp.asarray(rng.standard_normal((n_particles, 3)) * 1.0)
    mesh = mesh_lib.make_mesh()
    print(
        "devices: {0}, particles: {1}, curves: {2}".format(
            mesh.devices.size, n_particles, len(batch)
        )
    )
    res = sample_smc_sharded(
        log_prior, log_like, init, jax.random.PRNGKey(seed),
        mesh=mesh, num_mutations=3, hmc_step_size=0.05,
    )
    parts = np.asarray(res.particles)
    print(
        "stages: {0}  log-evidence: {1:.1f}  accept: {2:.2f}".format(
            int(res.num_stages), float(res.log_evidence),
            float(res.final_accept),
        )
    )
    print(
        "posterior: log_S0 {0:+.2f}+-{1:.2f}  log_Q {2:+.2f}+-{3:.2f}  "
        "log_w0 {4:+.2f}+-{5:.2f} (truth 0.00, 2.00, {6:.2f})".format(
            parts[:, 0].mean(), parts[:, 0].std(),
            parts[:, 1].mean(), parts[:, 1].std(),
            parts[:, 2].mean(), parts[:, 2].std(), np.log(3.0),
        )
    )


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--curves", type=int, default=32,
                    help="fleet size (scale to 4096+ on a chip; "
                         "benchmarks/fleet.py measures that regime)")
    ap.add_argument("--seed", type=int, default=4)
    a = ap.parse_args()
    main(n_particles=a.particles, seed=a.seed, n_curves=a.curves)
