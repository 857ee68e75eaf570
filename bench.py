#!/usr/bin/env python
"""Headline benchmark: GP log-likelihood evals/s at N = 1e6, J = 2, one GPU.

Goes through the user entry point, ``GP.build_loglik`` with
``solver="auto"``.  Prints the card (``nvidia-smi`` name and power
limit) and the JAX device, then one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline anchor (BASELINE.md): the reference's single-core compute+ll at
J=1-ish SHO class, N=524,288 is 73.8 ms => ~13.5 evals/s.  Scaled linearly to
N = 1e6 that is ~7.1 evals/s; ``vs_baseline`` reports our evals/s over that
reference figure (>1 is better).
"""

import json
import subprocess
import time

import numpy as np


def headline_kernel(p=2):
    """SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5), as one ComplexTerm
    (P=2) or as the SHOTerm itself (padded P=4).

    For Q > 1/2 the SHO is the complex term a = S0 w0 Q, b = a / f,
    c = w0 / (2 Q), d = f c with f = sqrt(4 Q^2 - 1): identical
    covariance, and a c = b d exactly, on the edge of ComplexTerm's
    a c >= b d prior, so log_b is set 1e-9 inside it.
    """
    from celerite_tpu import terms

    if p == 4:
        return terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
    s0, q, w0 = np.exp([0.1, 1.0, 0.5])
    f = np.sqrt(4 * q * q - 1)
    log_a, log_c = np.log(s0 * w0 * q), np.log(w0 / (2 * q))
    log_d = np.log(f) + log_c
    return terms.ComplexTerm(
        log_a=log_a, log_b=log_a + log_c - log_d - 1e-9, log_c=log_c,
        log_d=log_d,
    )


def main():
    import jax
    import jax.numpy as jnp

    from celerite_tpu import GP
    from celerite_tpu.ops import choose_solver
    from celerite_tpu.utils import enable_persistent_cache

    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("bench.py measures a GPU; JAX found {0!r}".format(
            dev.platform))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    print(dev.platform, dev.device_kind, len(jax.devices()))

    n = 1_000_000
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 1000.0, n))
    yerr = np.full(n, 0.1)
    y = rng.standard_normal(n)

    gp = GP(headline_kernel())
    params = jnp.asarray(gp.get_parameter_vector(), jnp.float32)
    ll = jax.jit(gp.build_loglik(t, y, yerr=yerr))

    t0 = time.perf_counter()
    jax.block_until_ready(ll(params))
    compile_s = time.perf_counter() - t0

    # Median of several batches, with the spread.
    n_iter = 20
    batch_rates = []
    for _ in range(9):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = ll(params)
        jax.block_until_ready(out)
        batch_rates.append(n_iter / (time.perf_counter() - t0))
    rates = np.sort(np.asarray(batch_rates))

    evals_per_s = float(np.median(rates))
    # Reference: 73.8 ms at N=524288 -> scaled to N=1e6 single core.
    ref_evals_per_s = 1.0 / (73.8e-3 * (n / 524288))
    print(
        json.dumps(
            {
                "metric": "gp_loglik_evals_per_s_N1e6_J2_per_chip",
                "value": evals_per_s,
                "unit": "evals/s",
                "vs_baseline": evals_per_s / ref_evals_per_s,
                "route": choose_solver(n, 2),
                "compile_s": compile_s,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "spread": {
                    "n_batches": len(batch_rates),
                    "iters_per_batch": n_iter,
                    "p10": float(np.percentile(rates, 10)),
                    "p90": float(np.percentile(rates, 90)),
                    "best": float(rates[-1]),
                    "worst": float(rates[0]),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
