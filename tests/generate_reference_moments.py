#!/usr/bin/env python
"""Generate the pinned reference posterior moments for the parity tests.

Runs the reference pipeline — the Goodman-Weare stretch-move ensemble
sampler (the emcee algorithm, docs/tutorials/modeling.rst:227-246 of the
reference) over the dense float64 log-posterior (which the reference
solver matches to ~1e-15, paper/ms.tex:958-968) — on the BASELINE
config[0]/[1] datasets, and prints the moment constants to paste into
tests/test_parity_posterior.py.

Pure NumPy; no celerite_tpu imports.  Walker evaluations fan out over a
multiprocessing pool (results identical to serial — all randomness is
drawn before the evaluations).  Run with single-threaded BLAS:

  OMP_NUM_THREADS=1 OPENBLAS_NUM_THREADS=1 \\
      python tests/generate_reference_moments.py
"""

import multiprocessing as mp
import sys

import numpy as np

import parity_common as pc

_LOGPOST = None


def _eval(p):
    return _LOGPOST(p)


def ensemble_moments(name, make, n_walkers=32, n_steps=1500, burn=300,
                     seed=123, procs=4):
    global _LOGPOST
    t, yerr, y, logpost, names, truth = make()
    _LOGPOST = logpost
    rng = np.random.default_rng(seed)
    p0 = truth[None, :] + 0.1 * rng.standard_normal(
        (n_walkers, len(truth))
    )
    with mp.Pool(procs) as pool:
        chain = pc.stretch_sample(
            logpost, p0, n_steps, rng,
            map_fn=lambda ps: np.asarray(pool.map(_eval, list(ps))),
        )
    flat = chain[burn:].reshape(-1, len(truth))

    mean = flat.mean(axis=0)
    sd = flat.std(axis=0)
    # Integrated autocorrelation per dim from the walker-averaged chain.
    wmean = chain[burn:].mean(axis=1)
    se = []
    for k in range(len(truth)):
        x = wmean[:, k] - wmean[:, k].mean()
        acf = np.correlate(x, x, mode="full")[len(x) - 1:]
        acf /= acf[0]
        tau = 1.0 + 2.0 * np.sum(acf[1:50])
        tau = max(tau, 1.0)
        se.append(wmean[:, k].std() * np.sqrt(tau / len(wmean)))
    se = np.asarray(se)

    print(f"# {name}: {n_walkers} walkers x {n_steps} steps "
          f"(burn {burn}), seed {seed}")
    print(f"{name}_MEAN = {mean.tolist()!r}")
    print(f"{name}_SD = {sd.tolist()!r}")
    print(f"{name}_SE = {se.tolist()!r}  # MC standard error of the mean")
    print(f"# truth: {truth.tolist()!r}  names: {names}")
    sys.stdout.flush()
    return mean, sd, se


if __name__ == "__main__":
    which = sys.argv[1:] or ["0", "1", "2", "3"]
    if "0" in which:
        ensemble_moments("CONFIG0", pc.make_config0)
    if "1" in which:
        ensemble_moments("CONFIG1", pc.make_config1)
    if "2" in which:
        # 7-dim mixture posterior: more walkers + steps for stable tails.
        ensemble_moments(
            "CONFIG2", pc.make_config2, n_walkers=40, n_steps=2000,
            burn=400, procs=4,
        )
    if "3" in which:
        ensemble_moments(
            "CONFIG3", pc.make_config3, n_walkers=32, n_steps=2000,
            burn=400, procs=4,
        )
