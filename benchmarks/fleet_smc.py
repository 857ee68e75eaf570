#!/usr/bin/env python
"""BENCH config[4] at scale: 10k-curve fleet, sharded SMC, bimodal QPO.

The population model is a damped oscillator (3-parameter ComplexTerm,
``k = a e^{-c tau} cos(d tau)``) observed on a REGULAR cadence
(Delta = 1).  Sampling on a grid aliases the frequency exactly:
``cos(d k Delta) == cos((2 pi / Delta - d) k Delta)``, so the fleet
likelihood is *identical* at ``d`` and ``2 pi - d`` — a genuinely
bimodal posterior whose two modes no amount of data can separate.
Tempered SMC with global systematic resampling must keep BOTH modes
populated; a sampler that collapses into one mode fails the weight
assertion.

The sampled parameterization is ``theta = (log_a, log_c, d)`` with a
prior on ``d`` symmetric about pi, making the posterior EXACTLY
mirror-symmetric: true mode weights are 0.5/0.5 by construction, so
any collapse is a sampler artifact — the cleanest possible probe of
mode preservation through sharded resampling.  (Round-5 finding,
kept as a negative control: in the naive ``log d`` parameterization
the Jacobian gives the low-frequency basin 2.14x the mass and 4.6x
the width; the width mismatch makes global-cloud-metric HMC mutations
under-mix the narrow basin, and its weight leaks monotonically —
measured 0.21 -> 0.07 over the last five tempering stages even with
target_ess_frac = 0.85.  That run conflates genuine asymmetric mass
with sampler leakage; the symmetric parameterization separates them.)

This is the rig for BASELINE configs[4] at fleet scale: >= 10k ragged
curves through the vmapped masked likelihood
(data.batched_gp_log_likelihood), ``sample_smc_sharded`` over the device
mesh, mode weights + curves/s + stage count recorded to a JSON file
(``--out``).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


D_TRUE = 2.0
D_ALIAS = 2.0 * np.pi - D_TRUE  # cadence Delta = 1


def make_batch(n_curves, seed=4):
    """Regular-cadence fleet from the damped-oscillator prior."""
    import jax.numpy as jnp

    from celerite_tpu.data import LightCurveBatch
    from celerite_tpu.ops.lower import Coefficients
    from celerite_tpu.ops.smoother import sample_prior

    import jax

    rng = np.random.default_rng(seed)
    coeffs = Coefficients(
        a_real=np.zeros(0), c_real=np.zeros(0),
        a_comp=np.array([0.8]), b_comp=np.array([0.0]),
        c_comp=np.array([0.25]), d_comp=np.array([D_TRUE]),
        jitter=np.zeros(()),
    )
    ts, ys, es = [], [], []
    lengths = rng.integers(96, 161, n_curves)
    # Prior draws run on the host CPU backend: one draw per curve
    # through a remote accelerator costs ~70 ms of round trips each
    # (measured: 705 s for 10k curves); eager CPU is ~ms.
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        for i, n in enumerate(lengths):
            t = np.arange(n, dtype=float)  # Delta = 1: exact aliasing
            e = np.full(n, 0.3)
            y = np.asarray(sample_prior(coeffs, t, seed=seed + i))
            y = y + e * rng.standard_normal(n)
            ts.append(t)
            ys.append(y)
            es.append(e)
    return LightCurveBatch.from_ragged(ts, ys, es)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--curves", type=int, default=10240)
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--mutations", type=int, default=3)
    ap.add_argument("--ess-frac", type=float, default=0.5,
                    help="tempering target ESS fraction; higher = "
                         "gentler beta schedule (mode survival)")
    ap.add_argument("--leapfrogs", type=int, default=8)
    ap.add_argument("--step", type=float, default=0.3,
                    help="base HMC step in metric units (the folded "
                         "within-mode variance metric makes ~0.3 a "
                         "4-sigma trajectory at 8 leapfrogs)")
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16,
                    help="particles per sequential slab (bounds the "
                         "memory of the fleet gradient's saved residuals)")
    ap.add_argument("--out", type=str,
                    default="benchmarks/results/fleet_smc_gpu.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from celerite_tpu import terms
    from celerite_tpu.data import batched_gp_log_likelihood
    from celerite_tpu.parallel import mesh as mesh_lib
    from celerite_tpu.parallel.sharded import sample_smc_sharded
    from celerite_tpu.utils import enable_persistent_cache

    enable_persistent_cache()

    t0 = time.perf_counter()
    batch = make_batch(args.curves, args.seed)
    t_data = time.perf_counter() - t0
    kernel = terms.ComplexTerm(log_a=0.0, log_c=-1.0, log_d=0.5)

    def per_curve(theta):
        return batched_gp_log_likelihood(kernel, theta, batch)

    # Parameterization: theta = (log_a, log_c, d) with the frequency
    # LINEAR and the prior symmetric about pi.  In log_d the posterior
    # is bimodal but ASYMMETRIC — the Jacobian gives the d_true basin
    # 2.14x the mass and 4.6x the width, and the width mismatch makes
    # global-metric HMC mutations systematically under-mix the narrow
    # alias basin, leaking its weight stage over stage (measured:
    # 0.21 -> 0.07 over the last 5 stages on the CPU diagnostic).  In
    # d the two basins are EXACT mirror images (cos(d k) == cos((2pi -
    # d) k) on the integer cadence) and the prior N(pi, 2) is even
    # about the reflection point, so the true mode weights are exactly
    # 0.5/0.5 — any collapse is a sampler artifact by construction,
    # which is precisely what this benchmark exists to detect.
    def to_model(theta):
        d = jnp.abs(theta[..., 2]) + 1e-12
        return jnp.stack(
            [theta[..., 0], theta[..., 1], jnp.log(d)], axis=-1
        )

    def log_like(theta):
        lls, oks = per_curve(to_model(theta))
        total = jnp.sum(jnp.where(oks, lls, -jnp.inf))
        return jnp.where(jnp.isfinite(total), total, -1e12)

    PI = float(np.pi)

    def log_prior(theta):
        return -0.5 * (
            (theta[0] / 2.0) ** 2
            + (theta[1] / 2.0) ** 2
            + ((theta[2] - PI) / 2.0) ** 2
        )

    rng = np.random.default_rng(args.seed)
    # SMC tempering starts at beta = 0: the initial population must be
    # PRIOR samples, or the evidence and the frozen-in mode weights are
    # both biased.
    init = np.asarray(rng.standard_normal((args.particles, 3)) * 2.0)
    init[:, 2] += PI
    init = jnp.asarray(init)
    mesh = mesh_lib.make_mesh()
    print(
        f"devices={mesh.devices.size} curves={len(batch)} "
        f"particles={args.particles} (data {t_data:.1f}s)", flush=True,
    )

    t0 = time.perf_counter()

    def mode_split(particles):
        # Symmetric +-0.5 windows in d (non-overlapping; mode gap 2.28).
        d = np.abs(np.asarray(particles)[:, 2])
        wt = float(np.mean(np.abs(d - D_TRUE) < 0.5))
        wa = float(np.mean(np.abs(d - D_ALIAS) < 0.5))
        return wt, wa

    def progress(stage, beta, accept, particles):
        wt, wa = mode_split(particles)
        print(
            f"stage {stage}: beta={beta:.5f} accept={accept:.3f} "
            f"w_true={wt:.3f} w_alias={wa:.3f} "
            f"({time.perf_counter() - t0:.0f}s)", flush=True,
        )

    def folded_mass(parts, axis_name):
        # Within-mode metric: fold d about the reflection point pi
        # (the two modes are exact mirror images there), so the d-axis
        # variance measures the needle width instead of the inter-mode
        # spread — the raw cloud variance over-scales d proposals by
        # (mode gap / needle width) and collapses late-stage acceptance.
        from jax import lax as _lax

        folded = parts.at[:, 2].set(jnp.abs(parts[:, 2] - PI))
        mean_g = _lax.pmean(jnp.mean(folded, axis=0), axis_name)
        var_g = _lax.pmean(
            jnp.mean((folded - mean_g) ** 2, axis=0), axis_name
        )
        return jnp.maximum(var_g, 1e-10)

    res = sample_smc_sharded(
        log_prior, log_like, init, jax.random.PRNGKey(args.seed),
        mesh=mesh, num_mutations=args.mutations,
        hmc_step_size=args.step,
        num_leapfrog=args.leapfrogs, target_ess_frac=args.ess_frac,
        particle_chunk=args.chunk, host_loop=True, progress=progress,
        mass_fn=folded_mass,
    )
    parts = np.asarray(res.particles)
    wall = time.perf_counter() - t0

    w_true, w_alias = mode_split(parts)
    rec = {
        "metric": "fleet_smc_curves_per_s",
        "value": round(len(batch) / wall, 2),
        "unit": "curves/s",
        "curves": len(batch),
        "points_total": int(np.sum(batch.lengths)),
        "particles": args.particles,
        "mutations_per_stage": args.mutations,
        "stages": int(res.num_stages),
        "wall_s": round(wall, 2),
        "log_evidence": round(float(res.log_evidence), 1),
        "final_accept": round(float(res.final_accept), 3),
        "parameterization": "theta=(log_a, log_c, d); prior on d "
                            "symmetric about pi (exact 0.5/0.5 truth)",
        "mode_weight_d_true": round(w_true, 3),
        "mode_weight_d_alias": round(w_alias, 3),
        "both_modes_resolved": bool(
            w_true >= 0.15 and w_alias >= 0.15
        ),
    }
    print(json.dumps(rec))
    assert w_true + w_alias > 0.8, "particles escaped both modes"
    assert rec["both_modes_resolved"], (
        "SMC collapsed into one mode", w_true, w_alias
    )
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
