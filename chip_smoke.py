#!/usr/bin/env python
"""Smoke test of the GP likelihood, gradient, predict and NUTS path on a GPU.

Drives the user entry points (``GP.build_loglik`` / ``build_logprob``
with ``solver="auto"``, ``GP.predict``, ``inference.sample_nuts``) at
full width, checks each against a float64 reference, and prints one
JSON line of facts per phase:

  0 device        the backend must be "gpu"; the card's name and power
                  limit (nvidia-smi) and the JAX version
  1 ll_n1e6       headline model (one SHO as a ComplexTerm, P=2),
                  N = 1e6, float32, vs the native C++ float64 core
  2 vog_config2   value + gradient of BASELINE config[2] (two SHO terms
                  + jitter, P=8) at N = 1e5, in float32 and in float64
                  on the card, vs float64 ops.seq on the host CPU
  3 nuts_config2  sample_nuts on config[2], 4 chains, 20 + 20 steps
  4 predict       predict(return_var=True) at N = M = 1e5 vs a float64
                  host smoother on 1e3 grid points
  5 kernel        the Triton kernels (ops/fused.py) vs the blocked lax
                  solver at N = 1e6, P = 2 and 4
  6 precision     precision="ds" at N = 1e5 and the float64 route
                  (jax_enable_x64) at N = 1e6, both vs the native core

``--four-cards`` runs only the sharded path on four GPUs: chain-sharded
NUTS on config[2] (8 chains), the N-axis sharded likelihood + gradient
at N = 1e6 vs the single-card blocked result, and particle-sharded SMC
in the shape of examples/config4_pod_smc.py, cut to smoke size.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; a failed
phase, or no GPU, makes it ``{"ok": false, ...}`` and the exit code 1.

    python chip_smoke.py [--four-cards]
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each with its reason:
# float32 ll at N = 1e6 vs float64: the sqrt(N) * eps32 quantization
# floor of the inputs is ~6e-5.
LL_F32_RTOL = 1e-4
# Gradients are gated per component, as |g - g_ref| / max(|g_ref|, 1).
# float32 reverse-mode AD through the solver: the cotangents of the
# per-point phases cos(d t), with t up to the span, cancel across the
# N steps to an O(1) sum, so small components keep only ~2 digits
# whatever the route (config[2] at N = 1e5: 1.8e-2 on an H100, 5e-2
# with the XLA:CPU build; the float64 gradient of the float32-rounded
# inputs moves by <= 3e-7).  This bound guards that envelope: a lost
# cotangent or TF32 matmuls exceed it.  It is not the 1e-3 target, which
# the float64 route below meets.
GRAD_F32_RTOL = 1e-1
# float64 blocked AD on the card vs float64 ops.seq on the host
# (XLA:CPU measured 8e-11).
GRAD_F64_RTOL = 1e-8
# float32 conditional mean vs float64, relative to the data's rms.
PREDICT_F32_RTOL = 1e-3
# Both float64.
LL_F64_RTOL = 1e-9
# precision="ds" claims the f32-input information limit, ~1e-8 relative
# (GP.build_loglik docstring); on an H100 this problem came within
# 3e-8..6e-8, where rounding y to float32 dominates.
LL_DS_RTOL = 2e-7


def emit(phase, **facts):
    print(json.dumps(dict(phase=phase, **facts), default=float), flush=True)


def timed(fn, *args, batches=5, inner=10):
    """(compile + first call seconds, median ms per call, last output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    per = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / inner * 1e3)
    return first, float(np.median(per)), out


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def grad_err(g, ref):
    """Per-component |g - ref| / max(|ref|, 1)."""
    g, ref = np.asarray(g, np.float64), np.asarray(ref, np.float64)
    return np.abs(g - ref) / np.maximum(np.abs(ref), 1.0)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# -- problems -----------------------------------------------------------------


def headline_kernel(p=2):
    sys.path.insert(0, ROOT)
    from bench import headline_kernel as kernel

    return kernel(p)


def simulate(kernel, n, seed, span=1000.0, noise=0.1):
    """Sorted times on [0, span * n / 1e6], a float64 prior draw plus
    white noise (ops/smoother.sample_prior)."""
    from celerite_tpu.ops.lower import Coefficients
    from celerite_tpu.ops.smoother import sample_prior

    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, span * n / 1e6, n))
    yerr = np.full(n, noise)
    kc = Coefficients(
        *[np.asarray(c) for c in kernel.coefficients], jitter=kernel.jitter
    )
    y = sample_prior(kc, t, seed=seed) + noise * rng.standard_normal(n)
    return t, y, yerr


def native_ll(kernel, t, y, yerr):
    from celerite_tpu import native
    from celerite_tpu.ops.lower import Coefficients, lower_np

    kc = Coefficients(
        *[np.asarray(c, np.float64) for c in kernel.coefficients],
        jitter=kernel.jitter,
    )
    ll, ok = native.loglike(*lower_np(kc, t, yerr**2), y)
    check(ok, "native reference failed to factor")
    return ll


def config2():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import config2_asteroseismic

    return config2_asteroseismic.make_problem(100_000)


# -- phases ---------------------------------------------------------------------


def phase_ll_n1e6(seed):
    import jax
    import jax.numpy as jnp
    from celerite_tpu import GP
    from celerite_tpu.ops import choose_solver

    n = 1_000_000
    kernel = headline_kernel()
    t, y, yerr = simulate(kernel, n, seed)
    gp = GP(kernel)
    fn = jax.jit(gp.build_loglik(t, y, yerr=yerr))
    theta = jnp.asarray(gp.get_parameter_vector(), jnp.float32)
    first, ms, (ll, ok) = timed(fn, theta)
    ref = native_ll(kernel, t, y, yerr)
    err = rel(ll, ref)
    facts = dict(
        n=n, P=2, route=choose_solver(n, 2), compile_s=first, ms=ms,
        evals_per_s=1e3 / ms, ll=float(ll), ref_f64=ref, rel_err=err,
        tol=LL_F32_RTOL,
    )
    emit("ll_n1e6", **facts)
    check(bool(ok) and err <= LL_F32_RTOL, "ll_n1e6 out of tolerance")


def phase_vog_config2():
    import jax
    import jax.numpy as jnp
    from celerite_tpu.ops import choose_solver

    gp, t, y, yerr, log_prior = config2()
    width = sum(np.multiply(gp.kernel.padded_size, (1, 2)))
    theta = np.asarray(gp.get_parameter_vector())

    def value_and_grad():
        lp = gp.build_logprob(t, y, yerr=yerr, log_prior=log_prior)
        vag = getattr(lp, "value_and_grad", None)
        path = "value_ok_grad" if vag is not None else "jax.value_and_grad"
        return path, jax.jit(vag or jax.value_and_grad(lp))

    path, vag = value_and_grad()
    first, ms, (v, g) = timed(vag, jnp.asarray(theta, jnp.float32),
                              batches=5, inner=5)
    # The same entry point with float64 on the card.
    with jax.enable_x64(True):
        path64, vag64 = value_and_grad()
        first64, ms64, (v64c, g64c) = timed(
            vag64, jnp.asarray(theta), batches=3, inner=5
        )
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        lp64 = gp.build_logprob(
            t, y, yerr=yerr, log_prior=log_prior, solver="seq"
        )
        v64, g64 = jax.jit(jax.value_and_grad(lp64))(jnp.asarray(theta))
        v64, g64 = float(v64), np.asarray(g64)
    per32 = grad_err(g, g64)
    per64 = grad_err(g64c, g64)
    emit(
        "vog_config2", n=len(t), P=int(width), dim=len(theta),
        route=choose_solver(len(t), int(width)), grad_path=path,
        compile_s=first, ms=ms, value=float(v), ref_f64=v64,
        value_rel_err=rel(v, v64), grad_ref_f64=g64.tolist(),
        grad_component_err=per32.tolist(), grad_tol=GRAD_F32_RTOL,
        f64_grad_path=path64, f64_compile_s=first64, f64_ms=ms64,
        f64_value_rel_err=rel(v64c, v64),
        f64_grad_component_err=per64.tolist(), f64_grad_tol=GRAD_F64_RTOL,
    )
    check(rel(v, v64) <= LL_F32_RTOL, "config2 value out of tolerance")
    check(per32.max() <= GRAD_F32_RTOL, "config2 gradient out of tolerance")
    check(rel(v64c, v64) <= LL_F64_RTOL,
          "config2 float64 value out of tolerance")
    check(per64.max() <= GRAD_F64_RTOL,
          "config2 float64 gradient out of tolerance")


def phase_nuts_config2(seed):
    import jax
    import jax.numpy as jnp
    from celerite_tpu.inference import sample_nuts

    gp, t, y, yerr, log_prior = config2()
    lp = gp.build_logprob(t, y, yerr=yerr, log_prior=log_prior)
    rng = np.random.default_rng(seed)
    init = jnp.asarray(
        gp.get_parameter_vector()[None, :]
        + 0.02 * rng.standard_normal((4, gp.vector_size)),
        jnp.float32,
    )
    # Two host-driven chunks per phase: the second sampling chunk reuses
    # the compiled segment, so its rate is free of compile time.
    chunks = []
    t0 = time.perf_counter()
    chain, info = sample_nuts(
        lp, init, jax.random.PRNGKey(seed), num_warmup=20, num_samples=20,
        max_tree_depth=5, chunk_size=10, progress=chunks.append,
    )
    chain = np.asarray(jax.block_until_ready(chain))
    wall = time.perf_counter() - t0
    acc = float(info["accept_prob"])
    emit(
        "nuts_config2", chains=4, warmup=20, samples=20, max_tree_depth=5,
        value_and_grad=hasattr(lp, "value_and_grad"),
        wall_s_with_compile=wall, samples_per_s=chunks[-1]["samples/s"],
        leapfrogs_per_s=chunks[-1]["leapfrogs/s"],
        leapfrogs=int(info["num_steps"]), accept=acc,
        divergences=int(info["divergences"]),
    )
    check(np.isfinite(chain).all(), "non-finite NUTS samples")
    check(0.0 < acc <= 1.0, "acceptance rate outside (0, 1]")


def phase_predict(seed):
    import jax
    import jax.numpy as jnp
    from celerite_tpu import GP
    from celerite_tpu.ops import smoother
    from celerite_tpu.ops.lower import Coefficients

    n = m = 100_000
    kernel = headline_kernel()
    t, y, yerr = simulate(kernel, n, seed)
    grid = np.linspace(t[0], t[-1], m)
    gp = GP(kernel)
    gp.compute(t, yerr)
    t0 = time.perf_counter()
    gp.predict(y, grid, return_var=True)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu, var = gp.predict(y, grid, return_var=True)
    wall = time.perf_counter() - t0
    sub = np.arange(0, m, m // 1000)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        kc = Coefficients(
            *[jnp.asarray(c) for c in kernel.coefficients],
            jitter=jnp.asarray(kernel.jitter),
        )
        mu64, _ = smoother.predict_var(kc, t, yerr**2, y, grid[sub])
    err = float(np.max(np.abs(np.asarray(mu)[sub] - np.asarray(mu64))))
    err /= float(np.sqrt(np.mean(y**2)))
    emit(
        "predict", n=n, m=m, route="pkalman", first_call_s=first, wall_s=wall,
        var_min=float(np.min(var)), mean_rel_err=err,
        tol=PREDICT_F32_RTOL,
    )
    check(np.all(np.asarray(var) >= 0), "negative predictive variance")
    check(err <= PREDICT_F32_RTOL, "predict mean out of tolerance")


def phase_kernel(seed):
    import jax
    import jax.numpy as jnp
    from celerite_tpu import GP

    n = 1_000_000
    for p in (2, 4):
        kernel = headline_kernel(p)
        t, y, yerr = simulate(kernel, n, seed)
        gp = GP(kernel)
        theta = jnp.asarray(gp.get_parameter_vector(), jnp.float32)
        row = {}
        for solver in ("fused", "blocked", "fused", "blocked"):
            fn = jax.jit(gp.build_loglik(t, y, yerr=yerr, solver=solver))
            first, ms, (ll, ok) = timed(fn, theta)
            check(bool(ok), "{0} failed to factor".format(solver))
            row.setdefault(solver, []).append(
                dict(compile_s=first, ms=ms, ll=float(ll))
            )
        ref = native_ll(kernel, t, y, yerr)
        fused_ms = min(r["ms"] for r in row["fused"])
        blocked_ms = min(r["ms"] for r in row["blocked"])
        emit(
            "kernel", n=n, P=p, fused=row["fused"], blocked=row["blocked"],
            speedup=blocked_ms / fused_ms, ref_f64=ref,
            rel_err_fused=rel(row["fused"][0]["ll"], ref),
            rel_err_blocked=rel(row["blocked"][0]["ll"], ref),
        )
        check(rel(row["fused"][0]["ll"], ref) <= LL_F32_RTOL,
              "fused kernel out of tolerance")


def phase_precision(seed):
    import jax
    import jax.numpy as jnp
    from celerite_tpu import GP
    from celerite_tpu.ops import choose_solver

    kernel = headline_kernel()
    n = 100_000
    t, y, yerr = simulate(kernel, n, seed)
    gp = GP(kernel)
    ref = native_ll(kernel, t, y, yerr)
    theta = jnp.asarray(gp.get_parameter_vector(), jnp.float32)
    fn = jax.jit(gp.build_loglik(t, y, yerr=yerr, precision="ds"))
    first, ms, (ll_ds, ok) = timed(fn, theta, batches=3, inner=3)
    facts = dict(ds_n=n, ds_compile_s=first, ds_ms=ms, ds_ll=float(ll_ds),
                 ds_ref_f64=ref, ds_rel_err=rel(ll_ds, ref),
                 ds_tol=LL_DS_RTOL)

    n64 = 1_000_000
    t, y, yerr = simulate(kernel, n64, seed + 1)
    ref64 = native_ll(kernel, t, y, yerr)
    with jax.enable_x64(True):
        fn = jax.jit(gp.build_loglik(t, y, yerr=yerr))
        first, ms, (ll64, ok64) = timed(
            fn, jnp.asarray(gp.get_parameter_vector()), batches=3, inner=5
        )
    facts.update(
        f64_n=n64, f64_route=choose_solver(n64, 2), f64_compile_s=first,
        f64_ms=ms, f64_ll=float(ll64), f64_ref=ref64,
        f64_rel_err=rel(ll64, ref64), f64_tol=LL_F64_RTOL,
    )
    emit("precision", **facts)
    check(bool(ok) and rel(ll_ds, ref) <= LL_DS_RTOL,
          "precision='ds' out of tolerance")
    check(bool(ok64) and rel(ll64, ref64) <= LL_F64_RTOL,
          "float64 route out of tolerance")


def phase_sharded_ll(seed):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from celerite_tpu import GP
    from celerite_tpu.ops import blocked
    from celerite_tpu.ops.lower import Coefficients, lower
    from celerite_tpu.parallel.sharded import (
        DATA_AXIS, make_data_mesh, sharded_gp_log_likelihood,
    )

    n = 1_000_000
    kernel = headline_kernel()
    t, y, yerr = simulate(kernel, n, seed)
    mesh = make_data_mesh(4)
    row = NamedSharding(mesh, P(DATA_AXIS))
    tj = jax.device_put(jnp.asarray(t, jnp.float32), row)
    yj = jax.device_put(jnp.asarray(y, jnp.float32), row)
    dj = jax.device_put(jnp.asarray(yerr**2, jnp.float32), row)
    spread = [len(x.sharding.device_set) for x in (tj, yj, dj)]

    def ll_of(solve):
        def f(theta, t, y, d):
            c = Coefficients(
                *kernel.get_padded_coefficients(theta),
                jitter=kernel.get_jitter(theta),
            )
            return solve(lower(c, t, d), y)[0]
        return jax.jit(jax.value_and_grad(f))

    # 0.3 from the generating parameters, where the gradient stands well
    # above float32's absolute floor (at the truth it is O(sqrt(N))).
    theta = jnp.asarray(GP(kernel).get_parameter_vector() + 0.3,
                        jnp.float32)
    first, ms, (v4, g4) = timed(
        ll_of(lambda s, r: sharded_gp_log_likelihood(s, r, mesh)),
        theta, tj, yj, dj,
    )
    dev0 = jax.devices()[0]
    one = [jax.device_put(np.asarray(x), dev0) for x in (tj, yj, dj)]
    first1, ms1, (v1, g1) = timed(
        ll_of(blocked.gp_log_likelihood), jax.device_put(theta, dev0), *one
    )
    per = grad_err(g4, g1)
    emit(
        "sharded_ll", n=n, devices=4, input_device_counts=spread,
        compile_s=first, ms=ms, one_card_ms=ms1, value=float(v4),
        one_card_value=float(v1), value_rel_err=rel(v4, v1),
        one_card_grad=np.asarray(g1).tolist(),
        grad_component_err=per.tolist(), grad_tol=GRAD_F32_RTOL,
    )
    check(min(spread) == 4, "an input landed on fewer than 4 devices")
    check(rel(v4, v1) <= LL_F32_RTOL, "sharded ll disagrees")
    check(per.max() <= GRAD_F32_RTOL, "sharded gradient disagrees")


def phase_sharded_nuts(seed):
    import jax
    import jax.numpy as jnp
    from celerite_tpu.parallel.sharded import sample_nuts_sharded

    gp, t, y, yerr, log_prior = config2()
    lp = gp.build_logprob(t, y, yerr=yerr, log_prior=log_prior)
    rng = np.random.default_rng(seed)
    init = jnp.asarray(
        gp.get_parameter_vector()[None, :]
        + 0.02 * rng.standard_normal((8, gp.vector_size)),
        jnp.float32,
    )
    t0 = time.perf_counter()
    chain, info = sample_nuts_sharded(
        lp, init, jax.random.PRNGKey(seed), num_warmup=6, num_samples=6,
        max_tree_depth=4,
    )
    chain = jax.block_until_ready(chain)
    wall = time.perf_counter() - t0
    acc = float(info["accept_prob"])
    emit(
        "sharded_nuts", chains=8, devices=len(chain.sharding.device_set),
        wall_s_with_compile=wall, accept=acc,
        leapfrogs=int(info["num_steps"]),
    )
    check(len(chain.sharding.device_set) == 4, "chains not on 4 devices")
    check(np.isfinite(np.asarray(chain)).all(), "non-finite samples")
    check(0.0 < acc <= 1.0, "acceptance rate outside (0, 1]")


def phase_sharded_smc(seed):
    import jax
    import jax.numpy as jnp
    from celerite_tpu import terms
    from celerite_tpu.data import batched_gp_log_likelihood
    from celerite_tpu.parallel import mesh as mesh_lib
    from celerite_tpu.parallel.sharded import sample_smc_sharded

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import config4_pod_smc

    batch = config4_pod_smc.make_batch(n_curves=64, seed=seed)
    kernel = terms.SHOTerm(log_S0=0.0, log_Q=1.0, log_omega0=1.0)

    def log_like(theta):
        lls, oks = batched_gp_log_likelihood(kernel, theta, batch)
        total = jnp.sum(jnp.where(oks, lls, -jnp.inf))
        return jnp.where(jnp.isfinite(total), total, -1e12)

    def log_prior(theta):
        return -0.5 * jnp.sum((theta / 2.0) ** 2)

    init = jnp.asarray(
        np.random.default_rng(seed).standard_normal((256, 3)), jnp.float32
    )
    t0 = time.perf_counter()
    res = sample_smc_sharded(
        log_prior, log_like, init, jax.random.PRNGKey(seed),
        mesh=mesh_lib.make_mesh(), num_mutations=2, hmc_step_size=0.05,
    )
    parts = jax.block_until_ready(res.particles)
    wall = time.perf_counter() - t0
    emit(
        "sharded_smc", curves=len(batch), particles=parts.shape[0],
        devices=len(parts.sharding.device_set), wall_s_with_compile=wall,
        stages=int(res.num_stages), log_evidence=float(res.log_evidence),
    )
    check(len(parts.sharding.device_set) == 4, "particles not on 4 devices")
    check(np.isfinite(np.asarray(parts)).all(), "non-finite particles")
    check(np.isfinite(float(res.log_evidence)), "non-finite evidence")


def run(phases):
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as exc:  # reported, and fails the run
            traceback.print_exc()
            emit(name, ok=False, error=repr(exc)[:400])
            failed.append(name)
        print("# {0}: {1:.1f} s".format(name, time.perf_counter() - t0),
              flush=True)
    return failed


def main(argv):
    four = "--four-cards" in argv
    seed = 12345
    try:
        import jax

        backend = jax.default_backend()
        if backend != "gpu":
            raise RuntimeError("JAX backend is {0!r}, not 'gpu'".format(
                backend))
        sys.path.insert(0, ROOT)
        import celerite_tpu
        from celerite_tpu.utils import enable_persistent_cache

        cache = enable_persistent_cache()
        devices = jax.devices()
        want = 4 if four else 1
        if len(devices) < want:
            raise RuntimeError("need {0} GPUs, found {1}".format(
                want, len(devices)))
        card = card_line()
    except Exception as exc:
        print(json.dumps({"ok": False, "error": repr(exc)[:400]}))
        return 1
    print(card, flush=True)
    emit("device", card=card, platform=devices[0].platform,
         kind=devices[0].device_kind, count=len(devices),
         jax=jax.__version__, package=celerite_tpu.__file__, cache=cache)

    if four:
        phases = [
            ("sharded_nuts", lambda: phase_sharded_nuts(seed)),
            ("sharded_ll", lambda: phase_sharded_ll(seed)),
            ("sharded_smc", lambda: phase_sharded_smc(seed)),
        ]
    else:
        phases = [
            ("ll_n1e6", lambda: phase_ll_n1e6(seed)),
            ("vog_config2", phase_vog_config2),
            ("nuts_config2", lambda: phase_nuts_config2(seed)),
            ("predict", lambda: phase_predict(seed)),
            ("kernel", lambda: phase_kernel(seed)),
            ("precision", lambda: phase_precision(seed)),
        ]
    failed = run(phases)
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    if failed:
        print(json.dumps({"ok": False, "failed": failed, "device": device}))
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
