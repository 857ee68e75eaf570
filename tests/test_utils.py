"""Utils: timer, debug mode, backend agreement."""

import numpy as np

import jax.numpy as jnp

from celerite_tpu import terms
from celerite_tpu.ops.lower import Coefficients, lower
from celerite_tpu.utils import benchmark, check_backends_agree, debug_mode


def test_backends_agree():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 50, 300))
    kernel = terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.3)
    coeffs = Coefficients(
        *[jnp.asarray(c) for c in kernel.coefficients],
        jitter=jnp.zeros(()),
    )
    ssm = lower(coeffs, jnp.asarray(t), jnp.full(300, 0.04))
    vals = check_backends_agree(ssm, jnp.asarray(np.sin(t)))
    assert set(vals) >= {"seq", "blocked"}


def test_benchmark_returns_positive():
    dt = benchmark(lambda: sum(range(100)), minimum_time=0.01)
    assert dt > 0


def test_debug_mode_restores():
    import jax

    before = jax.config.jax_debug_nans
    with debug_mode(nans=True):
        assert jax.config.jax_debug_nans
    assert jax.config.jax_debug_nans == before


def test_ds_lowering_accuracy():
    """f32 lowering with static ds time grid vs the f64 lowering.

    Without dt/t_lo, f32 spacings carry up to percent-level relative error
    (differencing a rounded t) and phases ~1e-4 rad absolute error at
    |d t| ~ 1e4; the ds path recovers ~1e-7 on both (ops/ds.py).
    """
    import jax.numpy as jnp
    import numpy as np

    from celerite_tpu.ops.ds import host_ds
    from celerite_tpu.ops.lower import Coefficients, lower

    rng = np.random.default_rng(0)
    n = 4096
    t64 = np.sort(rng.uniform(0, 1000.0, n))
    diag = np.full(n, 1e-2)

    def coeffs(dtype):
        return Coefficients(
            a_real=jnp.asarray([0.7], dtype),
            c_real=jnp.asarray([0.3], dtype),
            a_comp=jnp.asarray([1.1], dtype),
            b_comp=jnp.asarray([0.4], dtype),
            c_comp=jnp.asarray([0.8], dtype),
            d_comp=jnp.asarray([11.0], dtype),
            jitter=jnp.zeros((), dtype),
        )

    ssm64 = lower(coeffs(jnp.float64), jnp.asarray(t64),
                  jnp.asarray(diag))

    t_hi, t_lo = host_ds(t64)
    dt32 = np.concatenate([[0.0], np.diff(t64)]).astype(np.float32)
    ssm_ds = lower(
        coeffs(jnp.float32), jnp.asarray(t_hi),
        jnp.asarray(diag, jnp.float32),
        dt=jnp.asarray(dt32), t_lo=jnp.asarray(t_lo),
    )
    ssm_naive = lower(
        coeffs(jnp.float32), jnp.asarray(t_hi),
        jnp.asarray(diag, jnp.float32),
    )

    # Phases: ds error ~1e-7; naive error ~|d t| * eps32 ~ 1e-3.
    err_ds = np.max(np.abs(np.asarray(ssm_ds.V, np.float64)
                           - np.asarray(ssm64.V)))
    err_naive = np.max(np.abs(np.asarray(ssm_naive.V, np.float64)
                              - np.asarray(ssm64.V)))
    assert err_ds < 5e-7, err_ds
    assert err_ds < err_naive / 50, (err_ds, err_naive)

    # Decay factors: exact spacings remove the differencing error.
    rel_ds = np.max(np.abs(np.asarray(ssm_ds.phi, np.float64)
                           / np.asarray(ssm64.phi) - 1))
    rel_naive = np.max(np.abs(np.asarray(ssm_naive.phi, np.float64)
                              / np.asarray(ssm64.phi) - 1))
    assert rel_ds < 5e-7, rel_ds
    assert rel_ds < rel_naive / 50, (rel_ds, rel_naive)


def test_accurate_exp():
    """Compensated f32 exp: ~2-3 ulp over the decay-factor range."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from celerite_tpu.ops.ds import accurate_exp

    rng = np.random.default_rng(1)
    x64 = -np.concatenate([
        rng.uniform(1e-6, 3e-3, 20000),
        rng.uniform(1e-3, 5.0, 20000),
        rng.uniform(5.0, 80.0, 5000),
        [0.0, 87.5, 100.0, 700.0],
    ])
    x32 = x64.astype(np.float32)
    got = np.asarray(jax.jit(accurate_exp)(jnp.asarray(x32)), np.float64)
    ref = np.exp(np.float64(x32))
    rel = np.abs(got - ref) / np.maximum(ref, 1e-38)
    mask = ref > 1e-30  # skip the flushed deep-underflow tail
    assert np.max(rel[mask]) < 5e-7, np.max(rel[mask])
    assert got[x32 < -87.5].max(initial=0.0) == 0.0
    # f64 passes straight through.
    g64 = np.asarray(accurate_exp(jnp.asarray(x64)))
    np.testing.assert_allclose(g64, np.exp(x64), rtol=1e-15)


def test_persistent_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from celerite_tpu.utils import enable_persistent_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_persistent_cache() == str(tmp_path)
    # With the variable set, nothing is configured in code.
    assert jax.config.jax_compilation_cache_dir == before


def test_persistent_cache_defaults_inside_checkout(monkeypatch):
    import os

    import jax

    from celerite_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_persistent_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".cache", "xla")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(path)
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
