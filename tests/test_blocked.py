"""Block-parallel solver must agree with the sequential scan (bitwise-class)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from celerite_tpu import terms
from celerite_tpu.ops import blocked, seq
from celerite_tpu.ops.lower import Coefficients, lower


def make_problem(n=1000, seed=0, kernel=None):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 50, n))
    yerr = rng.uniform(0.1, 0.3, n)
    y = np.sin(0.3 * t) + yerr * rng.standard_normal(n)
    if kernel is None:
        kernel = (
            terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.3)
            + terms.RealTerm(log_a=0.2, log_c=-0.4)
        )
    coeffs = Coefficients(
        *[jnp.asarray(c) for c in kernel.coefficients],
        jitter=jnp.asarray(kernel.jitter),
    )
    ssm = lower(coeffs, jnp.asarray(t), jnp.asarray(yerr**2))
    return ssm, jnp.asarray(y)


def test_riccati_element_composition():
    """compose(e1, e2) applied to S == e2(e1(S)) for random PSD-ish maps."""
    rng = np.random.default_rng(3)
    p = 4

    def rand_elem():
        A = jnp.asarray(rng.standard_normal((p, p)) * 0.3)
        x = rng.standard_normal((p, 2))
        J = jnp.asarray(-x @ x.T * 0.1)
        y = rng.standard_normal((p, 2))
        C = jnp.asarray(y @ y.T * 0.3)
        return (A, J, C)

    def apply_elem(e, S):
        A, J, C = e
        p = A.shape[0]
        inv = jnp.linalg.inv(jnp.eye(p) + J @ S)
        return A @ S @ inv @ A.T + C

    s0 = rng.standard_normal((p, 2))
    S = jnp.asarray(s0 @ s0.T)
    e1, e2 = rand_elem(), rand_elem()
    direct = apply_elem(e2, apply_elem(e1, S))
    via = apply_elem(blocked._compose_full(e1, e2), S)
    np.testing.assert_allclose(np.asarray(via), np.asarray(direct),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("n", [64, 100, 1000, 1023])
@pytest.mark.parametrize("L", [16, 64])
def test_factor_matches_seq(n, L):
    ssm, y = make_problem(n)
    f_seq = seq.factor(ssm)
    f_blk = blocked.factor(ssm, block_size=L)
    assert bool(f_blk.ok)
    np.testing.assert_allclose(
        np.asarray(f_blk.D), np.asarray(f_seq.D), rtol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(f_blk.W), np.asarray(f_seq.W), rtol=1e-9, atol=1e-11
    )


@pytest.mark.parametrize("L", [16, 64])
def test_solve_lower_matches_seq(L):
    ssm, y = make_problem(500)
    fact = seq.factor(ssm)
    z_seq = seq.solve_lower(ssm, fact, y)
    z_blk = blocked.solve_lower(ssm, fact, y, block_size=L)
    np.testing.assert_allclose(
        np.asarray(z_blk), np.asarray(z_seq), rtol=1e-9, atol=1e-12
    )


@pytest.mark.parametrize("n", [64, 1000, 4097])
def test_ll_matches_seq(n):
    ssm, y = make_problem(n)
    ll_seq, ok_seq = seq.gp_log_likelihood(ssm, y)
    ll_blk, ok_blk = blocked.gp_log_likelihood(ssm, y)
    assert bool(ok_seq) and bool(ok_blk)
    np.testing.assert_allclose(float(ll_blk), float(ll_seq), rtol=1e-12)


@pytest.mark.slow
def test_ll_jit_grad_vmap():
    ssm, y = make_problem(512)

    kernel = terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.3)
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 50, 512))
    yerr = np.full(512, 0.2)
    yy = jnp.asarray(np.sin(0.3 * t))

    def ll(params):
        coeffs = Coefficients(
            *kernel.get_padded_coefficients(params), jitter=jnp.zeros(())
        )
        s = lower(coeffs, jnp.asarray(t), jnp.asarray(yerr**2))
        v, ok = blocked.gp_log_likelihood(s, yy)
        return v

    theta = jnp.asarray(kernel.get_parameter_vector())
    v = jax.jit(ll)(theta)

    def ll_seq_fn(params):
        coeffs = Coefficients(
            *kernel.get_padded_coefficients(params), jitter=jnp.zeros(())
        )
        s = lower(coeffs, jnp.asarray(t), jnp.asarray(yerr**2))
        v, ok = seq.gp_log_likelihood(s, yy)
        return v

    np.testing.assert_allclose(float(v), float(ll_seq_fn(theta)),
                               rtol=1e-12)

    g_blk = jax.grad(ll)(theta)
    g_seq = jax.grad(ll_seq_fn)(theta)
    np.testing.assert_allclose(
        np.asarray(g_blk), np.asarray(g_seq), rtol=1e-8
    )

    thetas = jnp.stack([theta, theta + 0.05])
    vs = jax.vmap(ll)(thetas)
    assert vs.shape == (2,)


def test_non_pd_detected():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 50, 300))
    coeffs = Coefficients(
        a_real=jnp.asarray([-1.0]),
        c_real=jnp.asarray([0.1]),
        a_comp=jnp.zeros(0),
        b_comp=jnp.zeros(0),
        c_comp=jnp.zeros(0),
        d_comp=jnp.zeros(0),
        jitter=jnp.zeros(()),
    )
    ssm = lower(coeffs, jnp.asarray(t), jnp.full(300, 1e-8))
    ll, ok = blocked.gp_log_likelihood(ssm, jnp.asarray(np.sin(t)))
    assert not bool(ok)
    assert np.isneginf(float(ll))


@pytest.mark.parametrize("L", [16, 64])
@pytest.mark.slow
def test_blocked_solve_full_matches_seq(L):
    ssm, y = make_problem(700)
    fact = seq.factor(ssm)
    x_seq = seq.solve(ssm, fact, y)
    x_blk = blocked.solve(ssm, fact, y, block_size=L)
    np.testing.assert_allclose(
        np.asarray(x_blk), np.asarray(x_seq), rtol=1e-9, atol=1e-12
    )


def test_blocked_dot_L_matches_seq():
    ssm, y = make_problem(500)
    fact = seq.factor(ssm)
    rng = np.random.default_rng(2)
    z = jnp.asarray(rng.standard_normal(500))
    np.testing.assert_allclose(
        np.asarray(blocked.dot_L(ssm, fact, z)),
        np.asarray(seq.dot_L(ssm, fact, z)),
        rtol=1e-10, atol=1e-12,
    )


def test_blocked_matmul_matches_seq():
    ssm, y = make_problem(500)
    np.testing.assert_allclose(
        np.asarray(blocked.matmul(ssm, y)),
        np.asarray(seq.matmul(ssm, y)),
        rtol=1e-10, atol=1e-12,
    )


@pytest.mark.slow
def test_cpu_n700_fitmean_default_path_safe():
    """Environment landmine regression (ROADMAP 2b): jax.grad of the
    *blocked* solver with an active mean at N=700 heap-corrupts inside
    XLA:CPU slice-transpose (a jaxlib CPU bug).  The facade's
    default path must stay clear of it: solver="auto" below 4096 points
    routes to the sequential scan, and its gradient at exactly N=700 +
    fit_mean must be finite and match finite differences.

    The raw blocked repro runs in a THROWAWAY SUBPROCESS (it can
    corrupt the heap); its status is informational — if it starts
    passing, the jaxlib bug is fixed upstream and the guard can go.
    """
    import subprocess
    import sys

    import jax
    from celerite_tpu import GP, terms

    rng = np.random.default_rng(0)
    n = 700
    t = np.sort(rng.uniform(0, 30, n))
    yerr = np.full(n, 0.1)
    y = np.sin(0.4 * t) + yerr * rng.standard_normal(n)

    gp = GP(
        terms.SHOTerm(log_S0=0.0, log_Q=0.7, log_omega0=0.5),
        mean=0.1, fit_mean=True,
    )
    gp.compute(t, yerr)
    f = gp.build_loglik(t, y, yerr, solver="auto")  # -> seq at N<4096
    theta = jnp.asarray(gp.get_parameter_vector())
    ll, g = jax.value_and_grad(lambda q: f(q)[0])(theta)
    assert np.all(np.isfinite(np.asarray(g)))
    # finite-difference check of the mean-parameter slot
    eps = 1e-6
    e = jnp.zeros_like(theta).at[-1].set(eps)
    fd = (float(f(theta + e)[0]) - float(f(theta - e)[0])) / (2 * eps)
    np.testing.assert_allclose(float(g[-1]), fd, rtol=1e-5, atol=1e-7)

    # Informational canary for the raw blocked repro.
    repro = (
        "import jax; jax.config.update('jax_platforms','cpu'); "
        "jax.config.update('jax_enable_x64', True);\n"
        "import numpy as np, jax.numpy as jnp\n"
        "from celerite_tpu import GP, terms\n"
        "rng = np.random.default_rng(0); n = 700\n"
        "t = np.sort(rng.uniform(0, 30, n)); yerr = np.full(n, 0.1)\n"
        "y = np.sin(0.4*t) + yerr*rng.standard_normal(n)\n"
        "gp = GP(terms.SHOTerm(log_S0=0.0, log_Q=0.7, log_omega0=0.5),"
        " mean=0.1, fit_mean=True)\n"
        "gp.compute(t, yerr)\n"
        "f = gp.build_loglik(t, y, yerr, solver='blocked')\n"
        "th = jnp.asarray(gp.get_parameter_vector())\n"
        "g = jax.grad(lambda q: f(q)[0])(th)\n"
        "print('BLOCKED_GRAD_OK', bool(np.all(np.isfinite(np.asarray(g)))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", repro], capture_output=True, text=True,
        timeout=300,
    )
    status = (
        "clean" if "BLOCKED_GRAD_OK True" in proc.stdout
        else f"rc={proc.returncode}"
    )
    print(f"blocked@N=700 canary: {status}")
