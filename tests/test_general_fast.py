"""General (A, U, V) semiseparable blocks on the fast solver paths.

The reference runs general blocks through its native-speed core in-loop
(cholesky.h:65-69, 148-152).  Here the equivalent is the lowering
contract: general blocks become phi=1 columns of the (N, P) SSM arrays
(ops/lower.py:133-137), so every solver backend — sequential scan,
block-parallel Riccati, and the facade — consumes them at full speed.
These tests pin the blocked backend + build_loglik against the dense
oracle at N=4096 (mirroring tests/test_solver.py's ``general``
parametrization at fast-path scale).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from celerite_tpu import GP, terms
from celerite_tpu.ops import blocked, dense, seq
from celerite_tpu.ops.lower import Coefficients, lower


def make_kernel():
    return (
        terms.RealTerm(log_a=0.1, log_c=0.5)
        + terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.3)
    )


def make_data(n=4096, seed=42):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 40, n))
    yerr = rng.uniform(0.1, 0.2, n)
    y = np.sin(t) + yerr * rng.standard_normal(n)
    return t, yerr, y


def make_general(t, seed=3, rank=3):
    """Vandermonde-style general low-rank blocks (PSD-ish)."""
    rng = np.random.default_rng(seed)
    scale = 0.1
    U = np.vander((t - t.min()) / (t.max() - t.min()), rank).T * scale
    V = 0.5 * U + 0.01 * rng.standard_normal(U.shape)
    A = np.sum(U * V, axis=0) + 0.3
    return A, U, V


def build_ssm_and_K(kernel, t, yerr):
    A, U, V = make_general(t)
    coeffs = Coefficients(
        *[jnp.asarray(c) for c in kernel.coefficients],
        jitter=jnp.asarray(kernel.jitter),
    )
    gen = dict(
        A_gen=jnp.asarray(A), U_gen=jnp.asarray(U), V_gen=jnp.asarray(V)
    )
    ssm = lower(coeffs, jnp.asarray(t), jnp.asarray(yerr**2), **gen)
    K = np.asarray(
        dense.build_matrix(
            coeffs, jnp.asarray(t), diag=yerr**2,
            A_gen=A, U_gen=U, V_gen=V,
        )
    )
    return ssm, K, (A, U, V)


def test_blocked_factor_general_n4096():
    t, yerr, _ = make_data(4096)
    ssm, K, _ = build_ssm_and_K(make_kernel(), t, yerr)
    fact = blocked.factor(ssm)
    assert bool(fact.ok)
    _, expect = np.linalg.slogdet(K)
    np.testing.assert_allclose(
        float(jnp.sum(jnp.log(fact.D))), expect, rtol=1e-8
    )
    # Identical to the sequential scan (the general columns are plain
    # phi=1 lanes to both backends).
    sfact = seq.factor(ssm)
    np.testing.assert_allclose(
        np.asarray(fact.D), np.asarray(sfact.D), rtol=1e-10
    )


def test_blocked_solve_general_n4096():
    t, yerr, y = make_data(4096)
    ssm, K, _ = build_ssm_and_K(make_kernel(), t, yerr)
    fact = blocked.factor(ssm)
    x = np.asarray(blocked.solve(ssm, fact, jnp.asarray(y)))
    np.testing.assert_allclose(
        x, np.linalg.solve(K, y), rtol=1e-6, atol=1e-8
    )


def test_blocked_gp_log_likelihood_general_n4096():
    t, yerr, y = make_data(4096)
    ssm, K, _ = build_ssm_and_K(make_kernel(), t, yerr)
    ll, ok = blocked.gp_log_likelihood(ssm, jnp.asarray(y))
    assert bool(ok)
    sign, logdet = np.linalg.slogdet(K)
    expect = -0.5 * (
        y @ np.linalg.solve(K, y) + logdet + len(y) * np.log(2 * np.pi)
    )
    np.testing.assert_allclose(float(ll), expect, rtol=1e-9)


@pytest.mark.parametrize("solver", ["auto", "blocked", "seq"])
def test_build_loglik_general_backends_agree_with_dense(solver):
    t, yerr, y = make_data(4096)
    kernel = make_kernel()
    A, U, V = make_general(t)
    gp = GP(kernel)
    gp.compute(t, yerr, A=A, U=U, V=V)

    ll_fn = jax.jit(gp.build_loglik(t, y, yerr=yerr, solver=solver))
    theta = jnp.asarray(gp.get_parameter_vector())
    ll, ok = ll_fn(theta)
    assert bool(ok)

    _, K, _ = build_ssm_and_K(kernel, t, yerr)
    sign, logdet = np.linalg.slogdet(K)
    expect = -0.5 * (
        y @ np.linalg.solve(K, y) + logdet + len(y) * np.log(2 * np.pi)
    )
    np.testing.assert_allclose(float(ll), expect, rtol=1e-9)


def test_build_loglik_general_gradient_matches_dense_ad():
    """grad of the blocked fast path == grad of the dense oracle ll."""
    n = 1024
    t, yerr, y = make_data(n)
    kernel = make_kernel()
    A, U, V = make_general(t)
    gp = GP(kernel)
    gp.compute(t, yerr, A=A, U=U, V=V)
    theta = jnp.asarray(gp.get_parameter_vector())

    ll_fn = gp.build_loglik(t, y, yerr=yerr, solver="blocked")
    (ll, ok), grad = jax.value_and_grad(ll_fn, has_aux=True)(theta)
    assert bool(ok)

    nk = kernel.full_size

    def dense_ll(th):
        coeffs = Coefficients(
            *kernel.get_padded_coefficients(th[:nk]),
            jitter=kernel.get_jitter(th[:nk]),
        )
        K = dense.build_matrix(
            coeffs, jnp.asarray(t), diag=yerr**2,
            A_gen=jnp.asarray(A), U_gen=jnp.asarray(U),
            V_gen=jnp.asarray(V),
        )
        r = jnp.asarray(y)
        L = jnp.linalg.cholesky(K)
        z = jax.scipy.linalg.solve_triangular(L, r, lower=True)
        return -0.5 * (
            z @ z
            + 2 * jnp.sum(jnp.log(jnp.diag(L)))
            + n * jnp.log(2 * jnp.pi)
        )

    ll_d, grad_d = jax.value_and_grad(dense_ll)(theta)
    np.testing.assert_allclose(float(ll), float(ll_d), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(grad), np.asarray(grad_d), rtol=1e-6, atol=1e-8
    )


def test_build_loglik_general_fast_grad_path():
    """fast_grad=True with general blocks: custom-VJP path stays exact."""
    t, yerr, y = make_data(1024)
    kernel = make_kernel()
    A, U, V = make_general(t)
    gp = GP(kernel)
    gp.compute(t, yerr, A=A, U=U, V=V)
    theta = jnp.asarray(gp.get_parameter_vector())

    plain = gp.build_loglik(t, y, yerr=yerr, solver="blocked")
    fast = gp.build_loglik(
        t, y, yerr=yerr, solver="blocked", fast_grad=True
    )
    (ll_p, _), g_p = jax.value_and_grad(plain, has_aux=True)(theta)
    (ll_f, _), g_f = jax.value_and_grad(fast, has_aux=True)(theta)
    np.testing.assert_allclose(float(ll_f), float(ll_p), rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(g_f), np.asarray(g_p), rtol=1e-6, atol=1e-9
    )


def test_build_loglik_general_vmapped_chains():
    """The blocked general path vmaps over parameter batches (sampler
    chains) without falling back to python loops."""
    t, yerr, y = make_data(1024)
    kernel = make_kernel()
    A, U, V = make_general(t)
    gp = GP(kernel)
    gp.compute(t, yerr, A=A, U=U, V=V)
    theta = jnp.asarray(gp.get_parameter_vector())
    thetas = theta[None, :] + 0.01 * jnp.asarray(
        np.random.default_rng(0).standard_normal((4, theta.shape[0]))
    )

    ll_fn = gp.build_loglik(t, y, yerr=yerr, solver="blocked")
    lls, oks = jax.jit(jax.vmap(ll_fn))(thetas)
    assert bool(jnp.all(oks))
    for i in range(4):
        ll_i, _ = ll_fn(thetas[i])
        np.testing.assert_allclose(float(lls[i]), float(ll_i), rtol=1e-12)
