"""Triton kernels (ops/fused.py): interpret mode on the CPU vs the
sequential scan and the dense oracle; routing; the GPU-only guard."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from celerite_tpu import GP, terms
from celerite_tpu.ops import blocked, choose_solver, dense, fused, seq
from celerite_tpu.ops.lower import Coefficients, lower

KERNELS = {
    1: lambda: terms.RealTerm(log_a=0.2, log_c=-0.4),
    2: lambda: terms.ComplexTerm(
        log_a=0.1, log_b=-0.5, log_c=0.3, log_d=0.4
    ),
    4: lambda: (
        terms.ComplexTerm(log_a=0.1, log_b=-0.5, log_c=0.3, log_d=0.4)
        + terms.ComplexTerm(log_a=-0.7, log_b=-3.0, log_c=-0.2, log_d=1.3)
    ),
}


def make_problem(kernel, n, seed=0, coeffs=None):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 50, n))
    yerr = rng.uniform(0.1, 0.3, n)
    y = np.sin(0.3 * t) + yerr * rng.standard_normal(n)
    if coeffs is None:
        coeffs = Coefficients(
            *[jnp.asarray(c) for c in kernel.coefficients],
            jitter=jnp.asarray(kernel.jitter),
        )
    ssm = lower(coeffs, jnp.asarray(t), jnp.asarray(yerr**2))
    return ssm, jnp.asarray(y), coeffs, t, yerr


def run(ssm, y, steps=16, lanes=8):
    return jax.jit(
        lambda s, r: fused.gp_log_likelihood(s, r, steps, lanes, True)
    )(ssm, y)


@pytest.mark.parametrize("lanes", [8, 16])
@pytest.mark.parametrize("n", [256, 300])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_kernel_matches_seq_and_dense(p, n, lanes):
    """n = 256 fills 16 lanes of 16 steps exactly; n = 300 pads the last
    lane and (with 16-lane programs) a whole padding program."""
    kernel = KERNELS[p]()
    ssm, y, coeffs, t, yerr = make_problem(kernel, n)
    assert ssm.U.shape[1] == p
    ll, ok = run(ssm, y, lanes=lanes)
    ll_seq, _ = seq.gp_log_likelihood(ssm, y)
    K = dense.build_matrix(coeffs, jnp.asarray(t), diag=yerr**2)
    ll_dense = dense.log_likelihood(K, y)
    assert bool(ok)
    np.testing.assert_allclose(float(ll), float(ll_seq), rtol=1e-12)
    np.testing.assert_allclose(float(ll), float(ll_dense), rtol=1e-9)


def test_kernel_not_positive_definite():
    # a c < b d: a complex term whose covariance is not positive definite.
    e = jnp.zeros(0)
    one = lambda x: jnp.asarray([x])
    coeffs = Coefficients(e, e, one(1.0), one(np.exp(2.0)),
                          one(np.exp(-1.0)), one(np.exp(0.5)),
                          jitter=jnp.asarray(0.0))
    ssm, y, *_ = make_problem(None, 200, coeffs=coeffs)
    ll_seq, ok_seq = seq.gp_log_likelihood(ssm, y)
    assert not bool(ok_seq)
    ll, ok = run(ssm, y)
    assert not bool(ok)
    assert float(ll) == -np.inf


def test_kernel_padding_is_inert():
    """Rank 3 pads to 4 channels, N = 200 to 16 lanes of 16 steps: the
    padding rows and channels are inert and change nothing."""
    kernel = KERNELS[1]() + KERNELS[2]()
    ssm, y, *_ = make_problem(kernel, 200)
    u, v, ph, a, yl, b = fused._to_lanes(ssm, y, 16, 8)
    # 200 points: lane 12 holds 8 real steps, lanes 13-15 are padding.
    assert u.shape == (4, 16, 16) and a.shape == (16, 16) and b == 16
    for x, fill in ((u, 0.0), (v, 0.0), (ph, 1.0)):
        x = np.asarray(x)
        assert np.all(x[3] == fill)
        assert np.all(x[:, 8:, 12] == fill) and np.all(x[:, :, 13:] == fill)
    for x, fill in ((a, 1.0), (yl, 0.0)):
        x = np.asarray(x)
        assert np.all(x[8:, 12] == fill) and np.all(x[:, 13:] == fill)
    np.testing.assert_array_equal(
        np.asarray(u[:3]).transpose(2, 1, 0).reshape(-1, 3)[:200],
        np.asarray(ssm.U),
    )
    ll, ok = run(ssm, y)
    ll_seq, _ = seq.gp_log_likelihood(ssm, y)
    np.testing.assert_allclose(float(ll), float(ll_seq), rtol=1e-12)


def test_kernel_gradient_is_blocked_ad():
    ssm, y, *_ = make_problem(KERNELS[2](), 256)

    def f(ll_fn):
        return jax.jit(jax.grad(lambda s, r: ll_fn(s, r)[0], (0, 1)))

    g = f(lambda s, r: fused.gp_log_likelihood(s, r, 16, 8, True))(ssm, y)
    g_ref = f(blocked.gp_log_likelihood)(ssm, y)
    for a, b in zip(jax.tree_util.tree_leaves(g),
                    jax.tree_util.tree_leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "n, width, general, backend, route",
    [
        (1000, 2, False, "gpu", "seq"),
        (100_000, 2, False, "gpu", "fused"),
        (100_000, fused.MAX_WIDTH, False, "gpu", "fused"),
        (100_000, fused.MAX_WIDTH + 1, False, "gpu", "blocked"),
        (100_000, 2, True, "gpu", "blocked"),
        (100_000, 2, False, "cpu", "blocked"),
    ],
)
def test_choose_solver(n, width, general, backend, route):
    assert choose_solver(n, width, general, backend) == route


def test_choose_solver_default_backend_is_jax():
    assert choose_solver(100_000, 2) == "blocked"  # the tests run on CPU


@pytest.mark.parametrize("solver", ["fused", "pallas"])
def test_fused_solver_raises_off_gpu(solver):
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 10, 64))
    gp = GP(KERNELS[2]())
    with pytest.raises(ValueError, match="cpu"):
        gp.build_loglik(t, np.sin(t), yerr=0.1, solver=solver)
    ssm, y, *_ = make_problem(KERNELS[2](), 64)
    with pytest.raises(ValueError, match="GPU"):
        fused.gp_log_likelihood(ssm, y)


def test_default_steps():
    steps = [fused.default_steps(n) for n in (10, 1e5, 1e6, 1e8)]
    assert steps == sorted(steps)
    assert all(s & (s - 1) == 0 for s in steps)


@pytest.mark.gpu
def test_fused_route_on_gpu(gpu):
    """Compiled kernels (no interpret mode) vs the blocked solver."""
    rng = np.random.default_rng(1)
    n = 50_000
    t = np.sort(rng.uniform(0, 50, n))
    y = np.sin(t) + 0.1 * rng.standard_normal(n)
    gp = GP(KERNELS[4]())
    theta = jnp.asarray(gp.get_parameter_vector())
    fn = gp.build_loglik(t, y, yerr=0.1)
    assert choose_solver(n, 4) == "fused"
    ll, ok = jax.jit(fn)(theta)
    ll_b, _ = jax.jit(gp.build_loglik(t, y, yerr=0.1, solver="blocked"))(
        theta
    )
    assert bool(ok)
    np.testing.assert_allclose(float(ll), float(ll_b), rtol=1e-5)
    (_, _, g) = jax.jit(fn.value_ok_grad)(theta)
    g_b = jax.grad(lambda th: gp.build_loglik(
        t, y, yerr=0.1, solver="blocked")(th)[0])(theta)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_b), rtol=1e-6)
