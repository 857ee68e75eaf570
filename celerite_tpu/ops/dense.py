"""Dense O(N^3) oracle solver.

JAX analog of the reference's ``DirectSolver``
(/root/reference/cpp/include/celerite/solver/direct.h) and of the dense numpy
oracles used throughout the reference test-suite
(/root/reference/tests/test_celerite.py:45-151).  Used only to validate the
O(N) scan solvers; never on the hot path.
"""

from __future__ import annotations

import jax.numpy as jnp

from .kernels import kernel_value
from .precision import f32_matmuls

__all__ = ["build_matrix", "log_likelihood", "solve"]


@f32_matmuls
def build_matrix(
    coeffs,
    t,
    diag=None,
    A_gen=None,
    U_gen=None,
    V_gen=None,
    t2=None,
    include_jitter=True,
):
    """Build the dense covariance matrix (including diag/jitter/general).

    With ``t2`` builds the rectangular cross-covariance ``K(t, t2)``
    (kernel values only — diag/jitter/general apply to the square case).
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, jitter = coeffs
    t = jnp.asarray(t)
    if t2 is not None:
        tau = t[:, None] - jnp.asarray(t2)[None, :]
        return kernel_value(
            a_real, c_real, a_comp, b_comp, c_comp, d_comp, tau
        )
    tau = t[:, None] - t[None, :]
    k = kernel_value(a_real, c_real, a_comp, b_comp, c_comp, d_comp, tau)
    n = t.shape[0]
    if include_jitter:
        k = k + jitter * jnp.eye(n, dtype=k.dtype)
    if diag is not None:
        k = k + jnp.diag(jnp.asarray(diag, dtype=k.dtype))
    if U_gen is not None and U_gen.shape[0] > 0:
        low = U_gen.T @ V_gen
        k = k + jnp.tril(low, -1) + jnp.triu(low.T, 1) + jnp.diag(A_gen)
    return k


@f32_matmuls
def solve(K, y):
    return jnp.linalg.solve(K, y)


@f32_matmuls
def log_likelihood(K, resid):
    """Dense multivariate-normal log-likelihood of ``resid`` under cov K."""
    n = K.shape[0]
    sign, logdet = jnp.linalg.slogdet(K)
    alpha = jnp.linalg.solve(K, resid)
    return -0.5 * (
        resid @ alpha + logdet + n * jnp.log(2.0 * jnp.pi)
    )
