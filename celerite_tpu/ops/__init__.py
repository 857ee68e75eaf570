"""Numeric core: semiseparable solver ops, lowering, oracles.

Layout (each module documents the reference component it replaces):

- ``kernels``: closed-form kernel / PSD evaluation (utils.h analog)
- ``lower``: coefficient arrays -> semiseparable (U, V, phi, A) lowering
- ``seq``: sequential ``lax.scan`` solver (cholesky.h analog)
- ``blocked``: two-level block-parallel solver (no reference analog;
  the accelerator reformulation)
- ``fused``: the blocked algebra as Pallas/Triton kernels (GPU only)
- ``dense``: O(N^3) dense oracle (direct.h analog)
- ``poly``: polynomial algebra + Sturm PSD positivity check (poly.h analog)
- ``carma``: CARMA Kalman filter + conversion (carma.h analog)
"""

from . import blocked, carma, dense, kernels, lower, poly, seq  # noqa: F401

# Below this many points the sequential scan beats the block-parallel
# solvers (their cross-block prefix is pure overhead at small N).
SEQ_MAX_POINTS = 4096


def choose_solver(n, width, general=False, backend=None):
    """The ``solver="auto"`` route for ``n`` points of rank ``width``.

    "seq" below :data:`SEQ_MAX_POINTS`; then "fused" on a GPU for
    models the Triton kernels support (:func:`fused.supports_width`,
    no general blocks); "blocked" otherwise.  ``backend`` defaults to
    ``jax.default_backend()``.
    """
    import jax

    from . import fused

    if n < SEQ_MAX_POINTS:
        return "seq"
    backend = backend or jax.default_backend()
    if backend == "gpu" and not general and fused.supports_width(width):
        return "fused"
    return "blocked"


def best_ll(ssm, resid):
    """GP log-likelihood through the :func:`choose_solver` route.

    Returns the ll value only (-inf when the factorization fails).
    """
    n, p = ssm.U.shape
    route = choose_solver(n, p)
    if route == "seq":
        ll, _ = seq.gp_log_likelihood(ssm, resid)
    elif route == "fused":
        from . import fused

        ll, _ = fused.gp_log_likelihood(ssm, resid)
    else:
        ll, _ = blocked.gp_log_likelihood(ssm, resid)
    return ll
