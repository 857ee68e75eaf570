"""Debug modes: NaN checking and cross-backend agreement assertions.

The accelerator substitute for the reference's (absent) sanitizer story
(SURVEY.md 5.2): determinism/NaN issues on accelerators surface as value
disagreements, so the first tool is an assertion that every solver
backend computes the same log-likelihood.
"""

from __future__ import annotations

import contextlib

import numpy as np

__all__ = ["debug_mode", "check_backends_agree"]


@contextlib.contextmanager
def debug_mode(nans=True, disable_jit=False):
    """Context manager enabling jax NaN debugging (and optionally no-jit)."""
    import jax

    old_nans = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", bool(nans))
    cm = jax.disable_jit() if disable_jit else contextlib.nullcontext()
    try:
        with cm:
            yield
    finally:
        jax.config.update("jax_debug_nans", old_nans)


def check_backends_agree(ssm, resid, rtol=1e-6, include_native=True):
    """Assert seq / blocked (/ native) agree on the ll.

    Returns the dict of per-backend values; raises AssertionError with
    the values on disagreement.
    """
    import jax.numpy as jnp

    from .. import native
    from ..ops import blocked, seq

    values = {}
    ll, ok = seq.gp_log_likelihood(ssm, resid)
    values["seq"] = float(ll)
    ll_b, _ = blocked.gp_log_likelihood(ssm, resid)
    values["blocked"] = float(ll_b)
    if include_native and native.available():
        ll_n, _ = native.loglike(
            *[np.asarray(v, dtype=np.float64) for v in ssm],
            np.asarray(resid, dtype=np.float64),
        )
        values["native"] = float(ll_n)

    base = values["seq"]
    scale = max(abs(base), 1.0)
    for name, v in values.items():
        if abs(v - base) > rtol * scale:
            raise AssertionError(
                "backend disagreement: {0}".format(values)
            )
    return values
