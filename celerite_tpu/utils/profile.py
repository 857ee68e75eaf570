"""Profiling: a thin wrapper around jax.profiler for trace capture.

Replaces the reference's wall-clock-only story (SURVEY.md 5.1) with real
device traces viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import tempfile

__all__ = ["trace"]


@contextlib.contextmanager
def trace(logdir=None):
    """Capture a jax profiler trace around the enclosed block (into a
    fresh temporary directory unless ``logdir`` is given)."""
    import jax

    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="celerite_trace_")

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
