"""Stateful solver facade with reference-parity semantics.

This module plays the role of the reference's pybind11 module
``celerite.solver`` (/root/reference/celerite/solver.cpp:64-664): a
``CholeskySolver`` class with ``compute / solve / dot_solve / dot_L / dot /
predict / log_determinant / computed`` plus the free functions
``get_kernel_value``, ``get_psd_value``, ``check_coefficients``,
``has_autodiff`` and the ``LinAlgError`` exception.

Under the hood everything dispatches to the pure jit-compiled scan ops in
:mod:`celerite_tpu.ops`; this class only adds the mutable state, eager
numpy conversion, dimension checks, and exception semantics that the
reference API promises.  Jit-able code should use the pure ops directly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .ops import dense, kernels, seq
from .ops.carma import CARMASolver  # noqa: F401  (parity re-export)
from .ops.lower import Coefficients, lower
from .ops.poly import check_coefficients as _check_coefficients

__all__ = [
    "CholeskySolver",
    "CARMASolver",
    "LinAlgError",
    "get_kernel_value",
    "get_psd_value",
    "check_coefficients",
    "has_autodiff",
    "get_library_version",
]

__library_version__ = "0.1.0"


class LinAlgError(Exception):
    """Raised when the Cholesky-like factorization hits a negative pivot.

    Mirrors the reference ``celerite.solver.LinAlgError``
    (solver.cpp:87, cholesky.h:176).
    """


def has_autodiff():
    """Gradients are always available (jax.grad); parity shim."""
    return True


def get_library_version():
    return __library_version__


def get_kernel_value(
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, tau
):
    return np.asarray(
        kernels.kernel_value(
            jnp.asarray(a_real),
            jnp.asarray(c_real),
            jnp.asarray(a_comp),
            jnp.asarray(b_comp),
            jnp.asarray(c_comp),
            jnp.asarray(d_comp),
            jnp.asarray(tau),
        )
    )


def get_psd_value(
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, omega
):
    return np.asarray(
        kernels.psd_value(
            jnp.asarray(a_real),
            jnp.asarray(c_real),
            jnp.asarray(a_comp),
            jnp.asarray(b_comp),
            jnp.asarray(c_comp),
            jnp.asarray(d_comp),
            jnp.asarray(omega),
        )
    )


def check_coefficients(*args):
    return _check_coefficients(*args)


# Module-level jitted entry points, shared across solver instances.
_factor = jax.jit(seq.factor)
_solve = jax.jit(seq.solve)
_dot_solve = jax.jit(seq.dot_solve)
_dot_L = jax.jit(seq.dot_L)
_matmul = jax.jit(seq.matmul)
_predict = jax.jit(seq.predict_mean)
_predict_parallel = jax.jit(
    lambda coeffs, t, alpha, x: seq.predict_mean(
        coeffs, t, alpha, x, parallel=True
    )
)


def _blocked_ops():
    from .ops import blocked

    return {
        "factor": jax.jit(blocked.factor),
        "solve": jax.jit(blocked.solve),
        "dot_solve": jax.jit(
            lambda ssm, fact, y: jnp.sum(
                blocked.solve_lower(ssm, fact, y) ** 2 / fact.D
            )
        ),
        "dot_L": jax.jit(blocked.dot_L),
        "matmul": jax.jit(blocked.matmul),
    }


def _as_f64(x):
    return jnp.asarray(x, dtype=jnp.result_type(float))


class CholeskySolver:
    """Stateful O(N J^2) factor / O(N J) solve facade.

    State layout intentionally mirrors the reference's picklable solver
    (solver.cpp:32-59): after ``compute`` it holds the factor ``(D, W)``
    plus the lowered inputs needed by the other ops.
    """

    def __init__(self, method="auto"):
        """``method``: "scan" (sequential lax.scan), "blocked"
        (block-parallel — the right choice for large N on accelerators),
        "native" (the eager C++ core — zero XLA dispatch, f64), or
        "auto" (native below 4096 points when the toolchain is present
        — a lone small-N eager eval is dispatch-latency-bound on any
        accelerator, ~0.1 ms in the native core; then scan, then
        blocked above 16384 points).  The 4096 threshold is not yet
        re-measured on a GPU."""
        self._method = method
        self._reset()

    def _use_blocked(self):
        if self._method == "auto":
            return self._n >= 16384
        return self._method == "blocked"

    def _pick_native(self, n):
        """Decide the native route at compute time (static per factor)."""
        from . import native as _native

        if self._method == "native":
            if not _native.available():
                raise RuntimeError(
                    "method='native' requires a working g++ toolchain"
                )
            return True
        return (
            self._method == "auto"
            and n < 4096
            and _native.available()
        )

    def _ops(self):
        if self._use_blocked():
            return _blocked_ops()
        return {
            "factor": _factor,
            "solve": _solve,
            "dot_solve": _dot_solve,
            "dot_L": _dot_L,
            "matmul": _matmul,
        }

    @staticmethod
    def _rhs_bucketed(fn, ssm, fact, b):
        """Run a multi-RHS op with the column count padded to a power of
        two, so repeated calls with varying nrhs reuse a handful of
        compiled programs instead of recompiling per shape (the reference
        handles arbitrary nrhs in one C++ loop, cholesky.h:292)."""
        if b.ndim == 1 or b.shape[1] <= 1:
            return np.asarray(fn(ssm, fact, jnp.asarray(b)))
        nrhs = b.shape[1]
        bucket = 1
        while bucket < nrhs:
            bucket *= 2
        if bucket != nrhs:
            b = np.concatenate(
                [b, np.zeros((b.shape[0], bucket - nrhs))], axis=1
            )
        out = np.asarray(fn(ssm, fact, jnp.asarray(b)))
        return out[:, :nrhs]

    def _reset(self):
        self._computed = False
        self._n = 0
        self._ssm = None
        self._fact = None
        self._coeffs = None
        self._t = None
        self._log_det = None
        self._native = None

    # -- main entry ---------------------------------------------------------
    def compute(
        self,
        jitter,
        a_real,
        c_real,
        a_comp,
        b_comp,
        c_comp,
        d_comp,
        A=None,
        U=None,
        V=None,
        t=None,
        diag=None,
    ):
        """Factor K; raises LinAlgError on a negative pivot.

        Mirrors cholesky.h:41-210.  ``A``/``U``/``V`` are the optional
        general semiseparable blocks (A: (N,), U/V: (J_general, N)).
        """
        if t is None:
            raise ValueError("t is required")
        t = np.ascontiguousarray(np.atleast_1d(t), dtype=float)
        n = t.shape[0]
        diag = np.ascontiguousarray(np.atleast_1d(diag), dtype=float)
        if diag.shape[0] != n:
            raise ValueError("dimension mismatch")

        a_real, c_real, a_comp, b_comp, c_comp, d_comp = (
            np.atleast_1d(np.asarray(v, dtype=float))
            for v in (a_real, c_real, a_comp, b_comp, c_comp, d_comp)
        )
        if a_real.shape != c_real.shape:
            raise ValueError("dimension mismatch")
        if not (
            a_comp.shape == b_comp.shape == c_comp.shape == d_comp.shape
        ):
            raise ValueError("dimension mismatch")

        A = np.empty(0) if A is None else np.atleast_1d(np.asarray(A))
        U = np.empty((0, 0)) if U is None else np.atleast_2d(np.asarray(U))
        V = np.empty((0, 0)) if V is None else np.atleast_2d(np.asarray(V))
        has_general = A.shape[0] != 0
        if has_general and A.shape[0] != n:
            raise ValueError("dimension mismatch")
        if has_general and (U.shape[1] != n or V.shape[1] != n):
            raise ValueError("dimension mismatch")
        if U.shape[0] != V.shape[0]:
            raise ValueError("dimension mismatch")

        # Drop any state from a previous compute() before either branch:
        # a native small-N factorization must never survive into a later
        # XLA-path recompute (or vice versa) on the same solver object.
        self._reset()

        if self._pick_native(n):
            # Eager host path: NumPy lowering + the C++ core — no XLA
            # dispatch at all (the reference's native-speed small-N
            # regime, example-stats.tex: 0.26 ms at N=200).
            from . import native as _nat
            from .ops.lower import lower_np

            coeffs = Coefficients(
                a_real=a_real, c_real=c_real, a_comp=a_comp,
                b_comp=b_comp, c_comp=c_comp, d_comp=d_comp,
                jitter=float(np.asarray(jitter)),
            )
            ssm = lower_np(
                coeffs, t, diag,
                A_gen=A if has_general else None,
                U_gen=U if has_general else None,
                V_gen=V if has_general else None,
            )
            ns = _nat.NativeSolver(*ssm)
            d = ns.D
            if not ns.ok or np.any(d < 0):
                self._computed = False
                raise LinAlgError("failed to factorize or solve matrix")
            from .ops.seq import FactorResult

            self._computed = True
            self._n = n
            self._ssm = ssm
            self._fact = FactorResult(D=ns.D, W=ns.W, ok=True)
            self._coeffs = coeffs
            self._t = t
            self._native = ns
            self._log_det = float(np.sum(np.log(d)))
            return

        coeffs = Coefficients(
            a_real=_as_f64(a_real),
            c_real=_as_f64(c_real),
            a_comp=_as_f64(a_comp),
            b_comp=_as_f64(b_comp),
            c_comp=_as_f64(c_comp),
            d_comp=_as_f64(d_comp),
            jitter=_as_f64(jitter),
        )
        ssm = lower(
            coeffs,
            _as_f64(t),
            _as_f64(diag),
            A_gen=_as_f64(A) if has_general else None,
            U_gen=_as_f64(U) if has_general else None,
            V_gen=_as_f64(V) if has_general else None,
        )
        self._n = n
        fact = self._ops()["factor"](ssm)
        d = np.asarray(fact.D)
        if np.any(d < 0):
            self._computed = False
            raise LinAlgError("failed to factorize or solve matrix")

        self._computed = True
        self._n = n
        self._ssm = ssm
        self._fact = fact
        self._coeffs = coeffs
        self._t = t
        self._log_det = float(np.sum(np.log(d)))

    # -- queries ------------------------------------------------------------
    def computed(self):
        return self._computed

    def log_determinant(self):
        self._require_computed()
        return self._log_det

    def _require_computed(self):
        if not self._computed:
            raise RuntimeError("you must call 'compute' first")

    def _check_rhs(self, b):
        b = np.ascontiguousarray(b, dtype=float)
        if b.shape[0] != self._n:
            raise ValueError("dimension mismatch")
        return b

    # -- ops ----------------------------------------------------------------
    def solve(self, b):
        """K^-1 b for b of shape (N,) or (N, nrhs)."""
        self._require_computed()
        b = self._check_rhs(b)
        if self._native is not None:
            if b.ndim == 1:
                return self._native.solve(b)
            return np.stack(
                [self._native.solve(b[:, k]) for k in range(b.shape[1])],
                axis=1,
            )
        return self._rhs_bucketed(
            self._ops()["solve"], self._ssm, self._fact, b
        )

    def dot_solve(self, b):
        """b^T K^-1 b (scalar)."""
        self._require_computed()
        b = self._check_rhs(b)
        if b.ndim > 1:
            b = b.reshape(self._n)
        if self._native is not None:
            return float(b @ self._native.solve(b))
        return float(
            self._ops()["dot_solve"](
                self._ssm, self._fact, jnp.asarray(b)
            )
        )

    def dot_L(self, z):
        """L sqrt(D) z: prior sample transport."""
        self._require_computed()
        z = self._check_rhs(z)
        if z.ndim == 1:
            z = z[:, None]
        if self._native is not None:
            return np.stack(
                [self._native.dot_L(z[:, k]) for k in range(z.shape[1])],
                axis=1,
            )
        return self._rhs_bucketed(
            self._ops()["dot_L"], self._ssm, self._fact, z
        )

    def dot(
        self,
        jitter,
        a_real,
        c_real,
        a_comp,
        b_comp,
        c_comp,
        d_comp,
        A,
        U,
        V,
        t,
        z,
    ):
        """K z without factorizing (no yerr on the diagonal)."""
        t = np.ascontiguousarray(np.atleast_1d(t), dtype=float)
        z = np.ascontiguousarray(z, dtype=float)
        if z.shape[0] != t.shape[0]:
            raise ValueError("dimension mismatch")
        squeeze = z.ndim == 1
        A = np.empty(0) if A is None else np.atleast_1d(np.asarray(A))
        U = np.empty((0, 0)) if U is None else np.atleast_2d(np.asarray(U))
        V = np.empty((0, 0)) if V is None else np.atleast_2d(np.asarray(V))
        has_general = A.shape[0] != 0
        coeffs_np = Coefficients(
            *(
                np.atleast_1d(np.asarray(v, dtype=float))
                for v in (a_real, c_real, a_comp, b_comp, c_comp, d_comp)
            ),
            jitter=float(np.asarray(jitter)),
        )
        # `dot` uses a zero yerr diagonal: A = kernel diag + jitter (+ A_gen)
        if self._pick_native(t.shape[0]):
            from . import native as _nat
            from .ops.lower import lower_np

            ssm_np = lower_np(
                coeffs_np, t, np.zeros(t.shape[0]),
                A_gen=A if has_general else None,
                U_gen=U if has_general else None,
                V_gen=V if has_general else None,
            )
            if squeeze:
                return _nat.matmul(*ssm_np, z)
            return np.stack(
                [_nat.matmul(*ssm_np, z[:, k]) for k in range(z.shape[1])],
                axis=1,
            )
        coeffs = Coefficients(
            *(_as_f64(v) for v in coeffs_np[:6]),
            jitter=_as_f64(coeffs_np.jitter),
        )
        ssm = lower(
            coeffs,
            _as_f64(t),
            jnp.zeros(t.shape[0]),
            A_gen=_as_f64(A) if has_general else None,
            U_gen=_as_f64(U) if has_general else None,
            V_gen=_as_f64(V) if has_general else None,
        )
        use_blocked = self._method == "blocked" or (
            self._method == "auto" and t.shape[0] >= 16384
        )
        fn = _blocked_ops()["matmul"] if use_blocked else _matmul
        out = np.asarray(fn(ssm, jnp.asarray(z)))
        return out

    def predict(self, y, x):
        """Conditional mean K_*(x, t) K^-1 y at sorted test points x.

        Honors the configured backend: with the blocked method (explicit
        or auto at large N) both the solve and the lag-state recursions
        run block-parallel instead of as latency-bound sequential scans.
        """
        self._require_computed()
        y = self._check_rhs(np.atleast_1d(y))
        x = np.ascontiguousarray(np.atleast_1d(x), dtype=float)
        blocked = self._use_blocked()
        if self._native is not None:
            alpha = jnp.asarray(self._native.solve(y))
        else:
            alpha = self._ops()["solve"](
                self._ssm, self._fact, jnp.asarray(y)
            )
        return np.asarray(
            _predict_parallel(
                self._coeffs, jnp.asarray(self._t), alpha, jnp.asarray(x)
            )
            if blocked
            else _predict(
                self._coeffs, jnp.asarray(self._t), alpha, jnp.asarray(x)
            )
        )

    def grad_log_likelihood(
        self,
        jitter,
        a_real,
        c_real,
        a_comp,
        b_comp,
        c_comp,
        d_comp,
        A,
        U,
        V,
        t,
        resid,
        diag,
    ):
        """(ll, grad) w.r.t. [jitter, a_real, c_real, a_c, b_c, c_c, d_c].

        Replaces the reference's forward-mode AutoDiffScalar re-run
        (solver.cpp:347-463) with reverse-mode ``jax.grad`` through the scan
        — one backward pass instead of one forward pass per coefficient.
        """
        t = np.ascontiguousarray(np.atleast_1d(t), dtype=float)
        resid = np.ascontiguousarray(resid, dtype=float)
        diag = np.ascontiguousarray(np.atleast_1d(diag), dtype=float)
        A = np.empty(0) if A is None else np.atleast_1d(np.asarray(A))
        U = np.empty((0, 0)) if U is None else np.atleast_2d(np.asarray(U))
        V = np.empty((0, 0)) if V is None else np.atleast_2d(np.asarray(V))
        has_general = A.shape[0] != 0

        sizes = [1] + [
            np.atleast_1d(np.asarray(v)).shape[0]
            for v in (a_real, c_real, a_comp, b_comp, c_comp, d_comp)
        ]
        flat = np.concatenate(
            [np.atleast_1d(np.asarray(jitter, dtype=float))]
            + [
                np.atleast_1d(np.asarray(v, dtype=float))
                for v in (a_real, c_real, a_comp, b_comp, c_comp, d_comp)
            ]
        )
        splits = np.cumsum(sizes)[:-1]

        def ll_fn(theta):
            parts = jnp.split(theta, splits)
            coeffs = Coefficients(
                a_real=parts[1],
                c_real=parts[2],
                a_comp=parts[3],
                b_comp=parts[4],
                c_comp=parts[5],
                d_comp=parts[6],
                jitter=parts[0][0],
            )
            ssm = lower(
                coeffs,
                jnp.asarray(t),
                jnp.asarray(diag),
                A_gen=jnp.asarray(A) if has_general else None,
                U_gen=jnp.asarray(U) if has_general else None,
                V_gen=jnp.asarray(V) if has_general else None,
            )
            ll, ok = seq.gp_log_likelihood(ssm, jnp.asarray(resid))
            return ll, ok

        (ll, ok), grad = jax.value_and_grad(ll_fn, has_aux=True)(
            jnp.asarray(flat)
        )
        if not bool(ok):
            raise LinAlgError("failed to factorize or solve matrix")
        return float(ll), np.asarray(grad)

    # -- pickling (parity with PicklableCholeskySolver, solver.cpp:36-58) ---
    def __getstate__(self):
        state = {"computed": self._computed,
                 "method": getattr(self, "_method", "auto")}
        if self._computed:
            state.update(
                n=self._n,
                t=np.asarray(self._t),
                log_det=self._log_det,
                ssm=tuple(np.asarray(v) for v in self._ssm),
                fact=tuple(np.asarray(v) for v in self._fact),
                coeffs=tuple(np.asarray(v) for v in self._coeffs),
            )
        return state

    def __setstate__(self, state):
        self._method = state.get("method", "auto")
        self._reset()
        if state.get("computed"):
            from .ops.lower import SSM
            from .ops.seq import FactorResult

            self._computed = True
            self._n = state["n"]
            self._t = state["t"]
            self._log_det = state["log_det"]
            self._ssm = SSM(*(jnp.asarray(v) for v in state["ssm"]))
            self._fact = FactorResult(
                *(jnp.asarray(v) for v in state["fact"])
            )
            self._coeffs = Coefficients(
                *(jnp.asarray(v) for v in state["coeffs"])
            )
