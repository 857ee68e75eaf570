"""GP orchestration API.

Behavioral parity with the reference ``celerite.GP``
(/root/reference/celerite/celerite.py:14-567): a ModelSet of ``kernel`` and
``mean`` submodels with ``compute / log_likelihood / grad_log_likelihood /
predict / sample / sample_conditional / apply_inverse / dot / get_matrix``
and dirty-flag recomputation.

Accelerator extension: :meth:`GP.build_loglik` returns a **pure, jittable**
function ``theta_active -> (log_likelihood, ok)`` over the unfrozen
parameter vector, built on the statically-shaped padded term lowering.  The
samplers in :mod:`celerite_tpu.inference` consume that function; the mutable
class API exists for reference compatibility and interactive use.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import jax
import jax.numpy as jnp

from . import solver, terms
from .modeling import ConstantModel, ModelSet, Model
from .ops import seq
from .ops.lower import Coefficients, lower

__all__ = ["GP"]


def _mean_value_fn(mean_model):
    """A traceable (params, x) -> value function for a mean model.

    ConstantModel and zero-parameter models are handled automatically; other
    mean models may provide a traceable ``value_fn(params, x)`` method.
    """
    if isinstance(mean_model, ConstantModel):
        return lambda params, x: params[0] * jnp.ones_like(x)
    if hasattr(mean_model, "value_fn"):
        return mean_model.value_fn
    if mean_model.full_size == 0:
        return lambda params, x: jnp.asarray(mean_model.get_value(np.zeros(1)))[
            0
        ] * jnp.ones_like(x)

    def fallback(params, x):
        raise ValueError(
            "custom mean models used in jitted paths must define "
            "value_fn(params, x)"
        )

    return fallback


class GP(ModelSet):
    """The main user-facing Gaussian-Process interface.

    Args:
        kernel: a :class:`celerite_tpu.terms.Term`.
        mean: a float or a :class:`celerite_tpu.modeling.Model`.
        fit_mean: if False, the mean's parameters are frozen.
    """

    def __init__(
        self,
        kernel,
        mean=0.0,
        fit_mean=False,
        log_white_noise=None,
        fit_white_noise=False,
    ):
        self._solver = None
        self._computed = False
        self._t = None
        self._yerr = None
        self._A = np.empty(0)
        self._U = np.empty((0, 0))
        self._V = np.empty((0, 0))

        if log_white_noise is not None:
            warnings.warn(
                "The 'log_white_noise' parameter is deprecated. "
                "Use a 'JitterTerm' instead."
            )
            jt = terms.JitterTerm(log_sigma=float(log_white_noise))
            if not fit_white_noise:
                jt.freeze_parameter("log_sigma")
            kernel = kernel + jt

        try:
            mean = ConstantModel(float(mean))
        except TypeError:
            pass
        if not fit_mean:
            for name in mean.get_parameter_names():
                mean.freeze_parameter(name)

        super().__init__([("kernel", kernel), ("mean", mean)])

    # -- properties ---------------------------------------------------------
    @property
    def kernel(self):
        return self.models["kernel"]

    @property
    def mean(self):
        return self.models["mean"]

    @property
    def solver(self):
        if self._solver is None:
            self._solver = solver.CholeskySolver()
        return self._solver

    @property
    def dirty(self):
        return ModelSet.dirty.fget(self) or not self._computed

    @dirty.setter
    def dirty(self, value):
        self._computed = not value
        ModelSet.dirty.fset(self, value)

    @property
    def computed(self):
        return (
            self._solver is not None
            and self._solver.computed()
            and not self.dirty
        )

    # -- compute ------------------------------------------------------------
    def compute(
        self, t, yerr=1.123e-12, check_sorted=True, A=None, U=None, V=None
    ):
        """Lower the kernel and factor the covariance matrix.

        Raises ValueError for unsorted input, LinAlgError for non-PD K.
        """
        t = np.atleast_1d(np.asarray(t, dtype=float))
        if check_sorted and np.any(np.diff(t) < 0.0):
            raise ValueError("the input coordinates must be sorted")
        if check_sorted and t.ndim > 1:
            raise ValueError("dimension mismatch")
        self._t = t
        self._yerr = np.empty_like(t)
        self._yerr[:] = yerr
        self._A = np.empty(0) if A is None else np.asarray(A)
        self._U = np.empty((0, 0)) if U is None else np.asarray(U)
        self._V = np.empty((0, 0)) if V is None else np.asarray(V)

        self._diag = self._yerr**2
        self._refactor()

    def _refactor(self):
        """Re-lower + re-factor with the stored inputs (the hot path of
        every eager parameter update; no re-validation/re-allocation)."""
        coeffs, jitter = self._eval_coefficients()
        self.solver.compute(
            jitter,
            *coeffs,
            A=self._A,
            U=self._U,
            V=self._V,
            t=self._t,
            diag=self._diag,
        )
        self.dirty = False

    def _eval_coefficients(self):
        """Current kernel coefficients + jitter as NumPy, via a cached
        CPU-jitted lowering.

        The eager jnp term algebra pays one device dispatch per op,
        which swamps the native small-N solve.  One jitted call on the
        host CPU backend avoids the accelerator round trip, and the
        padded lowering is exact (the zero-amplitude padding channels
        contribute nothing to K).
        """
        # Key the cache on the kernel object's identity: replacing (or
        # structurally mutating by swapping) gp.kernel must rebuild the
        # lowering even when the parameter-vector arity is unchanged.
        if (
            getattr(self, "_coeff_fn", None) is None
            or getattr(self, "_coeff_fn_kernel_id", None) != id(self.kernel)
        ):
            kernel = self.kernel
            jfn = jax.jit(
                lambda p: tuple(kernel.get_padded_coefficients(p))
                + (kernel.get_jitter(p),)
            )
            cpu = jax.devices("cpu")[0]

            def _coeff_fn(p):
                # numpy in -> jit device_puts onto the context default
                # (host CPU); no explicit asarray round-trip.
                with jax.default_device(cpu):
                    return jfn(p)

            self._coeff_fn = _coeff_fn
            self._coeff_fn_kernel_id = id(kernel)
        out = self._coeff_fn(
            self.kernel.get_parameter_vector(include_frozen=True)
        )
        return [np.asarray(c) for c in out[:6]], float(out[6])

    def __getstate__(self):
        # The cached jitted coefficient evaluator closes over compiled
        # executables; drop it (rebuilt lazily after unpickling).
        state = self.__dict__.copy()
        state.pop("_coeff_fn", None)
        state.pop("_coeff_fn_kernel_id", None)
        return state

    def _recompute(self):
        if not self.computed:
            if self._t is None:
                raise RuntimeError("you must call 'compute' first")
            if getattr(self, "_diag", None) is None:
                self._diag = self._yerr**2
            self._refactor()

    def _process_input(self, y):
        if self._t is None:
            raise RuntimeError("you must call 'compute' first")
        if len(self._t) != len(y):
            raise ValueError("dimension mismatch")
        return np.ascontiguousarray(y, dtype=float)

    # -- likelihood ---------------------------------------------------------
    def log_likelihood(self, y, quiet=False):
        """Marginal GP log-likelihood of ``y`` (requires compute first)."""
        y = self._process_input(y)
        if y.ndim > 1:
            raise ValueError("dimension mismatch")
        resid = y - self.mean.get_value(self._t)
        try:
            self._recompute()
        except solver.LinAlgError:
            if quiet:
                return -np.inf
            raise
        logdet = self.solver.log_determinant()
        if not np.isfinite(logdet):
            return -np.inf
        ll = -0.5 * (
            self.solver.dot_solve(resid)
            + logdet
            + len(y) * math.log(2.0 * math.pi)
        )
        if not np.isfinite(ll):
            return -np.inf
        return ll

    def grad_log_likelihood(self, y, quiet=False):
        """(ll, grad) w.r.t. the active parameter vector.

        The reference re-runs the factorization with forward-mode AD scalars
        and chain-rules through coefficient jacobians
        (celerite.py:221-305); here a single reverse-mode pass through the
        pure log-likelihood handles kernel and mean parameters together.
        """
        y = self._process_input(y)
        if y.ndim > 1:
            raise ValueError("dimension mismatch")
        fn = self.build_loglik(self._t, y, yerr=self._yerr)
        theta = jnp.asarray(self.get_parameter_vector())
        (ll, ok), grad = jax.value_and_grad(fn, has_aux=True)(theta)
        if not bool(ok):
            if quiet:
                return -np.inf, np.zeros(self.vector_size)
            raise solver.LinAlgError("failed to factorize or solve matrix")
        return float(ll), np.asarray(grad)

    # -- pure functional core ------------------------------------------------
    def build_loglik(self, t, y, yerr=1.123e-12, diag=None, solver="auto",
                     block_size=None, fast_grad=False, precision=None,
                     fast_compile=False):
        """Return a pure jittable ``theta_active -> (ll, ok)`` closure.

        ``theta_active`` follows ``get_parameter_vector()`` ordering (kernel
        params then mean params, frozen entries excluded).  Uses the padded
        statically-shaped term lowering so the closure can be jitted,
        vmapped over chains, and differentiated.  General (A, U, V) blocks
        from :meth:`compute` are folded in if present.

        ``solver``: "seq" (sequential scan), "blocked" (block-parallel),
        "fused" (the Pallas/Triton kernels of :mod:`ops.fused`; GPU
        only, ``"pallas"`` is an alias), or "auto" (see
        :func:`celerite_tpu.ops.choose_solver`: seq below 4096 points,
        then fused on a GPU for models the kernel supports, blocked
        otherwise).

        ``fast_grad``: make the gradient reverse-mode AD through the
        blocked solver, whatever solver computes the value (a custom
        VJP), and attach it as ``value_ok_grad(theta) -> (ll, ok,
        grad)``, one pass that never runs the value's solver.  The
        fused route always does this.

        ``precision``: ``None`` (native f32/f64 per ``t``'s dtype) or
        ``"ds"`` — run the lowering AND the full solver recursion in
        double-single (f32+f32, ~48-bit) arithmetic (ops/dsa,
        ops/dslower, ops/dsblocked), the float32-only equivalent of the
        reference's float64 core
        (/root/reference/cpp/include/celerite/solver/cholesky.h:41-210):
        on adversarial ill-conditioned stacks it recovers the f64
        answer to the f32-input information limit (~1e-8 relative)
        where plain f32 is off by percent or fails to factor.
        Overrides ``solver``; ``fast_grad`` is ignored (the closure
        carries a forward-mode ds ``value_ok_grad``).  General (A, U, V)
        blocks are not supported in this mode.  Compensated arithmetic
        needs a compiler that does not contract ``a*b+c`` into an FMA:
        on the CPU the tests pin ``--xla_cpu_max_isa=SSE4_2``.  On a
        card with native float64, ``jax_enable_x64`` is the exact mode.

        ``fast_compile``: force the block-parallel solver with plain
        autodiff, whatever ``solver`` and ``fast_grad`` say.  Ignored
        when ``precision='ds'`` takes the lax path anyway.
        """
        if fast_compile:
            solver = "blocked"
            fast_grad = False
        t_np = np.atleast_1d(np.asarray(t, dtype=np.float64))
        t = jnp.asarray(t_np, dtype=jnp.result_type(float))
        y = jnp.asarray(y)
        if diag is None:
            diag = jnp.square(jnp.broadcast_to(jnp.asarray(yerr), t.shape))
        else:
            diag = jnp.asarray(diag)

        # In f32 mode, precompute the static double-single time grid: exact
        # f64 spacings and the lo half of t, recovering ~3 decades of
        # lowering accuracy at zero per-eval cost (ops/ds.py).
        if t.dtype == jnp.float32:
            t_hi64 = np.float64(np.float32(t_np))
            lower_kw = dict(
                dt=jnp.asarray(
                    np.concatenate([[0.0], np.diff(t_np)]), jnp.float32
                ),
                t_lo=jnp.asarray(t_np - t_hi64, jnp.float32),
            )
        else:
            lower_kw = {}

        mask = np.asarray(self.unfrozen_mask)
        fixed = jnp.asarray(self.parameter_vector)
        idx = np.flatnonzero(mask)
        nk = self.kernel.full_size
        kernel = self.kernel
        mean_fn = _mean_value_fn(self.mean)

        if precision not in (None, "ds"):
            raise ValueError(
                "precision must be None or 'ds', got {0!r}".format(precision)
            )
        if precision == "ds":
            return self._build_loglik_ds(
                t_np, y, diag, block_size, fixed, idx, nk, mean_fn
            )

        has_general = self._A is not None and np.size(self._A) > 0
        _pr, _pc = kernel.padded_size
        width = _pr + 2 * _pc
        if solver == "auto":
            from .ops import choose_solver

            solver = choose_solver(int(t.shape[0]), width, has_general)
        if solver == "seq":
            ll_fn = seq.gp_log_likelihood
        elif solver == "blocked":
            from .ops import blocked

            ll_fn = lambda ssm, r: blocked.gp_log_likelihood(
                ssm, r, block_size=block_size
            )
        elif solver in ("fused", "pallas"):
            from .ops import fused

            fused.require_gpu()
            if has_general or not fused.supports_width(width):
                raise ValueError(
                    "solver='fused' supports models of semiseparable rank "
                    "1..{0} without general blocks; use 'blocked'".format(
                        fused.MAX_WIDTH
                    )
                )
            ll_fn = lambda ssm, r: fused.gp_log_likelihood(
                ssm, r, block_size
            )
        else:
            raise ValueError("unknown solver '{0}'".format(solver))

        A_gen = jnp.asarray(self._A) if has_general else None
        U_gen = jnp.asarray(self._U) if has_general else None
        V_gen = jnp.asarray(self._V) if has_general else None

        def make_inputs(theta):
            full = fixed.at[idx].set(theta) if len(idx) else fixed
            kp, mp = full[:nk], full[nk:]
            coeffs = Coefficients(
                *kernel.get_padded_coefficients(kp),
                jitter=kernel.get_jitter(kp),
            )
            resid = y - mean_fn(mp, t)
            ssm = lower(
                coeffs, t, diag, A_gen=A_gen, U_gen=U_gen, V_gen=V_gen,
                **lower_kw
            )
            return ssm, resid

        def loglik(theta):
            return ll_fn(*make_inputs(theta))

        def blocked_ll(theta):
            from .ops import blocked

            return blocked.gp_log_likelihood(*make_inputs(theta))

        fused_route = solver in ("fused", "pallas")
        if not (fused_route or fast_grad):
            return loglik

        if fused_route:
            # The kernel's own custom VJP already differentiates through
            # the blocked solver.
            out = loglik
        else:

            @jax.custom_vjp
            def out(theta):
                return loglik(theta)

            def _fwd(theta):
                return loglik(theta), theta

            def _bwd(theta, g):
                _, vjp = jax.vjp(lambda th: blocked_ll(th)[0], theta)
                return (vjp(g[0])[0],)

            out.defvjp(_fwd, _bwd)

        def value_ok_grad(theta):
            (ll, ok), grad = jax.value_and_grad(
                blocked_ll, has_aux=True
            )(theta)
            return ll, ok, grad

        out.value_ok_grad = value_ok_grad
        return out

    def _build_loglik_ds(self, t_np, y, diag, block_size, fixed, idx, nk,
                         mean_fn):
        """``build_loglik(precision="ds")``: the lax double-single path."""
        from .ops import dsa as _dsa
        from .ops import dsblocked as _dsb
        from .ops import dslower as _dsl

        kernel = self.kernel
        # Static ds time grid: exact f64 splits of t and the
        # spacings (dt[0] == 0), computed host-side once.
        t_ds = _dsa.from_f64(t_np)
        dt_ds = _dsa.from_f64(np.concatenate([[0.0], np.diff(t_np)]))
        # General (A, U, V) blocks are static data: exact f64 ds
        # splits, lowered as phi=1 lanes with zero tangents
        # (cholesky.h:148-152 takes them in-loop in f64; this is
        # the ds-mode equivalent).
        gen_kw = {}
        if self._A is not None and np.size(self._A) > 0:
            gen_kw = dict(
                A_gen=_dsa.from_f64(np.asarray(self._A, np.float64)),
                U_gen=_dsa.from_f64(np.asarray(self._U, np.float64)),
                V_gen=_dsa.from_f64(np.asarray(self._V, np.float64)),
            )
        diag32 = jnp.asarray(diag, jnp.float32)
        y32 = jnp.asarray(y, jnp.float32)
        T_dim = len(idx)
        mean_active = len(idx) > 0 and int(idx.max()) >= nk

        def _cf(theta):
            full = fixed.at[idx].set(theta) if len(idx) else fixed
            kp = full[:nk]
            coeffs = Coefficients(
                *kernel.get_padded_coefficients(kp),
                jitter=kernel.get_jitter(kp),
            )
            return Coefficients(*[c.astype(jnp.float32) for c in coeffs])

        def _resid(theta):
            full = fixed.at[idx].set(theta) if len(idx) else fixed
            mp = full[nk:]
            return y32 - mean_fn(mp, t_ds.hi).astype(jnp.float32)

        def _value_ok_grad_ds(theta):
            """One-pass (ll, ok, grad): dual-ds forward mode — the
            tangent recursions run in ds arithmetic alongside the
            value, so the gradient holds the same ds-class accuracy
            (plain AD's f32 cotangent chains lose ~3 decades to the
            solver's cancelling reductions)."""
            coeffs = _cf(theta)
            jac_c = jax.jacfwd(_cf)(theta)
            tangents = [
                jax.tree_util.tree_map(lambda l: l[..., j], jac_c)
                for j in range(T_dim)
            ]
            ssm_dual = _dsl.lower_ds(
                coeffs, t_ds, dt_ds, diag32,
                coeff_tangents=tangents, **gen_kw,
            )
            resid = _resid(theta)
            if mean_active:
                jr = jax.jacfwd(_resid)(theta)  # (n, T)
                resid = _dsa.dd_seed(
                    _dsa.from_f32(resid),
                    (_dsa.from_f32(jr[:, j]) for j in range(T_dim)),
                )
            return _dsb.gp_log_likelihood_grad(
                ssm_dual, resid, block_size=block_size
            )

        @jax.custom_vjp
        def loglik_ds(theta):
            ssm_ds = _dsl.lower_ds(_cf(theta), t_ds, dt_ds, diag32, **gen_kw)
            return _dsb.gp_log_likelihood(
                ssm_ds, _resid(theta), block_size=block_size
            )

        def _ds_fwd(theta):
            ll, ok, grad = _value_ok_grad_ds(theta)
            return (ll, ok), grad

        def _ds_bwd(grad, g):
            g_ll, _ = g
            return (g_ll * grad,)

        loglik_ds.defvjp(_ds_fwd, _ds_bwd)
        loglik_ds.value_ok_grad = _value_ok_grad_ds
        return loglik_ds

    def build_logprob(self, t, y, yerr=1.123e-12, log_prior=None,
                      solver="auto", block_size=None, fast_grad=None,
                      precision=None, fast_compile=False):
        """Pure ``theta -> log posterior`` (ll + prior), -inf-safe.

        ``log_prior`` defaults to a traceable box prior built from the
        parameter bounds (the modeling protocol's log_prior semantics).

        ``fast_grad=None`` (default): when the log-likelihood closure
        carries a one-pass value+gradient entry point (``value_ok_grad``:
        the fused route's blocked-AD gradient, or the ds route's
        forward-mode one), the returned closure gets a
        ``value_and_grad`` attribute backed by it, which the samplers
        pick up.  Pass ``False`` to force plain autodiff through the
        closure.

        ``precision="ds"`` routes the likelihood (value AND gradient)
        through the double-single solver (``build_loglik`` precision
        semantics, docs/precision.md).
        """
        ll_fn = self.build_loglik(
            t, y, yerr=yerr, solver=solver, block_size=block_size,
            fast_grad=False if fast_grad is None else fast_grad,
            precision=precision, fast_compile=fast_compile,
        )
        if log_prior is None:
            bounds = self.get_parameter_bounds()
            lo = jnp.asarray(
                [b[0] if b[0] is not None else -jnp.inf for b in bounds]
            )
            hi = jnp.asarray(
                [b[1] if b[1] is not None else jnp.inf for b in bounds]
            )

            def log_prior(theta):
                in_box = jnp.all((theta >= lo) & (theta <= hi))
                return jnp.where(in_box, 0.0, -jnp.inf)

        def logprob(theta):
            lp = log_prior(theta)
            ll, ok = ll_fn(theta)
            total = lp + jnp.where(ok, ll, -jnp.inf)
            return jnp.where(jnp.isfinite(total), total, -jnp.inf)

        vog = getattr(ll_fn, "value_ok_grad", None)
        if (fast_grad or fast_grad is None) and vog is not None:

            def value_and_grad(theta):
                lp, dlp = jax.value_and_grad(log_prior)(theta)
                ll, ok, dll = vog(theta)
                total = lp + jnp.where(ok, ll, -jnp.inf)
                bad = ~jnp.isfinite(total)
                total = jnp.where(bad, -jnp.inf, total)
                grad = jnp.where(bad, 0.0, dlp + dll)
                return total, grad

            logprob.value_and_grad = value_and_grad

        return logprob

    # -- linear algebra -----------------------------------------------------
    def apply_inverse(self, y):
        """K^-1 y (with yerr and jitter on the diagonal)."""
        self._recompute()
        return self.solver.solve(self._process_input(y))

    def dot(
        self, y, t=None, A=None, U=None, V=None, kernel=None,
        check_sorted=True,
    ):
        """K y without the yerr diagonal (reference celerite.py:330-397)."""
        if kernel is None:
            kernel = self.kernel
        if t is not None:
            t = np.atleast_1d(np.asarray(t, dtype=float))
            if check_sorted and np.any(np.diff(t) < 0.0):
                raise ValueError("the input coordinates must be sorted")
            if check_sorted and t.ndim > 1:
                raise ValueError("dimension mismatch")
            A = np.empty(0) if A is None else A
            U = np.empty((0, 0)) if U is None else U
            V = np.empty((0, 0)) if V is None else V
        else:
            if not self.computed:
                raise RuntimeError("you must call 'compute' first")
            t, A, U, V = self._t, self._A, self._U, self._V
        return self.solver.dot(
            kernel.jitter,
            *kernel.coefficients,
            A,
            U,
            V,
            t,
            np.ascontiguousarray(y, dtype=float),
        )

    # -- prediction ---------------------------------------------------------
    def predict(self, y, t=None, return_cov=True, return_var=False):
        """Conditional predictive distribution at coordinates ``t``.

        Returns ``mu``, ``(mu, cov)`` or ``(mu, var)``; O(N) mean via the
        lag-state scan, dense O(N M) variance (reference celerite.py:399-474).
        """
        y = self._process_input(y)
        if y.ndim > 1:
            raise ValueError("dimension mismatch")
        if t is None:
            xs = self._t
        else:
            xs = np.ascontiguousarray(t, dtype=float)
            if xs.ndim > 1:
                raise ValueError("dimension mismatch")

        self._recompute()
        resid = y - self.mean.get_value(self._t)

        if return_var and not len(self._A):
            # O((N+M) p^2) Kalman/RTS smoother replaces the reference's
            # dense O(N M) variance build (celerite.py:460-469) whenever
            # the kernel admits a Gauss-Markov realization
            # (ops/smoother.py); it yields the conditional MEAN too, so
            # the O(N)-sequential lag-state scan is skipped entirely.
            from .ops.lower import Coefficients as _C
            from .ops import smoother as _sm

            coeffs = _C(
                *[jnp.asarray(c) for c in self.kernel.coefficients],
                jitter=jnp.asarray(self.kernel.jitter),
            )
            if _sm.realize(coeffs) is not None:
                # The two-level blocked Kalman/RTS engine (short
                # within-block scans over wide batches plus a log-depth
                # cross-block composition); on an H100 it beat the
                # compiled sequential scan at every merged size measured,
                # from 100 points up (PERF.md).  ops/smoother stays the
                # reference.
                from .ops import pkalman as _pk

                mu_sm, var = _pk.predict_var_parallel(
                    coeffs, self._t, self._yerr**2, resid, xs
                )
                mu = self.mean.get_value(xs) + mu_sm
                return mu, var

        if t is None:
            alpha = np.asarray(self.solver.solve(resid)).reshape(-1)
            alpha = resid - (self._yerr**2 + self.kernel.jitter) * alpha
        elif not len(self._A):
            alpha = self.solver.predict(resid, xs)
        else:
            Kxs = self.get_matrix(xs, self._t)
            alpha = np.dot(
                Kxs, np.asarray(self.solver.solve(resid)).reshape(-1)
            )

        mu = self.mean.get_value(xs) + np.asarray(alpha)
        if not (return_var or return_cov):
            return mu

        Kxs = self.get_matrix(xs, self._t)
        KxsT = np.ascontiguousarray(Kxs.T, dtype=np.float64)
        if return_var:
            var = -np.sum(
                KxsT * np.asarray(self.apply_inverse(KxsT)), axis=0
            )
            var += self.kernel.get_value(0.0)
            return mu, var

        cov = self.kernel.get_value(xs[:, None] - xs[None, :])
        cov -= np.dot(Kxs, np.asarray(self.apply_inverse(KxsT)))
        return mu, cov

    def get_matrix(
        self, x1=None, x2=None, include_diagonal=None, include_general=None
    ):
        """Dense covariance matrix (same surface as reference
        celerite.py:476-516, built by the dense oracle
        :func:`celerite_tpu.ops.dense.build_matrix`)."""
        from .ops import dense

        coeffs = Coefficients(
            *self.kernel.coefficients, jitter=self.kernel.jitter
        )
        if x1 is None and x2 is None:
            if self._t is None or not self.computed:
                raise RuntimeError("you must call 'compute' first")
            use_diag = include_diagonal is None or include_diagonal
            use_gen = (include_general is None or include_general) and len(
                self._A
            )
            K = dense.build_matrix(
                coeffs,
                self._t,
                diag=self._yerr**2 if use_diag else None,
                A_gen=jnp.asarray(self._A) if use_gen else None,
                U_gen=jnp.asarray(self._U) if use_gen else None,
                V_gen=jnp.asarray(self._V) if use_gen else None,
                include_jitter=use_diag,
            )
            return np.array(K, dtype=float)

        incl = False
        x1 = np.ascontiguousarray(x1, dtype=float)
        if x2 is None:
            x2 = x1
            incl = include_diagonal is not None and include_diagonal
        K = np.array(
            dense.build_matrix(
                coeffs, x1, t2=np.ascontiguousarray(x2, dtype=float)
            ),
            dtype=float,
        )
        if incl:
            K[np.diag_indices_from(K)] += self.kernel.jitter
        return K

    # -- sampling ------------------------------------------------------------
    def sample(self, size=None, seed=None):
        """Sample from the GP prior at the computed coordinates."""
        self._recompute()
        rng = np.random.default_rng(seed) if seed is not None else np.random
        if size is None:
            n = rng.standard_normal(len(self._t)) if seed is not None else (
                np.random.randn(len(self._t))
            )
        else:
            n = (
                rng.standard_normal((len(self._t), size))
                if seed is not None
                else np.random.randn(len(self._t), size)
            )
        n = self.solver.dot_L(n)
        if size is None:
            return self.mean.get_value(self._t) + n[:, 0]
        return self.mean.get_value(self._t)[None, :] + n.T

    def sample_conditional(self, y, t=None, size=None, regularize=None):
        """Sample from the predictive distribution (O(M^3) in len(t))."""
        mu, cov = self.predict(y, t, return_cov=True)
        if regularize is not None:
            cov[np.diag_indices_from(cov)] += regularize
        return np.random.multivariate_normal(mu, cov, size=size)
