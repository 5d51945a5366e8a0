"""Conjugate-gradient solver (ref HPCCG.cpp:312-402 / HPCCG_sycl :83-301).

The reference's SYCL path crosses the host<->device boundary every kernel
(q->wait() + host-side scalar math, HPCCG.cpp:186-265). Here the *entire* CG
loop is one jitted ``lax.while_loop``: scalars (rtrans, alpha, beta, normr)
never leave the device, the loop condition evaluates on-device, and XLA fuses
the waxpby/ddot chains around the SpMV. One compiled program per
(problem-shape, max_iter) — no per-iteration dispatch at all.

Iteration structure replicated exactly (bit-compatible trajectory in f64):

    p = x0; Ap = A@p; r = b - Ap; rtrans = r.r; normr = sqrt(rtrans)
    for k = 1 .. max_iter-1 while normr > tolerance:
        if k == 1: p = r                         (HPCCG.cpp:360-363)
        else:      beta = rtrans_new/rtrans_old; p = r + beta*p   (:366-369)
        normr = sqrt(rtrans)                     (:371, printed residual)
        Ap = A@p                                 (:379)
        alpha = rtrans / (p . Ap)                (:381-382)
        x += alpha*p; r -= alpha*Ap              (:383-384)

The k==1 branch is expressed branch-free as beta=0 with an (idempotent,
bit-identical) recompute of rtrans = r.r.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from hpccg_tpu.ops.vector import ddot as _ddot


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["x", "niters", "normr", "rtrans", "trace"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class CGResult:
    """Solver output. ``trace[k]`` is the residual norm printed at iteration k
    (trace[0] = initial residual); entries past ``niters`` are NaN."""

    x: jax.Array
    niters: jax.Array  # int32, number of iterations executed (== ref niters)
    normr: jax.Array  # final residual norm (== ref normr at loop exit)
    rtrans: jax.Array
    trace: jax.Array  # (max_iter,) residual-norm trajectory


def _local_dot2(p1, p2):
    return _ddot(*p1), _ddot(*p2)


def cg_solve(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    dot: Optional[Callable[[jax.Array, jax.Array], jax.Array]] = None,
    direction: Optional[Callable] = None,
) -> CGResult:
    """Run CG. Jit-safe; call under jax.jit (or shard_map) with static
    max_iter/tolerance. ``dot`` defaults to the local dot product; pass a
    psum-reducing dot for distributed solves.

    ``direction(r, p, beta) -> (p_new, A p_new, p_new . A p_new)``: optional
    fused form of the iteration's direction step (p = r + beta*p, the SpMV
    and the p.Ap reduction) — the stencil kernel of ops/stencil_kernel.py.
    The default composes the three from ``matvec`` and ``dot``.
    """
    if dot is None:
        dot = _ddot
    if direction is None:
        def direction(r, p, beta):
            p = r + beta * p
            Ap = matvec(p)
            return p, Ap, dot(p, Ap)

    dtype = b.dtype
    tol = jnp.asarray(tolerance, dtype)

    p = x0
    Ap = matvec(p)
    r = b - Ap
    rtrans = dot(r, r)
    normr0 = jnp.sqrt(rtrans)

    trace0 = jnp.full((max(max_iter, 1),), jnp.nan, dtype).at[0].set(normr0)

    # The reference computes rtrans = r.r at the loop TOP (HPCCG.cpp:367);
    # here the same dot is evaluated fused with the r-update at the previous
    # iteration's END and CARRIED (rr_next below) — identical input array,
    # identical reduction, identical value, but inside the while_loop body
    # XLA fuses the reduce into the r-update's elementwise fusion, saving a
    # full re-read of r per iteration at HBM-resident sizes (a loop-top dot
    # on a carried array cannot fuse across the loop boundary). At k==1 the
    # carried value IS the init r.r — the reference's bit-identical
    # recompute, by construction.

    def cond(carry):
        k, x, r, p, rr_pair, normr, trace = carry
        return jnp.logical_and(k < max_iter, normr > tol)

    def body(carry):
        k, x, r, p, rr_pair, _, trace = carry
        rtrans, rtrans_old = rr_pair
        beta = jnp.where(k == 1, jnp.asarray(0.0, dtype), rtrans / rtrans_old)
        normr = jnp.sqrt(rtrans)
        trace = trace.at[k].set(normr)
        p, Ap, pap = direction(r, p, beta)
        alpha = rtrans / pap
        x = x + alpha * p
        r = r - alpha * Ap
        rr_next = dot(r, r)  # fuses with the r-update (see note above)
        return (k + 1, x, r, p, (rr_next, rtrans), normr, trace)

    k0 = jnp.asarray(1, jnp.int32)
    carry = (k0, x0, r, p, (rtrans, rtrans), normr0, trace0)
    k, x, r, p, rr_pair, normr, trace = jax.lax.while_loop(cond, body, carry)
    # exit semantics: the reference leaves the loop with normr/rtrans as of
    # its last top-of-loop evaluation; rr_pair[1] is that value (rr_pair[0]
    # is one update newer — never consumed by a loop top)
    return CGResult(
        x=x, niters=k - 1, normr=normr, rtrans=rr_pair[1], trace=trace
    )


def cg_solve_single_reduction(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    dot2: Optional[Callable] = None,
    replace_every: int = 0,
) -> CGResult:
    """Chronopoulos–Gear single-reduction CG: ONE fused 2-scalar reduction
    per iteration instead of two (communication-reduced CG; cf. the retrieved
    papers PAPERS.md — arXiv 2501.03743, 2105.06176).

    Maintains s = A p by the recurrence s' = u + beta*s (u = A r), so alpha
    and beta both derive from one (r.r, r.u) pair: the two MPI_Allreduces of
    the reference iteration (ddot.cpp:79 at HPCCG.cpp:367,381) become one
    psum of a stacked 2-vector. Costs one extra axpy + one extra carried
    vector — the right trade when allreduce latency dominates (small shards
    on a large mesh). Mathematically equivalent to cg_solve in exact
    arithmetic; the residual trajectory agrees to rounding.

    ``dot2((a1,b1),(a2,b2))`` returns (a1.b1, a2.b2) reduced in one round;
    defaults to the local fused pair.

    f32 note: the recurrence residual decays BELOW the true residual's
    stagnation floor (~1e-7 relative) and eventually flushes to exact zero,
    terminating tolerance=0 runs around iteration ~140 at typical sizes —
    long fixed-work benchmark runs should use method="cg", f64, or
    ``replace_every``.

    ``replace_every=K``: residual replacement (van der Vorst/Sleijpen-style)
    — every K iterations the recurrence residual is replaced by the TRUE
    residual b - A x (one extra matvec), re-anchoring the recurrence to the
    stagnation floor instead of letting it flush to zero. In exact
    arithmetic a no-op (f64 trajectory parity pinned in tests); the search
    direction p is kept (no restart). Collectives inside the lax.cond
    branch are fine under shard_map (replicated predicate).
    """
    if dot2 is None:
        dot2 = _local_dot2

    dtype = b.dtype
    tol = jnp.asarray(tolerance, dtype)

    r = b - matvec(x0)
    u = matvec(r)
    gamma, delta = dot2((r, r), (r, u))
    normr0 = jnp.sqrt(gamma)
    trace0 = jnp.full((max(max_iter, 1),), jnp.nan, dtype).at[0].set(normr0)
    alpha0 = gamma / delta

    # gamma_top = the ||r||^2 a standard-CG body would have computed at ITS
    # loop top (one update older than the fused gamma): the reference's loop
    # condition and exit normr test that value (HPCCG.cpp:358,371), so cg1
    # must too — otherwise tolerance exits land one iteration early.
    def cond(c):
        k, x, r, p, s, gamma, alpha, gamma_top, trace = c
        return jnp.logical_and(k < max_iter, jnp.sqrt(gamma_top) > tol)

    def body(c):
        k, x, r, p, s, gamma, alpha, _, trace = c
        trace = trace.at[k].set(jnp.sqrt(gamma))
        x = x + alpha * p
        r = r - alpha * s
        if replace_every:
            r = jax.lax.cond(
                k % replace_every == 0,
                lambda x_, r_: b - matvec(x_),
                lambda x_, r_: r_,
                x, r,
            )
        u = matvec(r)
        gamma_new, delta = dot2((r, r), (r, u))
        beta = gamma_new / gamma
        alpha = gamma_new / (delta - beta * gamma_new / alpha)
        p = r + beta * p
        s = u + beta * s
        return (k + 1, x, r, p, s, gamma_new, alpha, gamma, trace)

    k0 = jnp.asarray(1, jnp.int32)
    carry = (k0, x0, r, r, u, gamma, alpha0, gamma, trace0)
    k, x, r, p, s, gamma, alpha, gamma_top, trace = jax.lax.while_loop(
        cond, body, carry
    )
    return CGResult(
        x=x, niters=k - 1, normr=jnp.sqrt(gamma_top), rtrans=gamma_top, trace=trace
    )


def cg_solve_pipelined(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    dot2: Optional[Callable] = None,
    replace_every: int = 0,
) -> CGResult:
    """Ghysels–Vanroose pipelined CG: the iteration's single fused reduction
    overlaps the SpMV (arXiv 2105.06176 and the communication-hiding CG
    literature; PAPERS.md).

    Maintains w = A r, s = A p, z = A s by recurrences, so the one SpMV per
    iteration (q = A w) carries NO data dependency on that iteration's
    (gamma, delta) reduction — inside the jitted loop XLA's scheduler can run
    the psum concurrently with the matvec, hiding allreduce latency entirely
    on a mesh. Costs three extra carried vectors and three extra axpys vs
    cg1; in floating point the recurrences drift from true residuals
    somewhat faster than standard CG (same trajectory to ~1e-5 over typical
    run lengths; deep-convergence parity runs should use method="cg").

    ``replace_every=K``: residual replacement — every K iterations r is
    replaced by the true b - A x and w by A r (two extra matvecs at the
    replacement step; those iterations do not hide the reduction), curing
    the f32 recurrence flush like cg1's (see cg_solve_single_reduction).
    """
    if dot2 is None:
        dot2 = _local_dot2

    dtype = b.dtype
    tol = jnp.asarray(tolerance, dtype)

    r = b - matvec(x0)
    w = matvec(r)
    gamma, delta = dot2((r, r), (w, r))
    normr0 = jnp.sqrt(gamma)
    trace0 = jnp.full((max(max_iter, 1),), jnp.nan, dtype).at[0].set(normr0)
    q = matvec(w)
    alpha = gamma / delta
    p, s, z = r, w, q

    # same delayed-exit semantics as cg1: the reference's loop condition and
    # exit normr test the body-top rtrans (HPCCG.cpp:358,371)
    def cond(c):
        k, x, r, w, p, s, z, gamma, alpha, gamma_top, trace = c
        return jnp.logical_and(k < max_iter, jnp.sqrt(gamma_top) > tol)

    def body(c):
        k, x, r, w, p, s, z, gamma, alpha, _, trace = c
        trace = trace.at[k].set(jnp.sqrt(gamma))
        x = x + alpha * p
        r = r - alpha * s
        w = w - alpha * z
        if replace_every:
            r, w = jax.lax.cond(
                k % replace_every == 0,
                lambda x_, r_, w_: (
                    (lambda rt: (rt, matvec(rt)))(b - matvec(x_))
                ),
                lambda x_, r_, w_: (r_, w_),
                x, r, w,
            )
        gamma_new, delta = dot2((r, r), (w, r))
        q = matvec(w)  # independent of the in-flight reduction -> overlaps
        beta = gamma_new / gamma
        alpha = gamma_new / (delta - beta * gamma_new / alpha)
        p = r + beta * p
        s = w + beta * s
        z = q + beta * z
        return (k + 1, x, r, w, p, s, z, gamma_new, alpha, gamma, trace)

    k0 = jnp.asarray(1, jnp.int32)
    carry = (k0, x0, r, w, p, s, z, gamma, alpha, gamma, trace0)
    out = jax.lax.while_loop(cond, body, carry)
    k, x, r, w, p, s, z, gamma, alpha, gamma_top, trace = out
    return CGResult(
        x=x, niters=k - 1, normr=jnp.sqrt(gamma_top), rtrans=gamma_top, trace=trace
    )


SOLVERS = {
    "cg1": cg_solve_single_reduction,
    "pipecg": cg_solve_pipelined,
}

BACKENDS = ("auto", "stencil", "triton")


def resolve_backend(A, backend: str = "auto") -> str:
    """Map backend="auto" to the SpMV path for this operator.

    Generated stencil problems: "stencil" is the XLA stencil
    (StencilOperator.matvec); "triton" is the fused direction kernel of
    ops/stencil_kernel.py (p update + stencil + p.Ap in one pass). The auto
    rule (stencil_kernel.auto_picks_kernel) follows the interleaved
    end-to-end comparison on the card recorded in PERF.md. Explicit
    matrices always use their own matvec (DIA roll fusion or ELL gather,
    chosen by reorder.auto_structure), so every backend name maps to "auto"
    there.
    """
    from hpccg_tpu.operators import StencilOperator

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from {BACKENDS})")
    if not isinstance(A, StencilOperator):
        if backend == "triton":
            import warnings

            warnings.warn(
                f"backend={backend!r} applies to stencil operators only; "
                f"{type(A).__name__} uses its native matvec",
                stacklevel=3,
            )
        return "auto"
    if backend != "auto":
        return backend
    from hpccg_tpu.ops.stencil_kernel import auto_picks_kernel

    return "triton" if auto_picks_kernel(A) else "stencil"


def make_cg(
    A,
    *,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    backend: str = "auto",
    method: str = "cg",
    replace_every: int = 0,
    config=None,
) -> Callable[[jax.Array, jax.Array], CGResult]:
    """Build a jitted single-device solver fn(b, x0) for operator A.

    ``replace_every``: residual replacement interval for the one-reduction
    methods (cg1/pipecg) — re-anchors the recurrence residual to the true
    b - A x every K iterations, curing the f32 flush-to-zero; ignored for
    method='cg' (its residual is already the recurrence the reference
    tests).

    Solve parameters come from ``max_iter``/``tolerance`` or from a
    :class:`hpccg_tpu.SolverConfig` passed as ``config`` (explicit keywords
    win; with neither, SolverConfig's defaults apply — max_iter=150,
    tolerance=0.0, the reference's fixed-work protocol).

    backend="auto" picks the SpMV path (see resolve_backend); "triton" runs
    the fused direction kernel in method="cg" (the one-reduction methods
    apply the operator to r, not to a fresh direction, and keep the XLA
    stencil).
    """
    from hpccg_tpu.config import SolverConfig

    base = config if config is not None else SolverConfig()
    max_iter = base.max_iter if max_iter is None else max_iter
    tolerance = base.tolerance if tolerance is None else tolerance

    backend = resolve_backend(A, backend)
    if method != "cg" and method not in SOLVERS:
        raise ValueError(f"unknown CG method {method!r}")

    # A enters the jitted program as an ARGUMENT (it is a registered pytree),
    # not a closure constant: a closure-captured explicit matrix would be
    # embedded in the HLO as a literal — for a GB-scale DIA/ELL matrix that
    # stalls compilation for minutes serializing the constant (measured).
    # The StencilOperator is all-metadata, so both forms are equivalent
    # there; one code path covers everything.
    def solve_impl(A_, b, x0):
        if method != "cg":
            return SOLVERS[method](
                A_.matvec, b, x0, max_iter=max_iter, tolerance=tolerance,
                replace_every=replace_every,
            )
        direction = None
        if backend == "triton":
            from hpccg_tpu.ops.stencil_kernel import fused_direction

            direction = partial(fused_direction, A_)
        return cg_solve(
            A_.matvec, b, x0, max_iter=max_iter, tolerance=tolerance,
            direction=direction,
        )

    return partial(jax.jit(solve_impl), A)


def cg_solve_refined(
    A,
    b: jax.Array,
    x0: jax.Array,
    *,
    inner_max_iter: int = 150,
    outer_max_iter: int = 6,
    tolerance: float = 0.0,
    backend: str = "auto",
    method: str = "cg",
    replace_every: int = 0,
) -> CGResult:
    """Mixed-precision iterative refinement: f32 inner CG solves, f64-quality
    result.

    The solve is bandwidth-bound, and an f32 vector is half the bytes of an
    f64 one. Classic iterative refinement gets f64 accuracy from f32 inner
    solves: the residual r = b - A x is computed in f64 (one matvec per
    OUTER iteration), the correction solve A d = r runs entirely in f32,
    and x accumulates in f64. Each outer round recovers ~7 more decimal
    digits until the f64 floor.

    b/x0 must be f64 (enable jax_enable_x64). Returns a CGResult whose trace
    holds the OUTER f64 residual norms (length outer_max_iter + 1) and whose
    niters counts total INNER iterations.
    """
    from hpccg_tpu.operators import StencilOperator

    if jnp.dtype(b.dtype).itemsize != 8:
        raise ValueError("cg_solve_refined expects f64 b/x0 (jax_enable_x64)")

    if isinstance(A, StencilOperator):
        A32 = dataclasses.replace(A, dtype_name="float32")
    else:
        A32 = jax.tree_util.tree_map(
            lambda v: v.astype(jnp.float32)
            if jnp.issubdtype(v.dtype, jnp.floating)
            else v,
            A,
        )
    # The inner RHS is unit-scaled so a FIXED relative tolerance works for
    # every outer round; without a tolerance the f32 inner solve would
    # over-converge on small problems (residual collapses exactly -> the
    # reference recurrence's alpha = 0/0 NaN).
    inner = make_cg(
        A32, max_iter=inner_max_iter, tolerance=1e-6, backend=backend,
        method=method, replace_every=replace_every,
    )

    # exactly ONE f64 SpMV per outer round: the residual computed at the end
    # of a round is reused as the next round's RHS
    x = x0
    trace = []
    total_inner = 0
    r64 = b - A.matvec(x)
    normr = jnp.sqrt(_ddot(r64, r64))
    trace.append(float(normr))
    for _ in range(outer_max_iter):
        scale = float(normr)
        if scale <= tolerance or scale == 0.0:
            break
        rhs32 = (r64 / scale).astype(jnp.float32)
        res = inner(rhs32, jnp.zeros_like(rhs32))
        total_inner += int(res.niters)
        x = x + scale * res.x.astype(b.dtype)
        r64 = b - A.matvec(x)
        normr = jnp.sqrt(_ddot(r64, r64))
        trace.append(float(normr))

    trace_arr = jnp.full((outer_max_iter + 1,), jnp.nan, b.dtype)
    trace_arr = trace_arr.at[: len(trace)].set(jnp.asarray(trace, b.dtype))
    return CGResult(
        x=x,
        niters=jnp.asarray(total_inner, jnp.int32),
        normr=jnp.asarray(float(normr), b.dtype),
        rtrans=jnp.asarray(float(normr) ** 2, b.dtype),
        trace=trace_arr,
    )
