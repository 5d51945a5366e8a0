"""Wall-clock timing around device work (ref mytimer.cpp).

The reference picks a timer backend at compile time (mytimer.cpp:49-121); here
one ``time.perf_counter`` path suffices. JAX dispatch is asynchronous, so
every timed region ends in ``jax.block_until_ready``.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax


def fence(tree) -> None:
    """Wait until every leaf of ``tree`` is computed."""
    jax.block_until_ready(tree)


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 2) -> float:
    """Median wall seconds per fenced call of fn(*args)."""
    for _ in range(max(warmup, 1)):
        fence(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fence(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def time_loop_body(body: Callable, init, *, iters: int = 16, reps: int = 3) -> float:
    """Seconds per call of ``body`` (carry -> carry).

    Measures jitted fori_loops of K and spread*K iterations and returns the
    slope: the per-dispatch constant cancels, leaving the marginal
    per-iteration cost. ``body`` must make the carry flow through the
    computation, or XLA will hoist/DCE it.
    """

    def make_loop(k: int):
        return jax.jit(lambda c: jax.lax.fori_loop(0, k, lambda i, c: body(c), c))

    return time_loop_slope(make_loop, init, iters=iters, reps=reps)


def time_loop_slope(
    make_loop: Callable[[int], Callable],
    init,
    *,
    iters: int = 16,
    spread: int = 0,
    reps: int = 3,
    min_long_s: float = 0.05,
) -> float:
    """Slope-timing for a caller-built K-iteration loop: make_loop(k) must
    return a jitted callable running k iterations.

    ``spread=0`` sizes the long leg from the short one: at least 4x and up
    to 256x its iterations, enough for the long leg to take ``min_long_s``
    — small problems need many iterations to rise above the per-call
    jitter, deployment-size ones only a few. The (short, long) pair is
    measured INTERLEAVED and the median of per-pair slopes is returned, so
    slow drift (clocks under a power limit) hits both legs of a pair alike.
    """
    short = make_loop(iters)
    fence(short(init))  # compile + warm
    if not spread:
        t0 = time.perf_counter()
        fence(short(init))
        t_short = time.perf_counter() - t0
        spread = 4
        while spread < 256 and spread * t_short < min_long_s:
            spread *= 4
    long_ = make_loop(spread * iters)
    fence(long_(init))
    slopes = []
    for _ in range(max(reps, 3)):
        t0 = time.perf_counter()
        fence(short(init))
        t1 = time.perf_counter()
        fence(long_(init))
        t2 = time.perf_counter()
        slopes.append((t2 - t1) - (t1 - t0))
    # 0.0 = "below timer resolution", mirroring the reference's golden run
    # (out.txt reports 0 kernel times and inf MFLOPS at small sizes)
    return max(statistics.median(slopes), 0.0) / ((spread - 1) * iters)
