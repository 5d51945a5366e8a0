#!/usr/bin/env python3
"""Where a CG iteration's device time goes: profiler traces of a short and
a long fixed-work solve per (grid, dtype, backend), reduced to device time
per iteration, kernels per iteration, the device's idle share and the
largest kernels. The per-iteration figures are the difference of the two
solves, so the per-solve set-up cancels.

    python3 tools/trace_cg.py                  # 100^3 f32, 256^3 f32, 256^3 f64,
                                               # XLA stencil and Triton kernel
    python3 tools/trace_cg.py --cells 256:float64 --backends stencil --out DIR

Needs a GPU: the reduction reads the trace's GPU stream tracks. Runs are
made in the order given, each traced after a warm-up solve. Tracing adds
its own cost to every launch, so the idle share at launch-bound sizes reads
high against an untraced run. Prints one line per run and, last, the
reduced records as one JSON list. ``--out`` keeps
the raw traces (perfetto JSON and xplane) there.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import tempfile
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_CELLS = ("100:float32", "256:float32", "256:float64")


def reduce_trace(events) -> dict:
    """Totals of one traced solve from its perfetto trace events.

    Device work is every complete ("X") event on a thread named "Stream..."
    of a process whose name holds "GPU". The window runs from the first such
    event's start to the last one's end; busy time is the part of it in
    which some stream ran something."""
    proc, thread = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc[e["pid"]] = e["args"]["name"]
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            thread[(e["pid"], e["tid"])] = e["args"]["name"]
    streams = {
        key for key, name in thread.items()
        if "GPU" in proc.get(key[0], "") and name.lower().startswith("stream")
    }
    work = [e for e in events
            if e.get("ph") == "X" and (e.get("pid"), e.get("tid")) in streams]
    if not work:
        tracks = sorted(f"{proc.get(p, p)} / {n}" for (p, _), n in thread.items())
        raise ValueError(f"no GPU stream events in the trace; tracks: {tracks}")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in work)
    busy, cur_lo, cur_hi = 0.0, spans[0][0], spans[0][1]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    by_name = defaultdict(lambda: [0, 0.0])
    for e in work:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += float(e.get("dur", 0))
    return {
        "window_us": max(hi for _, hi in spans) - spans[0][0],
        "busy_us": busy,
        "kernels": len(work),
        "by_name": {k: tuple(v) for k, v in by_name.items()},
    }


def per_iteration(short: dict, long: dict, k_short: int, k_long: int, top: int = 8) -> dict:
    """Per-iteration figures from the totals of a short and a long solve of
    the same problem: their difference over ``k_long - k_short`` iterations,
    so the per-solve set-up (initial residual, trace buffer) cancels."""
    dk = k_long - k_short
    window = (long["window_us"] - short["window_us"]) / dk
    busy = (long["busy_us"] - short["busy_us"]) / dk
    largest = []
    for name, (calls, total) in long["by_name"].items():
        c0, t0 = short["by_name"].get(name, (0, 0.0))
        if calls > c0:
            largest.append({"name": name, "us_per_call": (total - t0) / (calls - c0),
                            "calls_per_iter": (calls - c0) / dk,
                            "us_per_iter": (total - t0) / dk})
    largest.sort(key=lambda k: -k["us_per_iter"])
    return {
        "device_us_per_iter": window,
        "busy_us_per_iter": busy,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "kernels_per_iter": (long["kernels"] - short["kernels"]) / dk,
        "largest": largest[:top],
    }


def trace_solve(n: int, dtype_name: str, backend: str, iters: int, out_dir: str) -> dict:
    """Trace solves of ``iters`` and ``3 * iters`` CG iterations (each after
    a warm-up call) and reduce them to per-iteration figures."""
    import jax
    import jax.numpy as jnp

    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.solver import make_cg

    prob = generate_problem(ProblemConfig(n, n, n, dtype=jnp.dtype(dtype_name)))
    totals, ks = [], []
    for k in (iters, 3 * iters):
        solve = make_cg(prob.A, max_iter=k + 1, tolerance=0.0, backend=backend)
        jax.block_until_ready(solve(prob.b, prob.x0))  # compile and warm
        run_dir = os.path.join(out_dir, f"{n}_{dtype_name}_{backend}_{k}")
        with jax.profiler.trace(run_dir, create_perfetto_trace=True):
            res = jax.block_until_ready(solve(prob.b, prob.x0))
        (path,) = glob.glob(os.path.join(run_dir, "**", "perfetto_trace.json.gz"),
                            recursive=True)
        with gzip.open(path) as f:
            doc = json.load(f)
        totals.append(reduce_trace(doc["traceEvents"] if isinstance(doc, dict) else doc))
        ks.append(int(res.niters))
    rec = per_iteration(totals[0], totals[1], ks[0], ks[1])
    rec.update(grid=n, dtype=dtype_name, backend=backend, iters=ks)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(DEFAULT_CELLS),
                    help="grid:dtype pairs, e.g. 256:float64 (a cube of that side)")
    ap.add_argument("--backends", nargs="+", default=["stencil", "triton"],
                    choices=["stencil", "triton"])
    ap.add_argument("--iters", type=int, default=10,
                    help="CG iterations of the short traced solve (the long one runs 3x)")
    ap.add_argument("--out", help="keep the raw traces in this directory")
    args = ap.parse_args(argv)

    import jax

    from hpccg_tpu.utils.cache import enable_compilation_cache
    from hpccg_tpu.utils.device import card_info

    enable_compilation_cache()
    if jax.devices()[0].platform != "gpu":
        print("error: the trace reduction reads GPU stream tracks; no GPU found",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    print(f"card: {card_info()}; jax {jax.__version__}", flush=True)
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or tmp
        for cell in args.cells:
            side, dtype_name = cell.split(":")
            for backend in args.backends:
                rec = trace_solve(int(side), dtype_name, backend, args.iters, out_dir)
                records.append(rec)
                big = ", ".join(f"{k['name'][:40]} {k['us_per_call']:.1f}"
                                for k in rec["largest"][:6])
                print(f"{side}^3 {dtype_name} {backend}: {rec['device_us_per_iter']:.1f} "
                      f"us/iter on the device, {rec['kernels_per_iter']:.1f} kernels/iter, "
                      f"idle share {rec['idle_share']:.3f}; largest (us per call): {big}",
                      flush=True)
    print(json.dumps(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
