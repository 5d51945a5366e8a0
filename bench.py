"""Headline benchmark — prints ONE JSON line.

Protocol (ref main.cpp:187-188 + BASELINE.json config 3): 27-pt stencil,
nx=ny=nz=100, fixed work (max_iter=150, tolerance=0), f32, one device.
The timed region is the full jitted CG solve (SpMV + ddots + axpbys),
i.e. end-to-end CG throughput, not a kernel microbenchmark.

Metric: SpMV nonzeros processed per second through full CG iterations
(nnz_model * niters / t, nnz_model = 27*nrow, the reference's own FLOP-model
convention, main.cpp:226).

vs_baseline: the reference publishes no numbers (BASELINE.md), so the baseline
is the reference *format's* speed-of-light on THIS card: an explicit CSR SpMV
must move >= 12 B per nonzero (8 B value + 4 B column index), so
SOL_ref = HBM_BW / 12 nnz/s. vs_baseline = ours / SOL_ref. Values > 1 mean we
exceed what the reference's data structure could ever reach on this hardware
(possible because the stencil operator never materializes the matrix).
"""

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp


# device_kind -> device-memory bandwidth in GB/s. Source: NVIDIA H200 Tensor
# Core GPU data sheet (SXM part: 141 GB HBM3e at 4.8 TB/s).
HBM_GBPS = {
    "NVIDIA H200": 4800.0,
}


def hbm_bandwidth_gbps(device) -> float:
    """Peak device-memory bandwidth of ``device``; an unknown device is an
    error, never a default."""
    kind = getattr(device, "device_kind", "")
    if kind not in HBM_GBPS:
        raise KeyError(
            f"no peak bandwidth for device kind {kind!r}; add it to "
            "bench.HBM_GBPS with its source"
        )
    return HBM_GBPS[kind]


def main():
    from hpccg_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=100)
    ap.add_argument("--ny", type=int, default=100)
    ap.add_argument("--nz", type=int, default=100)
    ap.add_argument("--stencil", type=int, default=27, choices=[7, 27])
    ap.add_argument("--max-iter", type=int, default=150)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument(
        "--backend",
        default="auto",
        help="auto | stencil (XLA) | triton (fused direction kernel)",
    )
    ap.add_argument(
        "--preset",
        choices=["parity32", "fused64", "headline100", "weak-unit", "strong256"],
        help="BASELINE.json config shortcuts: parity32 = 27-pt 32^3 "
        "(config 1), fused64 = 7-pt 64^3 (config 2), headline100 = 27-pt "
        "100^3 (config 3, the default), weak-unit = the 100^3 per-device "
        "weak-scaling block (config 4; multi-device runs via "
        "hpccg_tpu.sweep), strong256 = global 256^3 on this device "
        "(config 5)",
    )
    args = ap.parse_args()

    dev = jax.devices()[0]
    peak_gbps = hbm_bandwidth_gbps(dev)  # fail before any work off the card

    if args.preset:
        import sys as _sys

        if (args.nx, args.ny, args.nz, args.stencil) != (100, 100, 100, 27):
            print(
                "# --preset overrides --nx/--ny/--nz/--stencil",
                file=_sys.stderr,
            )
        dims = {
            "parity32": (32, 27),
            "fused64": (64, 7),
            "headline100": (100, 27),
            "weak-unit": (100, 27),
            "strong256": (256, 27),
        }[args.preset]
        args.nx = args.ny = args.nz = dims[0]
        args.stencil = dims[1]

    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.solver import make_cg, resolve_backend
    from hpccg_tpu.utils.device import card_info
    from hpccg_tpu.utils.timing import fence, time_loop_body

    dtype = jnp.dtype(args.dtype)
    cfg = ProblemConfig(args.nx, args.ny, args.nz, stencil=args.stencil, dtype=dtype)
    prob = generate_problem(cfg)
    args.backend = resolve_backend(prob.A, args.backend)

    def timed(max_iter):
        solve = make_cg(prob.A, max_iter=max_iter, tolerance=0.0, backend=args.backend)
        fence(solve(prob.b, prob.x0))  # compile
        fence(solve(prob.b, prob.x0))
        times = []
        res = None
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = solve(prob.b, prob.x0)
            fence(res)
            times.append(time.perf_counter() - t0)
        return min(times), res

    # Slope timing: the per-solve constant (launch, loop setup, trace
    # buffer) cancels between the two run lengths. The (short, long) pair is
    # measured INTERLEAVED several times and the median of the per-pair
    # slopes is taken — a pair shares one clock epoch.
    k1, k2 = 64, max(args.max_iter - 1, 256)
    solve1 = make_cg(prob.A, max_iter=k1 + 1, tolerance=0.0, backend=args.backend)
    solve2 = make_cg(prob.A, max_iter=k2 + 1, tolerance=0.0, backend=args.backend)
    res_short = solve1(prob.b, prob.x0)
    res_long = solve2(prob.b, prob.x0)
    # tiny problems can converge to an EXACTLY zero residual and exit the
    # tolerance=0 loop early; the slope stays valid over the iterations that
    # actually ran, as long as the two legs differ enough
    k1_real, k2_real = int(res_short.niters), int(res_long.niters)
    if k2_real < 2 * k1_real:
        raise RuntimeError(
            f"long leg exited too early for slope timing ({k2_real} vs "
            f"{k1_real} iterations); use a larger problem"
        )
    slopes = []
    for _ in range(max(args.reps, 3)):
        t0 = time.perf_counter()
        fence(solve1(prob.b, prob.x0))
        t1 = time.perf_counter()
        fence(solve2(prob.b, prob.x0))
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (k2_real - k1_real))
    per_iter = max(statistics.median(slopes), 1e-12)

    # the headline run itself (end-to-end, dispatch included)
    t_e2e, res = timed(args.max_iter)

    # the SpMV layer metric: the operator pass that the solve's backend runs
    # — the XLA stencil, or the fused direction kernel (r, p in; Ap out)
    # (vectors ride in the loop carry: closed-over arrays would be embedded
    # in the program as constants)
    if args.backend == "triton":
        from hpccg_tpu.ops.stencil_kernel import direction_kernel

        def spmv_body(c):
            r, v = c
            return r, direction_kernel(prob.A, r, v, 0.5)[0] * (1.0 / 54.0)

        passes = 3  # read r, p + write Ap
    else:

        def spmv_body(c):
            r, v = c
            return r, prob.A.matvec(v) * (1.0 / 54.0)

        passes = 2  # read x + write y
    t_spmv = time_loop_body(spmv_body, (prob.b, prob.b))
    spmv_bytes = passes * prob.total_nrow * dtype.itemsize
    spmv_gbps = spmv_bytes / t_spmv / 1e9 if t_spmv > 0 else float("inf")
    spmv_gnnz = (
        prob.total_nnz_model / t_spmv / 1e9 if t_spmv > 0 else float("inf")
    )

    niters = int(res.niters)
    nnz_model = prob.total_nnz_model
    nnz_per_s = nnz_model / per_iter
    value_gnnz = nnz_per_s / 1e9

    sol_ref_nnz_per_s = peak_gbps * 1e9 / 12.0
    vs_baseline = nnz_per_s / sol_ref_nnz_per_s

    iters_per_s = 1.0 / per_iter
    flops_per_iter = (4.0 + 6.0) * prob.total_nrow + 2.0 * nnz_model  # main.cpp:224-227

    print(
        json.dumps(
            {
                "metric": "CG SpMV throughput (stencil*n nnz model), one device",
                "value": round(value_gnnz, 3),
                "unit": "Gnnz/s",
                "vs_baseline": round(vs_baseline, 3),
                "extras": {
                    "platform": dev.platform,
                    "device": dev.device_kind,
                    "device_count": len(jax.devices()),
                    "card": card_info(),
                    "backend": args.backend,
                    "problem": f"{args.nx}x{args.ny}x{args.nz} {args.stencil}-pt {args.dtype}",
                    "niters": niters,
                    "cg_iter_us": round(per_iter * 1e6, 2),
                    "spmv_us": round(t_spmv * 1e6, 2),
                    f"spmv_gbps_{passes}pass": round(spmv_gbps, 1),
                    "spmv_gnnz_per_s": round(spmv_gnnz, 1),
                    "cg_iters_per_s": round(iters_per_s, 1),
                    "solve_e2e_s": round(t_e2e, 6),
                    "mflops_model": round(flops_per_iter / per_iter / 1e6, 1),
                    "final_normr": float(res.normr),
                    "timing": f"slope between {k1+1}- and {k2+1}-iteration solves",
                    "vs_baseline_def": "ours / (HBM_BW/12B-per-nnz), the reference CSR format's per-device speed-of-light",
                },
            }
        )
    )


if __name__ == "__main__":
    main()
