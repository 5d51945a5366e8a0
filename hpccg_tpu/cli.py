"""CLI driver (ref main.cpp:99-324).

Usage:
    python -m hpccg_tpu nx ny nz [options]     # generated stencil problem
    python -m hpccg_tpu datafile [options]     # HPC-row file (deprecated path)

Reproduces the reference driver end-to-end: per-iteration residual lines,
the FLOP model (main.cpp:224-227), and the YAML report with the reference's
key schema (Time/FLOPS/MFLOPS summaries) — plus a Mesh block in place of the
SYCL device printout, and distributed-overhead sections mirroring the MPI
build's DDOT Timing Variations / SPARSEMV OVERHEADS blocks.

One deliberate difference: the reference times kernels with in-loop TICK/TOCK
macros (HPCCG.cpp:71-72), which would require breaking the fused jitted loop.
Here the whole-solve time is measured directly and per-kernel times come from
phase-separated micro-benchmarks of the same jitted kernels (SURVEY.md §5),
scaled by per-iteration call counts (2 ddot, 3 waxpby, 1 spmv — HPCCG.cpp
:367-384).
"""

from __future__ import annotations

import argparse
import sys
import time
from functools import partial

import numpy as np

from hpccg_tpu.solver import BACKENDS


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hpccg_tpu",
        description="HPCCG in JAX: 3-D stencil conjugate gradient benchmark",
    )
    ap.add_argument("dims", nargs="+", help="nx ny nz, or an HPC-row data file")
    ap.add_argument("--stencil", type=int, default=27, choices=[27, 7])
    ap.add_argument("--max-iter", type=int, default=150, help="ref main_old.cpp:166 default; main.cpp uses 500 (--preset ref500)")
    ap.add_argument("--tolerance", type=float, default=0.0)
    ap.add_argument(
        "--preset",
        choices=["ref500", "ref150"],
        help="solve-protocol shortcuts: ref500 = max_iter 500, tolerance 0 "
        "(the reference benchmark protocol, main.cpp:187-188); ref150 = "
        "max_iter 150 (main_old.cpp:166). Overrides --max-iter/--tolerance",
    )
    ap.add_argument("--dtype", default="float64", choices=["float64", "float32", "bfloat16"])
    ap.add_argument(
        "--mesh",
        default="1",
        metavar="N|HxZ",
        help="device mesh: a plain integer N builds the 1-D z mesh; HxZ "
        "(e.g. 2x4) builds the explicit 2-D ('host','z') mesh — same row "
        "layout, with the host tier as its own named axis so only "
        "hosts-1 halo pairs cross hosts (parallel/mesh.py)",
    )
    ap.add_argument(
        "--backend",
        default="auto",
        choices=list(BACKENDS),
        help="generated problem on one device: stencil = the XLA stencil, "
        "triton = the fused direction kernel (ops/stencil_kernel.py), auto "
        "= the one measured faster (solver.resolve_backend); explicit "
        "matrices and meshes always use their own XLA path",
    )
    ap.add_argument(
        "--method",
        default="cg",
        choices=["cg", "cg1", "pipecg"],
        help="cg: the reference recurrence (2 reductions/iter); cg1: "
        "Chronopoulos-Gear single-reduction CG (1 fused psum/iter); pipecg: "
        "Ghysels-Vanroose pipelined CG (the psum overlaps the SpMV)",
    )
    ap.add_argument(
        "--rr-every",
        type=int,
        default=0,
        metavar="K",
        help="residual replacement for --method cg1/pipecg: re-anchor the "
        "recurrence residual to the true b - A x every K iterations (one "
        "extra matvec) — cures the f32 recurrence flush-to-zero on long "
        "tolerance=0 runs; 0 = off. Applies to single-device and every "
        "distributed path",
    )
    ap.add_argument("--report-file", action="store_true", help="also write the timestamped .yaml")
    ap.add_argument("--json", action="store_true", help="emit JSON instead of YAML")
    ap.add_argument("--quiet", action="store_true", help="suppress residual lines")
    ap.add_argument("--dump-matlab", metavar="PREFIX", help="dump COO triplets (ref dump_matlab_matrix.cpp)")
    ap.add_argument(
        "--no-reorder",
        action="store_true",
        help="file mode: disable RCM bandwidth-reducing reordering (solve "
        "in the file's original row order even if a hidden band exists)",
    )
    ap.add_argument(
        "--stream-load",
        action="store_true",
        help="file mode at --mesh > 1: bounded-memory distributed loading — "
        "each process streams ONLY its devices' row blocks straight onto "
        "those devices (the reference's per-rank read, "
        "read_HPC_row.cpp:255-293); the global matrix is never materialized "
        "on any host. Trades structure analysis (RCM/DIA need the "
        "assembled matrix) for O(n/N) per-process memory: the solve runs "
        "the general all-gather ELL path",
    )
    ap.add_argument("--skip-kernel-bench", action="store_true", help="skip per-kernel micro-benchmarks")
    ap.add_argument(
        "--check",
        action="store_true",
        help="report max|x - xexact| (ref compute_residual, main.cpp:310-316 "
        "— commented out in the reference) and the true residual "
        "||b - A x|| after the solve",
    )
    ap.add_argument(
        "--validate",
        action="store_true",
        help="verify problem invariants before solving (A@xexact == b, "
        "symmetry) and fail fast on a non-finite result",
    )
    ap.add_argument(
        "--init-distributed",
        action="store_true",
        help="call jax.distributed.initialize() first (multi-host runs; "
        "coordinator and process ids from the cluster environment JAX "
        "detects)",
    )
    ap.add_argument(
        "--refine",
        type=int,
        default=0,
        metavar="N",
        help="mixed-precision iterative refinement: N outer f64 residual "
        "rounds around f32 inner solves (requires --dtype float64); "
        "f64-floor accuracy from half-width f32 vector traffic",
    )
    ap.add_argument(
        "--profile",
        metavar="DIR",
        help="capture a jax.profiler device trace of the solve into DIR "
        "(the device-side analog of the TICK/TOCK kernel timers)",
    )
    return ap


def parse_mesh(spec) -> tuple:
    """'N' -> (N, None); 'HxZ' -> (H*Z, (H, Z))."""
    spec = str(spec)
    if "x" in spec:
        try:
            h, z = (int(p) for p in spec.split("x"))
        except ValueError:
            raise SystemExit(f"error: --mesh {spec!r} is not N or HxZ")
        if h < 1 or z < 1:
            raise SystemExit(f"error: --mesh {spec!r} needs positive factors")
        return h * z, (h, z)
    try:
        return int(spec), None
    except ValueError:
        raise SystemExit(f"error: --mesh {spec!r} is not N or HxZ")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.preset:
        args.max_iter = {"ref500": 500, "ref150": 150}[args.preset]
        args.tolerance = 0.0
    args.mesh, mesh2d_shape = parse_mesh(args.mesh)

    import jax

    from hpccg_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    if args.init_distributed:
        jax.distributed.initialize()
    # multi-host: only process 0 prints/writes (every process still computes)
    if jax.process_index() != 0:
        args.quiet = True
        args.report_file = False

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.ops.spmv import spmv
    from hpccg_tpu.ops.vector import ddot
    from hpccg_tpu.ops.vector import waxpby as waxpby_op
    from hpccg_tpu.solver import make_cg
    from hpccg_tpu.utils.report import Report
    from hpccg_tpu.utils.timing import fence

    dtype = jnp.dtype(args.dtype)

    def build_mesh():
        """(mesh, row axis) for --mesh: 1-D 'z' or 2-D ('host','z')."""
        from hpccg_tpu.parallel import make_mesh, make_mesh2d, row_axis

        if mesh2d_shape is not None:
            m = make_mesh2d(*mesh2d_shape)
            return m, row_axis(m)
        return make_mesh(args.mesh), "z"

    file_mode = len(args.dims) == 1 and not args.dims[0].isdigit()
    mesh = None
    axis = "z"
    if file_mode and args.stream_load:
        if args.mesh <= 1:
            print(
                "# --stream-load needs --mesh > 1 (distributed loading); "
                "ignoring",
                file=sys.stderr,
            )
            args.stream_load = False
        elif args.backend != "auto":
            print(
                f"# --stream-load runs the all-gather ELL path; ignoring "
                f"--backend {args.backend}",
                file=sys.stderr,
            )
            args.backend = "auto"
    if file_mode and args.stream_load:
        # bounded-memory distributed loading: blocks stream straight onto
        # their devices; no host ever holds the matrix
        from hpccg_tpu.io import read_hpc_row_sharded
        from hpccg_tpu.parallel import make_distributed_ell_cg

        mesh, axis = build_mesh()
        prob, _x_file = read_hpc_row_sharded(args.dims[0], mesh, axis=axis, dtype=dtype)
        perm = None
        file_nrow = prob.total_nrow
        nx = ny = nz = 0
        print(
            "# stream-load: per-device row blocks, all-gather ELL solve "
            "(structure analysis skipped — it needs the assembled matrix)",
            file=sys.stderr,
        )
        _esolve = make_distributed_ell_cg(
            mesh, max_iter=args.max_iter, tolerance=args.tolerance, axis=axis,
            method=args.method, replace_every=args.rr_every,
        )
        solve = partial(_esolve, prob.A)
        backend_used = "distributed:ell-allgather(stream)"
        spmv_bench_make_loop = spmv_bench_tier = None
        if not args.skip_kernel_bench:
            from hpccg_tpu.parallel.cg import make_distributed_spmv_bench

            try:
                spmv_bench_make_loop, spmv_bench_tier = (
                    make_distributed_spmv_bench(mesh, prob.A, axis=axis)
                )
            except (ValueError, TypeError) as e:
                print(
                    f"# distributed kernel bench unavailable: {e}",
                    file=sys.stderr,
                )
                args.skip_kernel_bench = True
    elif file_mode:
        from hpccg_tpu.io import pad_problem_rows, read_hpc_row_structured

        prob, perm, report = read_hpc_row_structured(
            args.dims[0], dtype=dtype, reorder=not args.no_reorder,
        )
        print(f"# matrix structure: {report.format} — {report.reason}", file=sys.stderr)
        file_nrow = prob.total_nrow  # before any --mesh row padding
        nx = ny = nz = 0
        solve = None
        backend_used = None
        if args.mesh > 1:
            # distributed file mode (ref main.cpp:161-179: read_HPC_row ->
            # make_local_matrix -> MPI CG): banded matrices ride the
            # ppermute halo path, unstructured ELL the all-gather path
            import dataclasses as _dc

            from hpccg_tpu.operators import DiaMatrix
            from hpccg_tpu.parallel import (
                make_distributed_dia_cg,
                make_distributed_ell_cg,
            )
            from hpccg_tpu.parallel.cg import dia_halo_plan, shard_problem

            if args.backend != "auto":
                print(
                    "# distributed file mode picks its path by matrix "
                    f"structure; ignoring --backend {args.backend}",
                    file=sys.stderr,
                )
            mesh, axis = build_mesh()
            prob = pad_problem_rows(prob, args.mesh)
            A = prob.A
            if isinstance(A, DiaMatrix):
                dia_halo_ok, dia_reason = dia_halo_plan(A, prob.total_nrow // args.mesh)
                if not dia_halo_ok:
                    # band wider than one shard, or too many diagonals:
                    # take the general all-gather path instead
                    print(
                        f"# {dia_reason}; using the all-gather ELL path",
                        file=sys.stderr,
                    )
                    prob = _dc.replace(prob, A=A.to_ell())
            if isinstance(prob.A, DiaMatrix):
                _dsolve = make_distributed_dia_cg(
                    mesh, max_iter=args.max_iter,
                    tolerance=args.tolerance, axis=axis,
                    method=args.method, replace_every=args.rr_every,
                )
                solve = partial(_dsolve, prob.A)
                backend_used = "distributed:dia-halo"
            else:
                prob = shard_problem(prob, mesh, axis=axis)
                _esolve = make_distributed_ell_cg(
                    mesh, max_iter=args.max_iter,
                    tolerance=args.tolerance, axis=axis,
                    method=args.method, replace_every=args.rr_every,
                )
                solve = partial(_esolve, prob.A)
                backend_used = "distributed:ell-allgather"
            spmv_bench_make_loop = spmv_bench_tier = None
            if not args.skip_kernel_bench:
                # per-kernel rows for the Time Summary: bench the
                # distributed path that actually solves
                from hpccg_tpu.parallel.cg import make_distributed_spmv_bench

                try:
                    spmv_bench_make_loop, spmv_bench_tier = (
                        make_distributed_spmv_bench(mesh, prob.A, axis=axis)
                    )
                except (ValueError, TypeError) as e:
                    print(
                        f"# distributed kernel bench unavailable: {e}",
                        file=sys.stderr,
                    )
                    args.skip_kernel_bench = True
    else:
        if len(args.dims) != 3:
            print("error: expected 'nx ny nz' or one data file", file=sys.stderr)
            return 2
        nx, ny, nz = (int(d) for d in args.dims)
        cfg = ProblemConfig(nx, ny, nz, stencil=args.stencil, dtype=dtype)
        if args.mesh > 1:
            from hpccg_tpu.parallel import generate_problem_sharded, make_distributed_cg

            mesh, axis = build_mesh()
            prob = generate_problem_sharded(cfg, mesh, axis=axis)
            if args.backend != "auto":
                # the sharded stencil runs the XLA halo matvec only (the
                # fused kernel takes no halo planes)
                print(
                    f"# --backend {args.backend} applies to one device; the "
                    "mesh runs the XLA halo stencil",
                    file=sys.stderr,
                )
            solve = make_distributed_cg(
                cfg,
                mesh,
                max_iter=args.max_iter,
                tolerance=args.tolerance,
                axis=axis,
                method=args.method,
                replace_every=args.rr_every,
            )
            backend_used = "distributed:stencil-halo"
        else:
            prob = generate_problem(cfg)
            solve = None
            backend_used = None

    if args.refine > 0 and solve is not None:
        # a distributed (or otherwise pre-built) solve ignores --refine; zero
        # it so the reporting path doesn't mislabel CG iterations as
        # refinement rounds
        print(
            "# --refine is a single-device path; ignoring it for this "
            "solve (use --mesh 1)",
            file=sys.stderr,
        )
        args.refine = 0

    if solve is None and args.refine > 0:
        if args.dtype != "float64":
            print("error: --refine requires --dtype float64", file=sys.stderr)
            return 2
        from hpccg_tpu.solver import cg_solve_refined

        backend_used = f"refine({args.backend})"

        def solve(b, x0):  # noqa: F811
            return cg_solve_refined(
                prob.A,
                b,
                x0,
                inner_max_iter=args.max_iter,
                outer_max_iter=args.refine,
                tolerance=args.tolerance,
                backend=args.backend,
                method=args.method,
                replace_every=args.rr_every,
            )

    if solve is None:
        from hpccg_tpu.solver import resolve_backend
        import warnings as _warnings

        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")  # make_cg re-emits any warning
            backend_used = resolve_backend(prob.A, args.backend)
        if backend_used == "auto":
            backend_used = f"native({type(prob.A).__name__})"
        solve = make_cg(
            prob.A,
            max_iter=args.max_iter,
            tolerance=args.tolerance,
            backend=args.backend,
            method=args.method,
            replace_every=args.rr_every,
        )

    if args.dump_matlab:
        from hpccg_tpu.io import dump_matlab

        if args.mesh > 1 and not file_mode:
            # per-shard dumps mat0..mat3, exactly the reference's per-rank
            # files (dump_matlab_matrix.cpp:59-82; ranks > 3 are no-ops).
            # generate_ell(cfg, rank, size) emits each shard's rows WITH the
            # cross-shard z-couplings and global column ids — the clipped
            # local operator would describe a block-diagonal matrix
            from hpccg_tpu.models.stencil import generate_ell

            for r in range(min(args.mesh, 4)):
                shard = generate_ell(cfg, r, args.mesh).A
                path = dump_matlab(args.dump_matlab, shard, rank=r)
                print(f"# wrote {path}", file=sys.stderr)
        elif file_mode:
            # dump in the FILE's basis (ref dump_matlab_matrix reflects the
            # input ordering): unpermute RCM, strip --mesh pad rows
            path = dump_matlab(
                args.dump_matlab, prob.A, perm=perm, true_nrow=file_nrow
            )
            if perm is not None:
                print(
                    "# dump is in the loaded file's original row order "
                    "(RCM solve basis unpermuted)",
                    file=sys.stderr,
                )
            print(f"# wrote {path}", file=sys.stderr)
        else:
            path = dump_matlab(args.dump_matlab, prob.A)
            print(f"# wrote {path}", file=sys.stderr)

    if args.validate:
        if args.mesh <= 1:
            from hpccg_tpu.utils.checks import validate_problem

            findings = validate_problem(prob)
            print(f"# problem validated: {findings}", file=sys.stderr)
        else:
            print(
                "# --validate: pre-solve invariant checks run single-device "
                "only; post-solve finiteness check still applies",
                file=sys.stderr,
            )

    # --- solve (compile excluded from the timed run, like the reference's
    # post-setup chrono window, main.cpp:189-197) ---
    fence(solve(prob.b, prob.x0))
    if args.profile:
        import jax.profiler

        with jax.profiler.trace(args.profile):
            fence(solve(prob.b, prob.x0))
        print(f"# profiler trace written to {args.profile}", file=sys.stderr)
    t0 = time.perf_counter()
    res = solve(prob.b, prob.x0)
    fence(res)
    t_total = time.perf_counter() - t0

    niters = int(res.niters)
    normr = float(res.normr)
    trace = np.asarray(res.trace).astype(np.float64)  # bf16 scalars do not format

    check_residual = true_residual = None
    if args.check:
        from hpccg_tpu.ops.vector import compute_residual

        # jitted: eager op-by-op evaluation would materialize every
        # intermediate of the stencil at full size
        @jax.jit
        def _checks(A_, x, b, xexact):
            r = b - spmv(A_, x)
            return compute_residual(x, xexact), jnp.sqrt(ddot(r, r))

        check_residual, true_residual = (
            float(v) for v in _checks(prob.A, res.x, prob.b, prob.xexact)
        )
        print(f"Difference between computed and exact = {check_residual:.6g}")
        print(f"True residual ||b - A x|| = {true_residual:.6g}")

    if args.validate:
        from hpccg_tpu.utils.checks import check_finite

        check_finite(res)

    if not args.quiet:
        if args.refine > 0:
            print(f"Initial Residual = {trace[0]:.6g}")
            for k in range(1, len(trace)):
                if np.isfinite(trace[k]):
                    print(f"Refinement round = {k}   Residual = {trace[k]:.6g}")
        else:
            # ref HPCCG.cpp:342-344,356,372-373
            print_freq = min(max(args.max_iter // 10, 1), 50)
            print(f"Initial Residual = {trace[0]:.6g}")
            for k in range(1, niters + 1):
                if k % print_freq == 0 or k + 1 == args.max_iter:
                    print(f"Iteration = {k}   Residual = {trace[k]:.6g}")
    print(f"Elapsed time: {t_total:.6g} s", file=sys.stderr)

    # --- FLOP model (main.cpp:217-227) ---
    fniters = float(niters)
    fnrow = float(prob.total_nrow)
    fnnz = float(prob.total_nnz_model)
    fnops_ddot = fniters * 4 * fnrow
    fnops_waxpby = fniters * 6 * fnrow
    fnops_sparsemv = fniters * 2 * fnnz
    fnops = fnops_ddot + fnops_waxpby + fnops_sparsemv

    # --- per-kernel micro-benchmarks for the Time Summary ---
    # Per-kernel times via amortized in-jit loops (dispatch latency would
    # otherwise dominate ms-scale kernels). waxpby chains naturally
    # (w <- x + 0.5w); ddot is measured differentially from a fused
    # waxpby+ddot loop; spmv chains with a 1/54 rescale to avoid overflow.
    t_ddot = t_waxpby = t_spmv = float("nan")
    if not args.skip_kernel_bench:
        from hpccg_tpu.utils.timing import time_loop_body

        # every array rides in the loop carry: a closed-over vector would be
        # embedded in the program as a constant (at deployment size, GBs of
        # HLO that take minutes to compile and overflow the 2 GB cache
        # entry limit)
        def wax_body(c):
            x_in, w = c
            return x_in, waxpby_op(1.0, x_in, 0.5, w)

        def combo_body(c):
            x_in, w, s = c
            w = waxpby_op(1.0, x_in, 0.5, w)
            return x_in, w, s + ddot(w, w)

        t_wax1 = time_loop_body(wax_body, (prob.b, prob.x0))
        t_combo = time_loop_body(
            combo_body, (prob.b, prob.x0, jnp.zeros((), prob.b.dtype))
        )
        t_ddot1 = max(t_combo - t_wax1, 0.0)

        from hpccg_tpu.utils.timing import time_loop_slope

        if args.mesh > 1 and file_mode:
            # the distributed file-mode path's per-shard kernel (built above
            # by make_distributed_spmv_bench; exchange cost is separate, as
            # in the reference's times[5])
            t_spmv1 = time_loop_slope(spmv_bench_make_loop, prob.x0)
        elif args.mesh > 1:
            from jax.sharding import PartitionSpec as P

            from hpccg_tpu.parallel.cg import local_operator
            from hpccg_tpu.parallel.halo import stencil_matvec_halo

            op_local = local_operator(cfg)

            def spmv_once(v):
                return stencil_matvec_halo(op_local, v, axis) * (1.0 / 54.0)

            def make_spmv_loop(k):
                return jax.jit(
                    jax.shard_map(
                        lambda v: jax.lax.fori_loop(0, k, lambda i, c: spmv_once(c), v),
                        mesh=mesh,
                        in_specs=P(axis),
                        out_specs=P(axis),
                    )
                )

            t_spmv1 = time_loop_slope(make_spmv_loop, prob.x0)
        else:
            # the XLA matvec of the operator (a fused-kernel solve has no
            # standalone SpMV; the Time Summary note says which ran). A rides
            # in the loop carry too
            t_spmv1 = time_loop_body(
                lambda c: (c[0], spmv(c[0], c[1]) * (1.0 / 54.0)),
                (prob.A, prob.x0),
            )
        t_ddot = t_ddot1 * 2 * fniters
        t_waxpby = t_wax1 * 3 * fniters
        t_spmv = t_spmv1 * fniters

    # --- report (main.cpp:230-304 schema) ---
    doc = Report("hpccg-tpu", "1.0")
    par = doc.add("Parallelism")
    ndev = args.mesh
    par.add("Number of mesh devices", ndev)
    par.add(
        "Mesh axes",
        ("(single device)" if ndev <= 1
         else repr(tuple(mesh.axis_names)) if mesh2d_shape is not None
         else "z"),
    )
    from hpccg_tpu.utils.device import card_info

    par.add("Device kind", getattr(jax.devices()[0], "device_kind", "unknown"))
    par.add("Card name and power limit", card_info())
    par.add("Platform", jax.default_backend())
    par.add("MPI not enabled (collectives via XLA: NCCL on GPUs)", "")

    dims = doc.add("Dimensions")
    dims.add("nx", nx)
    dims.add("ny", ny)
    dims.add("nz", nz)
    if ndev > 1:
        dims.add("global nz", nz * ndev)
    dims.add("stencil", args.stencil)
    dims.add("dtype", args.dtype)

    doc.add("Number of iterations", niters)
    doc.add("Final residual", normr)
    if args.json:
        # the whole trajectory at full precision (the printed lines keep the
        # reference's 6 digits and every print_freq-th iteration)
        doc.add("Residual history", [float(v) for v in trace[: niters + 1]])
    if check_residual is not None:
        doc.add("Difference between computed and exact", check_residual)
        doc.add("True residual", true_residual)
    doc.add("#********** Performance Summary (times in sec) ***********", "")

    ts = doc.add("Time Summary")
    ts.add("Total   ", t_total)
    ts.add("DDOT    ", t_ddot)
    ts.add("WAXPBY  ", t_waxpby)
    ts.add("SPARSEMV", t_spmv)
    bench_tier_note = (
        f" (SPARSEMV row benches the {spmv_bench_tier} per-shard kernel)"
        if file_mode and args.mesh > 1 and not args.skip_kernel_bench
        else ""
    )
    ts.add(
        f"(DDOT/WAXPBY/SPARSEMV are phase-separated micro-benchmarks of the "
        f"XLA kernels; Total timed backend={backend_used or args.backend} "
        f"— for the fused triton backend the kernel rows are NOT components of Total"
        f"{bench_tier_note})",
        "",
    )

    fl = doc.add("FLOPS Summary")
    fl.add("Total   ", fnops)
    fl.add("DDOT    ", fnops_ddot)
    fl.add("WAXPBY  ", fnops_waxpby)
    fl.add("SPARSEMV", fnops_sparsemv)

    def mflops(ops: float, t: float) -> float:
        # t == 0 means "below timer resolution"; C++ prints inf (out.txt:33-37)
        if t != t:  # skipped bench -> NaN
            return float("nan")
        return ops / t / 1e6 if t > 0 else float("inf")

    mf = doc.add("MFLOPS Summary")
    mf.add("Total   ", mflops(fnops, t_total))
    mf.add("DDOT    ", mflops(fnops_ddot, t_ddot))
    mf.add("WAXPBY  ", mflops(fnops_waxpby, t_waxpby))
    mf.add("SPARSEMV", mflops(fnops_sparsemv, t_spmv))

    if ndev > 1 and not args.skip_kernel_bench:
        # distributed overheads (analog of main.cpp:284-299)
        from jax.sharding import PartitionSpec as P

        # allreduce latency, slope-timed in-jit (the carry feeds each psum)
        def make_psum_loop(k):
            # pcast re-varies the psum'd carry so the fori_loop carry types
            # match on multi-axis meshes (psum over the full tuple makes the
            # scalar invariant, but the initial vdot is varying)
            def loop(v):
                s = jax.lax.fori_loop(
                    0,
                    k,
                    lambda i, s: jax.lax.pcast(
                        jax.lax.psum(s, axis) * (1.0 / ndev),
                        axis,
                        to="varying",
                    ),
                    ddot(v, v),
                )
                # one final psum makes the P() output invariant again
                return jax.lax.psum(s, axis) * (1.0 / ndev)

            return jax.jit(
                jax.shard_map(loop, mesh=mesh, in_specs=P(axis), out_specs=P())
            )

        t_psum = time_loop_slope(make_psum_loop, prob.b) * 2 * fniters
        # ref main.cpp:201-210,285-288 reports min/max/avg of the ddot MPI
        # time across ranks. XLA mesh collectives complete in lockstep (one
        # fused program, every device leaves the psum together), so the
        # cross-device spread the MPI build measures is structurally zero —
        # report the same schema keys with that one value, and say why.
        dv = doc.add("DDOT Timing Variations")
        dv.add("Min DDOT MPI_Allreduce time", t_psum)
        dv.add("Max DDOT MPI_Allreduce time", t_psum)
        dv.add("Avg DDOT MPI_Allreduce time", t_psum)
        dv.add("(XLA psum is lockstep across the mesh: min == max == avg)", "")
        ov = doc.add("SPARSEMV OVERHEADS")
        ov.add("SPARSEMV MFLOPS W OVERHEAD", mflops(fnops_sparsemv, t_spmv))
        ov.add("SPARSEMV PARALLEL OVERHEAD note", "halo exchange is fused into the SpMV (ppermute)")

    if jax.process_index() == 0:
        print(doc.to_json() if args.json else doc.generate_yaml(), end="")
    if args.report_file:
        path = doc.write(fmt="json" if args.json else "yaml")
        print(f"# wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
