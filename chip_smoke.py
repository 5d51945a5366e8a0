#!/usr/bin/env python3
"""On-card smoke test: drives the solver's main paths once on an NVIDIA GPU,
through the entry points a user calls, and checks each against the repo's
own references.

    python3 chip_smoke.py          # one card: phases 1-5
    python3 chip_smoke.py --four   # four cards: the sharded paths and their
                                   # one-card references, nothing else

Phases (one card):
  1. main path at deployment size: ``hpccg_tpu.cli.main`` on the generated
     27-point problem, f64, the reference's 500-iteration protocol, on a
     cube whose CG state fills at least 25% of the card's memory;
  2. golden parity: 10^3, f64, 150 iterations against the reference's
     checked-in trajectory (out.txt);
  3. f32 dot precision at 256^3 against f64, with a TF32 control; bf16;
  4. explicit matrices: 100^3 HPC-row files (banded and randomly permuted)
     through the CLI's file mode;
  5. the fused Triton direction kernel against the XLA stencil, and both
     timed end to end in the CG solve.

The process opens the card once (JAX reserves most of its memory) and
starts no other JAX process. It exits non-zero, printing no result, when
JAX finds no GPU or any check fails. Its last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stderr, redirect_stdout

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))  # the NumPy oracle's golden data

EPS64 = 2.0**-52
# problem sizes of phases 3-5 and of --four (phase 1 sizes itself from the
# card's memory)
PRECISION_N = 256  # 67 MB per f32 vector: past the 50 MB L2
EXPLICIT_N = 100  # the reference's 1 GB-per-rank file size (BASELINE.md)
KERNEL_N = 256
FOUR_LOCAL = (256, 256, 256)  # per card: a global 256x256x1024, z-sharded
FOUR_FILE_N = 64
FOUR_FILE_ITERS = "150"  # converges to the f64 floor, as phase 4 does
# --mesh 4 against --mesh 1, full-precision residuals above 1e-12 of the
# initial: only the psum order differs (4 CPU devices, 20^3: 8e-14)
FOUR_FILE_RTOL = 1e-10


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def deployment_grid(total_bytes, vectors=6, itemsize=8, share=0.25, multiple=8):
    """Smallest cube side (a multiple of ``multiple``) whose ``vectors`` CG
    vectors fill ``share`` of ``total_bytes`` — the reference's sizing rule,
    25-75% of memory (BASELINE.md)."""
    n = math.ceil((share * total_bytes / (vectors * itemsize)) ** (1.0 / 3.0))
    return -(-n // multiple) * multiple


def card_memory_bytes():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout
    return int(out.split()[0]) * 2**20


def run_cli(argv):
    """hpccg_tpu.cli.main in this process; (stdout, stderr)."""
    from hpccg_tpu.cli import main

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    check(rc == 0, f"cli {argv} exited {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def json_report(out):
    return json.loads(out[out.index("{"):])


def json_trace(rep):
    """{iteration: residual} at full precision from the CLI's JSON report."""
    return dict(enumerate(rep["Residual history"]))


def printed_trace(out):
    """{iteration: residual} from the CLI's residual lines (6 digits)."""
    trace = {}
    for line in out.splitlines():
        if line.startswith("Initial Residual = "):
            trace[0] = float(line.split("=")[1])
        elif line.startswith("Iteration = "):
            k, v = line[len("Iteration = "):].split("Residual =")
            trace[int(k)] = float(v)
    return trace


def peak_bytes(dev):
    return dev.memory_stats()["peak_bytes_in_use"]


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def phase_main(dev):
    total = card_memory_bytes()
    n = deployment_grid(total)
    state = 6 * 8 * n**3
    log(f"[1 main] grid {n}^3 f64 ({n**3} rows): 6 CG vectors = {state / 1e9:.2f} GB "
        f"= {state / total:.1%} of the card's {total / 1e9:.2f} GB")
    t0 = time.perf_counter()
    out, err = run_cli([str(n)] * 3 + [
        "--preset", "ref500", "--dtype", "float64", "--backend", "auto",
        "--check", "--json", "--quiet",
    ])
    wall = time.perf_counter() - t0
    rep = json_report(out)
    normr = rep["Final residual"]
    true_r = rep["True residual"]
    err_inf = rep["Difference between computed and exact"]
    ts, mf = rep["Time Summary"], rep["MFLOPS Summary"]
    peak = peak_bytes(dev)
    log(f"[1 main] niters={rep['Number of iterations']} normr={normr:.6g} "
        f"true ||b-Ax||={true_r:.6g} max|x-1|={err_inf:.6g}")
    log(f"[1 main] solve {ts['Total   ']:.6g} s ({ts['Total   '] / 499 * 1e3:.6g} ms/iter), "
        f"DDOT {ts['DDOT    ']:.6g} s, WAXPBY {ts['WAXPBY  ']:.6g} s, "
        f"SPARSEMV {ts['SPARSEMV']:.6g} s, {mf['Total   ']:.6g} MFLOPS; "
        f"CLI wall {wall:.1f} s; peak_bytes_in_use {peak} ({peak / total:.1%} of the card)")
    check(rep["Number of iterations"] == 499, "ref500 must run 499 iterations")
    # The printed normr is the recurrence residual, which keeps shrinking
    # past the true residual's rounding floor (CPU, 64^3: 3.5e-89 against
    # 6.5e-12). The true residual must sit at or below that floor:
    # 64 eps ||A||_inf ||x||_2, with ||A||_inf = 54 and ||x||_2 = sqrt(N).
    floor = 64 * EPS64 * 54 * math.sqrt(n**3)
    check(math.isfinite(true_r) and true_r <= max(normr, floor),
          f"true residual {true_r} above max(normr, floor {floor:.3g})")
    # kappa(A) < 54 (diagonal 27 against 26 off-diagonal -1s), so a residual
    # at the f64 floor bounds the error near 1e-14; 1e-10 leaves margin for
    # the card's summation order
    check(err_inf <= 1e-10, f"max|x - 1| = {err_inf} > 1e-10")
    check(peak >= 0.25 * total, "the CG state did not fill 25% of the card")


def phase_golden():
    from oracle import GOLDEN_10_NITERS, GOLDEN_10_TRACE

    out, _ = run_cli(["10", "10", "10", "--max-iter", "150", "--dtype", "float64",
                      "--skip-kernel-bench"])
    trace = printed_trace(out)
    check(f"Number of iterations: {GOLDEN_10_NITERS}" in out, "golden niters")
    rows = []
    for k, ref in GOLDEN_10_TRACE.items():
        rows.append(f"{k}:{trace[k]:.6g}/{ref:.6g}")
    log("[2 golden] iteration:card/out.txt " + " ".join(rows))
    # the CPU test's criteria (tests/test_solver.py::test_golden_out_txt_parity):
    # 6 significant digits where the trajectory is above rounding noise,
    # orders of magnitude in the deep-convergence tail
    check(abs(trace[0] / GOLDEN_10_TRACE[0] - 1) <= 1e-5, "initial residual")
    check(abs(trace[15] / GOLDEN_10_TRACE[15] - 1) <= 1e-4, "iteration 15")
    for k, ref in GOLDEN_10_TRACE.items():
        if k > 15:
            d = abs(math.log10(trace[k]) - math.log10(ref))
            check(d < 0.05 * abs(math.log10(ref)) + 1.0, f"golden tail at {k}")


def phase_precision():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.solver import cg_solve, make_cg

    n, iters, tol = PRECISION_N, 31, 1e-4
    p64 = generate_problem(ProblemConfig(n, n, n, dtype=jnp.float64))
    t64 = np.asarray(make_cg(p64.A, max_iter=iters)(p64.b, p64.x0).trace)
    del p64
    p32 = generate_problem(ProblemConfig(n, n, n, dtype=jnp.float32))

    def dev(res):
        return float(np.max(np.abs(np.asarray(res.trace, np.float64) - t64) / t64))

    def tf32_operands(u, v):
        # round each operand to TF32's 10-bit mantissa, as tensor cores do
        def rnd(x):
            b = jax.lax.bitcast_convert_type(x, jnp.uint32)
            b = (b + jnp.uint32(0x1000)) & jnp.uint32(0xFFFFE000)
            return jax.lax.bitcast_convert_type(b, jnp.float32)

        return jnp.sum(rnd(u) * rnd(v))

    def raw(dot):
        return jax.jit(lambda b, x0: cg_solve(p32.A.matvec, b, x0, max_iter=iters, dot=dot))

    d32 = dev(make_cg(p32.A, max_iter=iters)(p32.b, p32.x0))
    with jax.default_matmul_precision("tensorfloat32"):
        d32_tf32 = dev(make_cg(p32.A, max_iter=iters)(p32.b, p32.x0))
        d_vdot = dev(raw(jnp.vdot)(p32.b, p32.x0))
    d_tf32ops = dev(raw(tf32_operands)(p32.b, p32.x0))
    # tolerance: f32 against f64 over the first 30 residuals deviated
    # 1.6e-6 on the CPU, TF32-rounded dot operands 1.3e-3; 1e-4 separates
    log(f"[3 precision] {n}^3 f32 vs f64, max rel dev of residuals 0..30 (limit {tol}): "
        f"pinned dots {d32:.3g}; pinned under default_matmul_precision('tensorfloat32') "
        f"{d32_tf32:.3g}; dots on TF32-rounded operands {d_tf32ops:.3g}; "
        f"unpinned jnp.vdot under 'tensorfloat32' {d_vdot:.3g} "
        f"({'XLA kept it off the tensor cores' if d_vdot <= tol else 'TF32 reached it'})")
    check(d32 <= tol and d32_tf32 <= tol, "pinned f32 dots deviate from f64")
    check(d_tf32ops > tol, "the check cannot see TF32-level dot error")
    del p32

    out, _ = run_cli([str(n)] * 3 + ["--dtype", "bfloat16", "--max-iter", "50",
                                      "--skip-kernel-bench", "--check", "--json"])
    rep, trace = json_report(out), printed_trace(out)
    r0, true_r = trace[0], rep["True residual"]
    log(f"[3 bf16] {n}^3, 50 iterations: residual {r0:.6g} -> {rep['Final residual']:.6g} "
        f"(recurrence), true ||b-Ax|| {true_r:.6g}, max|x-1| "
        f"{rep['Difference between computed and exact']:.6g}")
    # bf16 keeps 8 significant bits: x settles within a few ulps of 1.0
    # (ulp 2^-7) and the true residual near 6% of the initial (CPU, 64^3)
    check(rep["Final residual"] <= 1e-3 * r0, "bf16 recurrence did not converge")
    check(true_r <= 0.2 * r0, "bf16 true residual above 20% of the initial")
    check(rep["Difference between computed and exact"] <= 0.125, "bf16 max|x-1|")


def write_matrix_files(tmp, n):
    """An n^3 27-point stencil as an HPC-row file, and a randomly permuted
    copy (P A P^T, b permuted alike): (banded path, permuted path)."""
    import numpy as np

    from hpccg_tpu import ProblemConfig
    from hpccg_tpu.io import write_hpc_row
    from hpccg_tpu.models.stencil import Problem, generate_ell
    from hpccg_tpu.operators import EllMatrix
    from hpccg_tpu.reorder import permute_ell

    prob = generate_ell(ProblemConfig(n, n, n))
    host = EllMatrix(vals=np.asarray(prob.A.vals), cols=np.asarray(prob.A.cols),
                     valid=np.asarray(prob.A.valid), total_nrow=prob.total_nrow)
    b = np.asarray(prob.b)
    banded = os.path.join(tmp, f"stencil{n}.dat")
    write_hpc_row(banded, Problem(A=host, b=b, x0=None, xexact=np.ones_like(b),
                                  total_nrow=prob.total_nrow, total_nnz_model=0,
                                  total_nnz_exact=0))
    perm = np.random.default_rng(n).permutation(prob.total_nrow)
    permuted = os.path.join(tmp, f"permuted{n}.dat")
    write_hpc_row(permuted, Problem(A=permute_ell(host, perm), b=b[perm], x0=None,
                                    xexact=np.ones_like(b), total_nrow=prob.total_nrow,
                                    total_nnz_model=0, total_nnz_exact=0))
    return banded, permuted


def compare_traces(got, ref, r0, rtol, floor, what):
    common = [k for k in sorted(ref) if k in got and ref[k] > floor * r0]
    check(len(common) >= 3, f"{what}: too few comparable residuals")
    worst = max(abs(got[k] / ref[k] - 1) for k in common)
    check(worst <= rtol, f"{what}: residuals deviate {worst:.3g} > {rtol}")
    return worst


def phase_explicit():
    n, iters = EXPLICIT_N, "150"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = write_matrix_files(tmp, n)
        log(f"[4 explicit] wrote two {n}^3 HPC-row files "
            f"({sum(os.path.getsize(f) for f in files) / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
        gen_out, _ = run_cli([str(n)] * 3 + ["--max-iter", iters, "--dtype", "float64",
                                             "--skip-kernel-bench", "--json"])
        ref = json_trace(json_report(gen_out))
        for name, path in zip(("banded", "permuted"), files):
            t0 = time.perf_counter()
            out, err = run_cli([path, "--max-iter", iters, "--dtype", "float64",
                                "--check", "--json"])
            rep = json_report(out)
            structure = [line for line in err.splitlines() if "matrix structure" in line]
            # the same operator in another storage or basis: f64 rounding
            # differs per operation; above 1e-12 of the initial residual the
            # full-precision trajectories agree far inside 1e-8 (CPU, 20^3:
            # 8e-14 banded, 1.1e-13 permuted)
            worst = compare_traces(json_trace(rep), ref, ref[0], 1e-8, 1e-12, name)
            log(f"[4 explicit] {name}: {structure[0] if structure else '?'}; "
                f"solve {rep['Time Summary']['Total   ']:.6g} s, SPARSEMV "
                f"{rep['MFLOPS Summary']['SPARSEMV']:.6g} MFLOPS; max|x-1| "
                f"{rep['Difference between computed and exact']:.3g}; true residual "
                f"{rep['True residual']:.3g}; trajectory vs generated max rel dev "
                f"{worst:.3g}; {time.perf_counter() - t0:.1f} s with loading")
            # converged to the f64 floor after 150 iterations (kappa < 54)
            check(rep["Difference between computed and exact"] <= 1e-10, f"{name}: x")


def phase_kernel():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.ops.stencil_kernel import AUTO_MIN_ROWS, fused_direction
    from hpccg_tpu.solver import make_cg, resolve_backend

    # 256^3 and 100^3 back the auto rule; 32^3 (bench.py's parity32) sits
    # below its cut and stays on XLA
    for n, dtype in ((KERNEL_N, jnp.float32), (KERNEL_N, jnp.float64), (100, jnp.float32),
                     (32, jnp.float32), (32, jnp.float64)):
        prob = generate_problem(ProblemConfig(n, n, n, dtype=dtype))
        A = prob.A
        auto = resolve_backend(A, "auto")
        check(auto == ("triton" if n**3 >= AUTO_MIN_ROWS else "stencil"),
              f"auto picks {auto} at {n}^3")
        k = jax.random.split(jax.random.PRNGKey(0))
        r = jax.random.normal(k[0], (A.local_nrow,), dtype)
        p = jax.random.normal(k[1], (A.local_nrow,), dtype)
        beta = jnp.asarray(0.37, dtype)
        _, ap, pap = fused_direction(A, r, p, beta)
        p_ref = r + beta * p
        ap_ref = A.matvec(p_ref)
        eps = float(jnp.finfo(dtype).eps)
        # up to 27 terms summed in another order: a few ulp of the largest;
        # p.Ap: per-program partials then a sum, against the magnitude sum
        err = float(jnp.max(jnp.abs(ap - ap_ref)) / jnp.max(jnp.abs(ap_ref)))
        pap_err = float(jnp.abs(pap - jnp.sum(p_ref * ap_ref)) / jnp.sum(jnp.abs(p_ref * ap_ref)))
        check(err <= 32 * eps, f"kernel A p deviates {err:.3g}")
        check(pap_err <= 64 * eps, f"kernel p.Ap deviates {pap_err:.3g}")
        name = jnp.dtype(dtype).name
        times = {"stencil": [], "triton": []}
        solves = {b: make_cg(A, max_iter=200, backend=b) for b in times}
        traces = {b: np.asarray(jax.block_until_ready(s(prob.b, prob.x0)).trace, np.float64)
                  for b, s in solves.items()}
        for order in (("stencil", "triton"), ("triton", "stencil")) * 3:
            for b in order:
                t0 = time.perf_counter()
                jax.block_until_ready(solves[b](prob.b, prob.x0))
                times[b].append(time.perf_counter() - t0)
        med = {b: float(np.median(v)) for b, v in times.items()}
        ts, tt = traces["stencil"], traces["triton"]
        good = ts > 1e-4 * ts[0]
        dev = float(np.max(np.abs(tt[good] / ts[good] - 1)))
        log(f"[5 kernel] {n}^3 {name}: A p max rel err {err:.3g}, p.Ap {pap_err:.3g} "
            f"(limits {32 * eps:.3g}, {64 * eps:.3g}); 200-iteration solve median XLA "
            f"{med['stencil'] * 1e3:.6g} ms, Triton {med['triton'] * 1e3:.6g} ms "
            f"(ratio {med['triton'] / med['stencil']:.4g}); auto runs {auto}; residuals "
            f"above 1e-4 of the initial agree to {dev:.3g}")
        # f32 rounding compounds over the iterations: 1e-3; f64: 1e-9
        check(dev <= (1e-3 if dtype == jnp.float32 else 1e-9), "kernel trajectory")
        del prob, r, p, ap, p_ref, ap_ref


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four(devs):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.parallel import generate_problem_sharded, make_distributed_cg, make_mesh
    from hpccg_tpu.solver import make_cg

    check(len(devs) >= 4, f"--four needs 4 devices, JAX sees {len(devs)}")
    mesh = make_mesh(4)
    nx, ny, nz = FOUR_LOCAL
    cfg = ProblemConfig(nx, ny, nz, dtype=jnp.float64)
    prob = generate_problem_sharded(cfg, mesh)
    ref = generate_problem(ProblemConfig(nx, ny, 4 * nz, dtype=jnp.float64))
    iters = 40
    for method in ("cg", "cg1", "pipecg"):
        t0 = time.perf_counter()
        r4 = make_distributed_cg(cfg, mesh, max_iter=iters, method=method)(prob.b, prob.x0)
        jax.block_until_ready(r4)
        t4 = time.perf_counter() - t0
        r1 = make_cg(ref.A, max_iter=iters, method=method)(ref.b, ref.x0)
        tr4, tr1 = np.asarray(r4.trace), np.asarray(r1.trace)
        # rtol 1e-10 above 1e-6 of the initial residual; below it pipecg's
        # extra recurrences amplify the psum order (4 CPU devices: 4e-11
        # above, 9e-8 below)
        good = tr1 > 1e-6 * tr1[0]
        worst = float(np.max(np.abs(tr4[good] / tr1[good] - 1)))
        n_dev = len(r4.x.sharding.device_set)
        log(f"[four] make_distributed_cg {nx}x{ny}x{4 * nz} f64 {method}: {good.sum()} residuals "
            f"vs one card max rel dev {worst:.3g} (limit 1e-10); x on {n_dev} devices; "
            f"first call {t4:.1f} s")
        check(worst <= 1e-10, f"{method} deviates from the one-card solve")
        check(n_dev == 4, f"{method}: x sits on {n_dev} devices")
    del prob, ref

    with tempfile.TemporaryDirectory() as tmp:
        banded, permuted = write_matrix_files(tmp, FOUR_FILE_N)
        for name, path, want in (("banded", banded, "dia-halo"),
                                 ("permuted", permuted, "ell-allgather")):
            base = [path, "--max-iter", FOUR_FILE_ITERS, "--dtype", "float64", "--json",
                    "--check", "--skip-kernel-bench"]
            rep1 = json_report(run_cli(base)[0])
            rep4 = json_report(run_cli(base + ["--mesh", "4"])[0])
            note = [k for k in rep4["Time Summary"] if "backend=" in k][0]
            t1, t4 = json_trace(rep1), json_trace(rep4)
            worst = compare_traces(t4, t1, t1[0], FOUR_FILE_RTOL, 1e-12, name)
            err4 = rep4["Difference between computed and exact"]
            log(f"[four] file {FOUR_FILE_N}^3 {name} --mesh 4 ran distributed:{want}"
                f"; residuals vs --mesh 1 max rel dev {worst:.3g} (limit {FOUR_FILE_RTOL}); "
                f"max|x-1| {err4:.3g} (limit 1e-10), --mesh 1 "
                f"{rep1['Difference between computed and exact']:.3g}")
            check("distributed:" + want in note, f"{name} ran {note}")
            check(err4 <= 1e-10, f"{name} --mesh 4: max|x - 1| = {err4}")
    peaks = [peak_bytes(d) for d in devs[:4]]
    log(f"[four] peak_bytes_in_use per device: {peaks}")
    check(all(p > 0 for p in peaks), "a device of the mesh held nothing")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded paths (and their one-card "
                    "references) instead of phases 1-5")
    args = ap.parse_args(argv)

    import jax

    import hpccg_tpu
    from hpccg_tpu.utils.cache import enable_compilation_cache

    # the smoke test checks its own checkout, not a package found elsewhere
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(hpccg_tpu.__file__)))
    if pkg_root != ROOT:
        print(f"error: hpccg_tpu comes from {pkg_root}, not {ROOT}", file=sys.stderr)
        return 2
    enable_compilation_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"error: no GPU (JAX platform {devs[0].platform!r})", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    from hpccg_tpu.utils.device import card_info

    log(f"card: {card_info()}; jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}")
    t0 = time.perf_counter()
    try:
        if args.four:
            phase_four(devs)
        else:
            for phase in (lambda: phase_main(devs[0]), phase_golden, phase_precision,
                          phase_explicit, phase_kernel):
                phase()
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
