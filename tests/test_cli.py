"""CLI driver tests (ref main.cpp argv modes)."""

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from hpccg_tpu.cli import main


def run_cli(args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(args)
    return rc, buf.getvalue()


def test_generated_mode_golden():
    rc, out = run_cli(["10", "10", "10", "--max-iter", "150", "--skip-kernel-bench"])
    assert rc == 0
    assert "Initial Residual = 258.24" in out
    assert "Iteration = 15   Residual = 2.15402e-06" in out
    assert "Number of iterations: 149" in out
    assert "Time Summary: " in out
    assert "FLOPS Summary: " in out
    # FLOP model, main.cpp:224-227 with nrow=1000, nnz=27000, niters=149
    assert "  Total   : 9.536e+06" in out
    assert "  SPARSEMV: 8.046e+06" in out


def test_mesh_mode():
    rc, out = run_cli(
        ["6", "6", "2", "--mesh", "4", "--max-iter", "30", "--dtype", "float64",
         "--skip-kernel-bench", "--quiet"]
    )
    assert rc == 0
    assert "Number of mesh devices: 4" in out
    assert "global nz: 8" in out


@pytest.mark.slow
def test_file_mode(tmp_path):
    from hpccg_tpu import ProblemConfig
    from hpccg_tpu.io import write_hpc_row
    from hpccg_tpu.models.stencil import generate_ell

    path = str(tmp_path / "m.dat")
    write_hpc_row(path, generate_ell(ProblemConfig(4, 4, 4)))
    rc, out = run_cli([path, "--max-iter", "30", "--skip-kernel-bench", "--quiet"])
    assert rc == 0
    assert "Number of iterations: 29" in out


def test_check_flag():
    rc, out = run_cli(
        ["8", "8", "8", "--max-iter", "60", "--check", "--quiet",
         "--skip-kernel-bench"]
    )
    assert rc == 0
    line = [l for l in out.splitlines() if "computed and exact" in l][0]
    assert float(line.split("=")[-1]) < 1e-8  # converged to xexact = ones
    assert "Difference between computed and exact:" in out  # report key
    # the true residual ||b - A x|| agrees with the recurrence's normr
    true_r = float([l for l in out.splitlines() if "True residual ||" in l][0].split("=")[-1])
    final = float([l for l in out.splitlines() if l.startswith("Final residual:")][0].split(":")[-1])
    assert "True residual:" in out
    assert abs(true_r - final) <= 1e-6 * 258.24  # both at the f64 floor of ||b||


def test_profile_flag(tmp_path):
    prof = str(tmp_path / "trace")
    rc, _ = run_cli(
        ["4", "4", "4", "--max-iter", "10", "--profile", prof, "--quiet",
         "--skip-kernel-bench"]
    )
    assert rc == 0
    import os

    assert os.path.isdir(prof) and os.listdir(prof)  # trace files written


def test_bad_args():
    rc, _ = run_cli(["4", "4"])
    assert rc == 2


@pytest.mark.parametrize(
    "backend",
    ["pallas", "pallas_dd", "pallas_v1", "pallas_fused", "megakernel",
     "streamkernel", "collective", "ell", "dia"],
)
def test_removed_backends_rejected(backend, capsys):
    """The CLI offers only the paths that remain: auto, the XLA stencil and
    the Triton kernel."""
    with pytest.raises(SystemExit) as e:
        main(["4", "4", "4", "--backend", backend])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_json_output():
    rc, out = run_cli(["4", "4", "4", "--max-iter", "10", "--json",
                       "--skip-kernel-bench", "--quiet"])
    assert rc == 0
    import json

    obj = json.loads(out)
    assert obj["Dimensions"]["nx"] == 4
    assert obj["Number of iterations"] == 9


def test_validate_flag():
    rc, out = run_cli(
        ["6", "6", "6", "--max-iter", "20", "--validate", "--quiet",
         "--skip-kernel-bench"]
    )
    assert rc == 0


@pytest.mark.slow
def test_validate_utilities():
    import jax.numpy as jnp
    import pytest as _pytest

    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.utils.checks import ValidationError, check_finite, validate_problem

    prob = generate_problem(ProblemConfig(5, 4, 3))
    findings = validate_problem(prob)
    assert findings["b_residual"] < 1e-10

    # corrupt b -> validation must fail
    import dataclasses

    bad = dataclasses.replace(prob, b=prob.b.at[0].add(1.0))
    with _pytest.raises(ValidationError):
        validate_problem(bad)

    # NaN result detection (the divergence signature: alpha = 0/0 after
    # exact convergence under tolerance=0)
    from hpccg_tpu.solver import make_cg

    res = make_cg(prob.A, max_iter=10)(prob.b, prob.x0)
    check_finite(res)  # healthy solve passes
    nan_res = dataclasses.replace(res, normr=jnp.asarray(float("nan")))
    with _pytest.raises(ValidationError):
        check_finite(nan_res)


def test_refine_flag():
    rc, out = run_cli(
        ["8", "8", "8", "--refine", "4", "--max-iter", "60", "--check",
         "--skip-kernel-bench"]
    )
    assert rc == 0
    assert "Refinement round = 1" in out
    line = [l for l in out.splitlines() if "computed and exact" in l][0]
    assert float(line.split("=")[-1]) < 1e-12  # f64-floor via f32 inners


def test_refine_requires_f64():
    rc, _ = run_cli(["8", "8", "8", "--refine", "2", "--dtype", "float32"])
    assert rc == 2


@pytest.mark.slow
def test_mesh_report_benches_solved_tier(run_cli=None):
    """In mesh mode the SPARSEMV Time-Summary row micro-benchmarks the path
    the solve ran — the XLA halo stencil — and the note names it."""
    import contextlib
    import io as _io
    import json

    from hpccg_tpu.cli import main

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["6", "5", "4", "--dtype", "float32", "--max-iter", "10",
                   "--mesh", "2", "--json", "--quiet"])
    assert rc == 0
    out = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
    ts = json.dumps(out["Time Summary"])
    assert "backend=distributed:stencil-halo" in ts
    # the SPARSEMV row was actually measured (not NaN)
    spmv_t = out["Time Summary"]["SPARSEMV"]
    assert spmv_t == spmv_t and spmv_t > 0
