"""CG solver tests: convergence, reference-semantics parity, golden trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpccg_tpu import ProblemConfig, Stencil, cg_solve, generate_problem
from hpccg_tpu.models.stencil import generate_ell
from hpccg_tpu.ops.vector import compute_residual
from hpccg_tpu.solver import make_cg

from oracle import GOLDEN_10_NITERS, GOLDEN_10_TRACE, oracle_cg, oracle_dense


@pytest.mark.slow
def test_converges_to_ones():
    cfg = ProblemConfig(8, 8, 8)
    prob = generate_problem(cfg)
    solve = make_cg(prob.A, max_iter=60, tolerance=0.0)
    res = solve(prob.b, prob.x0)
    err = compute_residual(res.x, prob.xexact)
    assert float(err) < 1e-12
    assert int(res.niters) == 59  # ref loop runs k = 1..max_iter-1


def test_tolerance_early_exit():
    cfg = ProblemConfig(8, 8, 8)
    prob = generate_problem(cfg)
    solve = make_cg(prob.A, max_iter=500, tolerance=1e-10)
    res = solve(prob.b, prob.x0)
    assert int(res.niters) < 499
    assert float(res.normr) <= 1e-10 * 10  # normr lags one iteration (ref :371)
    # trace beyond the executed range is NaN
    tr = np.asarray(res.trace)
    assert np.isnan(tr[int(res.niters) + 1 :]).all()


@pytest.mark.parametrize("stencil", [Stencil.S27, Stencil.S7])
def test_trajectory_matches_numpy_oracle(stencil):
    """JAX trajectory == independent NumPy CG on the dense oracle matrix."""
    cfg = ProblemConfig(6, 5, 4, stencil=stencil)
    prob = generate_problem(cfg)
    Ad, b, _ = oracle_dense(6, 5, 4, seven_pt=(stencil == Stencil.S7))
    max_iter = 40
    res = make_cg(prob.A, max_iter=max_iter)(prob.b, prob.x0)
    _, niters, normr, otrace = oracle_cg(Ad, b, np.zeros_like(b), max_iter)
    trace = np.asarray(res.trace)[: len(otrace)]
    assert int(res.niters) == niters
    # identical recurrence in f64; only summation order differs
    mask = otrace > 1e-14 * otrace[0]
    np.testing.assert_allclose(trace[mask], otrace[mask], rtol=1e-9)
    # below the rounding floor the tail is rounding-noise-driven: the decay
    # *rate* (spectrum-driven) must agree, pointwise values need not
    np.testing.assert_allclose(
        np.log10(trace[~mask]), np.log10(otrace[~mask]), rtol=0.2
    )


def test_golden_out_txt_parity():
    """Residual-trajectory parity with the reference binary's checked-in run
    (out.txt: 10^3 problem, 149 iterations, final residual 1.68304e-92)."""
    cfg = ProblemConfig(10, 10, 10)
    prob = generate_problem(cfg)
    res = make_cg(prob.A, max_iter=150, tolerance=0.0)(prob.b, prob.x0)
    assert int(res.niters) == GOLDEN_10_NITERS
    trace = np.asarray(res.trace)
    # initial residual and the first printed iterate match to ~6 sig figs
    np.testing.assert_allclose(trace[0], GOLDEN_10_TRACE[0], rtol=1e-5)
    np.testing.assert_allclose(trace[15], GOLDEN_10_TRACE[15], rtol=1e-4)
    # deep-convergence tail: decay *rate* is spectrum-driven; rounding noise
    # compounds, so compare orders of magnitude
    for k, ref in GOLDEN_10_TRACE.items():
        if k <= 15:
            continue
        assert abs(np.log10(trace[k]) - np.log10(ref)) < 0.05 * abs(np.log10(ref)) + 1.0


def test_ell_backend_matches_stencil_backend():
    cfg = ProblemConfig(6, 6, 6)
    sprob = generate_problem(cfg)
    eprob = generate_ell(cfg)
    rs = make_cg(sprob.A, max_iter=30)(sprob.b, sprob.x0)
    re = make_cg(eprob.A, max_iter=30)(eprob.b, eprob.x0)
    np.testing.assert_allclose(np.asarray(rs.x), np.asarray(re.x), rtol=1e-12)
    ts, te = np.asarray(rs.trace), np.asarray(re.trace)
    good = ts > 1e-11 * ts[0]
    np.testing.assert_allclose(ts[good], te[good], rtol=1e-7)


def test_f32_mode_converges():
    """Fast-dtype mode: f32 converges to f32-level accuracy."""
    cfg = ProblemConfig(8, 8, 8, dtype=jnp.float32)
    prob = generate_problem(cfg)
    res = make_cg(prob.A, max_iter=60)(prob.b, prob.x0)
    assert float(compute_residual(res.x, prob.xexact)) < 1e-4


@pytest.mark.slow
def test_single_reduction_cg_matches_standard():
    """Chronopoulos-Gear CG: same trajectory as the reference recurrence to
    rounding (mathematically equivalent; one fused reduction per iteration)."""
    cfg = ProblemConfig(12, 10, 9)
    prob = generate_problem(cfg)
    r1 = make_cg(prob.A, max_iter=40, method="cg1")(prob.b, prob.x0)
    r0 = make_cg(prob.A, max_iter=40)(prob.b, prob.x0)
    assert int(r1.niters) == int(r0.niters)
    t1, t0 = np.asarray(r1.trace), np.asarray(r0.trace)
    good = t0 > 1e-10 * t0[0]
    np.testing.assert_allclose(t1[good], t0[good], rtol=1e-6)
    assert float(compute_residual(r1.x, prob.xexact)) < 1e-10


def test_single_reduction_cg_early_exit():
    cfg = ProblemConfig(8, 8, 8)
    prob = generate_problem(cfg)
    res = make_cg(prob.A, max_iter=500, tolerance=1e-10, method="cg1")(
        prob.b, prob.x0
    )
    rs = make_cg(prob.A, max_iter=500, tolerance=1e-10)(prob.b, prob.x0)
    # same exit iteration and same one-update-stale exit normr as the
    # reference recurrence
    assert int(res.niters) == int(rs.niters)
    np.testing.assert_allclose(float(res.normr), float(rs.normr), rtol=1e-6)
    assert int(res.niters) < 499


def test_pipelined_cg_matches_standard():
    """Ghysels-Vanroose pipelined CG: same trajectory to rounding over
    typical run lengths (recurrence drift grows with iteration count)."""
    cfg = ProblemConfig(12, 10, 9)
    prob = generate_problem(cfg)
    r1 = make_cg(prob.A, max_iter=40, method="pipecg")(prob.b, prob.x0)
    r0 = make_cg(prob.A, max_iter=40)(prob.b, prob.x0)
    assert int(r1.niters) == int(r0.niters)
    t1, t0 = np.asarray(r1.trace), np.asarray(r0.trace)
    good = t0 > 1e-8 * t0[0]
    np.testing.assert_allclose(t1[good], t0[good], rtol=1e-5)
    assert float(compute_residual(r1.x, prob.xexact)) < 1e-9


def test_pipelined_cg_early_exit():
    cfg = ProblemConfig(8, 8, 8)
    prob = generate_problem(cfg)
    res = make_cg(prob.A, max_iter=500, tolerance=1e-8, method="pipecg")(
        prob.b, prob.x0
    )
    rs = make_cg(prob.A, max_iter=500, tolerance=1e-8)(prob.b, prob.x0)
    assert abs(int(res.niters) - int(rs.niters)) <= 1  # recurrence drift
    assert float(res.normr) <= 1e-8


@pytest.mark.slow
def test_iterative_refinement_reaches_f64_accuracy():
    """Mixed-precision refinement: f32 inner solves, f64-floor result."""
    from hpccg_tpu.solver import cg_solve_refined

    cfg = ProblemConfig(10, 10, 10)  # f64 problem
    prob = generate_problem(cfg)
    res = cg_solve_refined(
        prob.A, prob.b, prob.x0, inner_max_iter=80, outer_max_iter=6
    )
    # far beyond single-precision accuracy (~1e-7): true f64-quality solution
    assert float(compute_residual(res.x, prob.xexact)) < 1e-12
    tr = np.asarray(res.trace)
    assert tr[0] > 100  # initial residual 258.24
    finite = tr[np.isfinite(tr)]
    assert finite[-1] < 1e-10
    assert int(res.niters) > 0


def test_resolve_backend_dispatch():
    from hpccg_tpu.solver import resolve_backend

    sprob = generate_problem(ProblemConfig(6, 6, 6))
    eprob = generate_ell(ProblemConfig(6, 6, 6))
    # auto takes the XLA stencil until the kernel has won on the card
    assert resolve_backend(sprob.A, "auto") == "stencil"
    # explicit names pass through for stencil operators
    assert resolve_backend(sprob.A, "triton") == "triton"
    assert resolve_backend(sprob.A, "stencil") == "stencil"
    # explicit matrices use their native matvec; the kernel name warns
    assert resolve_backend(eprob.A, "auto") == "auto"
    assert resolve_backend(eprob.A, "stencil") == "auto"
    with pytest.warns(UserWarning, match="stencil operators only"):
        assert resolve_backend(eprob.A, "triton") == "auto"
    for gone in ("pallas", "megakernel", "ell", "dia"):
        with pytest.raises(ValueError, match="unknown backend"):
            resolve_backend(sprob.A, gone)


@pytest.mark.slow
def test_iterative_refinement_explicit_matrices():
    """Refinement's f32-cast branch for explicit operators (tree_map astype):
    ELL and DIA inner solves must reach the f64 floor too."""
    from hpccg_tpu.solver import cg_solve_refined

    prob = generate_ell(ProblemConfig(8, 8, 8))
    for A in (prob.A, prob.A.to_dia()):
        assert A is not None
        res = cg_solve_refined(
            A, prob.b, prob.x0, inner_max_iter=80, outer_max_iter=6
        )
        assert float(compute_residual(res.x, prob.xexact)) < 1e-12


@pytest.mark.slow
def test_make_cg_solver_config():
    from hpccg_tpu import SolverConfig

    prob = generate_problem(ProblemConfig(6, 6, 6))
    r_cfg = make_cg(prob.A, config=SolverConfig(max_iter=30, tolerance=0.0))(
        prob.b, prob.x0
    )
    r_kw = make_cg(prob.A, max_iter=30)(prob.b, prob.x0)
    assert int(r_cfg.niters) == int(r_kw.niters) == 29
    # explicit keyword wins over the config object
    r_mix = make_cg(prob.A, max_iter=10, config=SolverConfig(max_iter=30))(
        prob.b, prob.x0
    )
    assert int(r_mix.niters) == 9


def test_iterative_refinement_tolerance_stop():
    """The outer loop stops once the f64 residual crosses the tolerance."""
    from hpccg_tpu.solver import cg_solve_refined

    prob = generate_problem(ProblemConfig(8, 8, 8))
    res = cg_solve_refined(
        prob.A, prob.b, prob.x0,
        inner_max_iter=80, outer_max_iter=6, tolerance=1e-6,
    )
    assert float(res.normr) <= 1e-6
    tr = np.asarray(res.trace)
    # stopped early: fewer finite outer entries than the cap allows
    assert np.isfinite(tr).sum() < 7
