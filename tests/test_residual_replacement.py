"""Residual replacement for the one-reduction methods.

cg1/pipecg carry the residual by recurrence; in f32 it decays BELOW the
true residual's stagnation floor and eventually flushes to exact zero,
self-terminating tolerance=0 runs (documented in solver.py). With
replace_every=K the recurrence residual is re-anchored to the true
b - A x every K iterations (van der Vorst/Sleijpen-style): exact
arithmetic is unchanged (f64 parity below), and the f32 trace tracks the
true floor instead of lying its way to zero.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hpccg_tpu import ProblemConfig, generate_problem
from hpccg_tpu.solver import make_cg

pytestmark = pytest.mark.quick


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
def test_replacement_is_noop_in_f64(method):
    prob = generate_problem(ProblemConfig(8, 7, 6))
    base = make_cg(prob.A, max_iter=40, tolerance=0.0, method=method)(
        prob.b, prob.x0
    )
    rr = make_cg(
        prob.A, max_iter=40, tolerance=0.0, method=method, replace_every=10
    )(prob.b, prob.x0)
    t0, t1 = np.asarray(base.trace), np.asarray(rr.trace)
    good = np.isfinite(t0) & (t0 > 1e-10 * t0[0])
    np.testing.assert_allclose(t1[good], t0[good], rtol=1e-7)


def test_replacement_cures_f32_flush():
    """The headline: plain f32 cg1 at tolerance=0 flushes its recurrence
    residual to exact zero and exits early; with replacement the run goes
    the full distance and the reported normr matches the TRUE residual."""
    prob = generate_problem(ProblemConfig(10, 10, 10, dtype=jnp.float32))
    base = make_cg(prob.A, max_iter=300, tolerance=0.0, method="cg1")(
        prob.b, prob.x0
    )
    # the documented pathology, pinned so this test notices if it ever
    # stops reproducing
    assert float(base.normr) == 0.0 and int(base.niters) < 299
    rr = make_cg(
        prob.A, max_iter=300, tolerance=0.0, method="cg1", replace_every=20
    )(prob.b, prob.x0)
    assert int(rr.niters) == 299  # no early flush exit
    true_r = np.asarray(prob.b, np.float64) - np.asarray(
        prob.A.matvec(rr.x), np.float64
    )
    true_norm = float(np.linalg.norm(true_r))
    assert float(rr.normr) > 0
    # the reported residual is the true floor, not the recurrence fantasy
    assert 0.2 * true_norm < float(rr.normr) < 5 * true_norm
    # and the solution is as good as the plain run's
    base_true = np.asarray(prob.b, np.float64) - np.asarray(
        prob.A.matvec(base.x), np.float64
    )
    assert true_norm < 2 * float(np.linalg.norm(base_true))


def test_replacement_distributed_cg1():
    """Collectives inside the replacement lax.cond under shard_map: the
    distributed cg1 solve with replacement matches the non-replaced f64
    trajectory (no-op up to rounding) on the virtual mesh."""
    from hpccg_tpu.parallel import make_mesh
    from hpccg_tpu.parallel.cg import generate_problem_sharded, make_distributed_cg

    cfg = ProblemConfig(6, 5, 4)
    mesh = make_mesh(4)
    prob = generate_problem_sharded(cfg, mesh)
    base = make_distributed_cg(cfg, mesh, max_iter=25, method="cg1")(
        prob.b, prob.x0
    )
    rr = make_distributed_cg(
        cfg, mesh, max_iter=25, method="cg1", replace_every=8
    )(prob.b, prob.x0)
    t0, t1 = np.asarray(base.trace), np.asarray(rr.trace)
    good = np.isfinite(t0) & (t0 > 1e-10 * t0[0])
    np.testing.assert_allclose(t1[good], t0[good], rtol=1e-7)


def test_replacement_distributed_file_tier():
    """--rr-every reaches the file-matrix runners through _method_runner
    (dia tier exercised; the others share the same runner)."""
    from hpccg_tpu.models.stencil import generate_ell
    from hpccg_tpu.parallel import make_mesh
    from hpccg_tpu.parallel.cg import make_distributed_dia_cg

    prob = generate_ell(ProblemConfig(3, 3, 16, dtype=jnp.float64))
    dia = prob.A.to_dia()
    mesh = make_mesh(4)
    base = make_distributed_dia_cg(mesh, max_iter=12, method="cg1")(
        dia, prob.b, prob.x0
    )
    rr = make_distributed_dia_cg(
        mesh, max_iter=12, method="cg1", replace_every=4
    )(dia, prob.b, prob.x0)
    t0, t1 = np.asarray(base.trace), np.asarray(rr.trace)
    good = np.isfinite(t0) & (t0 > 1e-10 * t0[0])
    np.testing.assert_allclose(t1[good], t0[good], rtol=1e-8)


def test_cli_rr_every_flag():
    import contextlib
    import io as _io
    import json

    from hpccg_tpu.cli import main

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(
            ["8", "8", "8", "--dtype", "float32", "--method", "cg1",
             "--rr-every", "10", "--max-iter", "60", "--json", "--quiet",
             "--skip-kernel-bench"]
        )
    assert rc == 0
    out = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
    assert out["Number of iterations"] == 59  # no flush exit
    assert out["Final residual"] > 0
