"""Warning contracts and 16-bit vector state.

No solver path silently substitutes a different recurrence or kernel, and
16-bit vector state keeps its control scalars (niters) exact.
"""

import warnings

import numpy as np
import pytest

import jax.numpy as jnp

from hpccg_tpu import ProblemConfig, generate_problem
from hpccg_tpu.solver import make_cg, resolve_backend


def test_kernel_backend_on_explicit_matrix_warns():
    """backend='triton' names the stencil kernel; an explicit matrix runs
    its own matvec, and make_cg must say so instead of mislabeling the
    run."""
    from hpccg_tpu.models.stencil import generate_ell

    prob = generate_ell(ProblemConfig(4, 4, 4, dtype=jnp.float32))
    with pytest.warns(UserWarning, match="stencil operators only"):
        solve = make_cg(prob.A, max_iter=10, backend="triton")
    res = solve(prob.b, prob.x0)
    assert float(res.normr) < float(res.trace[0])


def test_small_ell_does_not_warn(recwarn):
    from hpccg_tpu.models.stencil import generate_ell

    prob = generate_ell(ProblemConfig(4, 4, 4, dtype=jnp.float32))
    assert resolve_backend(prob.A, "auto") == "auto"
    assert not [w for w in recwarn if issubclass(w.category, UserWarning)]


def test_unknown_backend_rejected():
    prob = generate_problem(ProblemConfig(4, 4, 4))
    with pytest.raises(ValueError, match="unknown backend"):
        make_cg(prob.A, backend="megakernel")


def test_bf16_state_converges_with_exact_niters():
    """bf16 vectors on the XLA stencil: the solve converges, x keeps its
    dtype, and niters is an exact int32 count matching the trace."""
    prob = generate_problem(ProblemConfig(6, 5, 4, dtype=jnp.bfloat16))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = make_cg(prob.A, max_iter=300)(prob.b, prob.x0)
    assert res.x.dtype == jnp.bfloat16
    assert res.niters.dtype == jnp.int32
    trace = np.asarray(res.trace, np.float32)
    assert float(res.normr) < 1e-2 * trace[0]
    k = int(res.niters)
    assert 0 < k < 299  # bf16 r rounds to exactly zero well before
    assert np.isfinite(trace[: k + 1]).all() and np.isnan(trace[k + 1 :]).all()
    # bf16 keeps ~2-3 digits: the solution is ones to that precision
    assert float(jnp.max(jnp.abs(res.x.astype(jnp.float32) - 1.0))) < 0.05


def test_refine_plus_mesh_cli_warns(capsys):
    """--refine with --mesh > 1 is ignored with a note, and the output does
    not mislabel CG iterations as refinement rounds."""
    from hpccg_tpu.cli import main

    rc = main(
        ["4", "4", "2", "--mesh", "2", "--refine", "2", "--dtype", "float64",
         "--max-iter", "8", "--skip-kernel-bench", "--json"]
    )
    assert rc == 0
    out, err = capsys.readouterr()
    assert "--refine is a single-device path" in err
    assert "Refinement round" not in out
    assert "Iteration" in out
