"""--method cg1/pipecg on the FILE-matrix distributed solvers.

The 2-reduction reference recurrence pays two allreduce latencies per
iteration; the one-reduction methods pay one. These tests pin that every
loaded-matrix path (dia-halo, ell-allgather) honors method= through the
shared _method_runner.

The matrices are SYMMETRIC (CG's contract): the cg1/pipecg scalar
recurrences (e.g. cg1's p.Ap from r.Ar via alpha/beta) hold only for
symmetric A — on a nonsymmetric matrix the methods genuinely diverge,
which is a property of the algorithms, not a wiring bug. pipecg's deeper
recurrences drift more in finite precision, hence its looser tolerance
(same convention as test_parallel's stencil-path method tests).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hpccg_tpu import ProblemConfig
from hpccg_tpu.models.stencil import generate_ell
from hpccg_tpu.operators import EllMatrix
from hpccg_tpu.parallel import make_mesh
from hpccg_tpu.parallel.cg import (
    make_distributed_dia_cg,
    make_distributed_ell_cg,
)

pytestmark = pytest.mark.quick

NDEV = 4
RTOL = {"cg1": 1e-8, "pipecg": 1e-5}


def _trace_close(r_m, r_cg, rtol):
    t0, t1 = np.asarray(r_cg.trace), np.asarray(r_m.trace)
    good = np.isfinite(t0) & (t0 > 1e-8 * t0[0])
    np.testing.assert_allclose(t1[good], t0[good], rtol=rtol)


def _symmetric_ell(n, pairs, dtype=np.float64):
    """Diagonally dominant symmetric ELL from an (i, j, v) pair list."""
    entries = {}
    for i, j, v in pairs:
        entries[(i, j)] = entries[(j, i)] = v
    rows_of = {}
    for (i, j), v in entries.items():
        rows_of.setdefault(i, []).append((j, v))
    for i in range(n):
        rows_of.setdefault(i, []).append(
            (i, 2.0 + sum(abs(v) for _j, v in rows_of.get(i, [])))
        )
    width = max(len(v) for v in rows_of.values())
    vals = np.zeros((n, width), dtype)
    cols = np.zeros((n, width), np.int32)
    valid = np.zeros((n, width), bool)
    for i, lst in rows_of.items():
        for s, (j, v) in enumerate(sorted(lst)):
            cols[i, s], vals[i, s], valid[i, s] = j, v, True
    return EllMatrix(
        vals=jnp.asarray(vals), cols=jnp.asarray(cols),
        valid=jnp.asarray(valid), start_row=0, total_nrow=n,
    )


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
def test_dia_halo_honors_method(method):
    prob = generate_ell(ProblemConfig(3, 3, 4 * NDEV, dtype=jnp.float64))
    dia = prob.A.to_dia()
    mesh = make_mesh(NDEV)
    r_cg = make_distributed_dia_cg(mesh, max_iter=10)(dia, prob.b, prob.x0)
    r_m = make_distributed_dia_cg(mesh, max_iter=10, method=method)(
        dia, prob.b, prob.x0
    )
    _trace_close(r_m, r_cg, rtol=RTOL[method])


def test_ell_allgather_honors_method():
    prob = generate_ell(ProblemConfig(4, 4, 2 * NDEV, dtype=jnp.float64))
    from hpccg_tpu.parallel.cg import shard_problem

    mesh = make_mesh(NDEV)
    sp = shard_problem(prob, mesh)
    r_cg = make_distributed_ell_cg(mesh, max_iter=10)(sp.A, sp.b, sp.x0)
    r_m = make_distributed_ell_cg(mesh, max_iter=10, method="cg1")(
        sp.A, sp.b, sp.x0
    )
    _trace_close(r_m, r_cg, rtol=1e-8)


def test_unknown_method_rejected():
    from hpccg_tpu.parallel.cg import _method_runner

    with pytest.raises(ValueError, match="unknown CG method"):
        _method_runner("sor", "z")
