"""Strong-scaling remainder shards: a global nz
that does not divide the mesh runs with ceil-padded shards and a masked
operator, reproducing the exact unpadded trajectory."""

import json

import numpy as np
import pytest

from hpccg_tpu import ProblemConfig, generate_problem
from hpccg_tpu.parallel import make_mesh
from hpccg_tpu.parallel.cg import (
    generate_problem_sharded_masked,
    make_distributed_cg_masked,
)
from hpccg_tpu.solver import make_cg


@pytest.mark.parametrize("nz_global,ndev", [(9, 8), (11, 4), (5, 8)])
def test_masked_matches_unpadded_global(nz_global, ndev):
    nx, ny = 5, 4
    nz_local = -(-nz_global // ndev)
    mesh = make_mesh(ndev)
    cfg_l = ProblemConfig(nx, ny, nz_local)
    prob = generate_problem_sharded_masked(cfg_l, mesh, nz_global=nz_global)
    dist = make_distributed_cg_masked(
        cfg_l, mesh, nz_global=nz_global, max_iter=25
    )(prob.b, prob.x0)

    ref_prob = generate_problem(ProblemConfig(nx, ny, nz_global))
    ref = make_cg(ref_prob.A, max_iter=25, tolerance=0.0)(
        ref_prob.b, ref_prob.x0
    )
    assert int(dist.niters) == int(ref.niters)
    td, tr = np.asarray(dist.trace), np.asarray(ref.trace)
    good = np.isfinite(tr) & (tr > 1e-11 * tr[0])
    np.testing.assert_allclose(td[good], tr[good], rtol=1e-9)

    # the solution on real planes matches; padded planes are exactly zero
    xg = np.asarray(dist.x).reshape(-1)[: nz_global * ny * nx]
    np.testing.assert_allclose(
        xg, np.asarray(ref.x).reshape(-1), rtol=1e-8, atol=1e-10
    )
    flat = np.asarray(dist.x).reshape(ndev * nz_local, ny * nx)
    for d in range(ndev):
        z0 = d * nz_local
        for z in range(nz_local):
            if z0 + z >= nz_global:
                np.testing.assert_array_equal(flat[z0 + z], 0.0)


def test_sweep_strong_runs_nondivisible(capsys):
    from hpccg_tpu.sweep import main

    rc = main(
        ["strong", "--meshes", "3", "--nx", "4", "--ny", "4",
         "--global-nz", "8", "--dtype", "float64", "--iters", "4"]
    )
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    pts = [l for l in lines if l.get("mesh") == 3]
    assert pts and "skipped" not in pts[0]
    assert pts[0].get("remainder_masked") is True
    assert pts[0]["global_nz"] == 8
