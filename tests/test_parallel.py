"""Distributed-layer tests on 8 virtual CPU devices (shard_map/ppermute/psum
run for real — the multi-device-without-a-cluster capability, SURVEY.md §4d)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from hpccg_tpu import ProblemConfig, Stencil, generate_problem
from hpccg_tpu.models.stencil import generate_ell
from hpccg_tpu.ops.vector import compute_residual
from hpccg_tpu.parallel import (
    generate_problem_sharded,
    make_distributed_cg,
    make_distributed_ell_cg,
    make_mesh,
)
from hpccg_tpu.parallel.cg import shard_problem
from hpccg_tpu.parallel.halo import stencil_matvec_halo
from hpccg_tpu.solver import make_cg


def global_cfg(cfg, size):
    return ProblemConfig(cfg.nx, cfg.ny, cfg.nz * size, stencil=cfg.stencil, dtype=cfg.dtype)


@pytest.mark.slow
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("stencil", [Stencil.S27, Stencil.S7])
def test_halo_matvec_matches_global(ndev, stencil):
    """Sharded halo'd SpMV == single-device SpMV on the assembled domain."""
    cfg = ProblemConfig(5, 4, 3, stencil=stencil)
    mesh = make_mesh(ndev)
    gprob = generate_problem(global_cfg(cfg, ndev))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(gprob.total_nrow))

    from functools import partial
    from hpccg_tpu.parallel.cg import local_operator

    op_local = local_operator(cfg)
    f = jax.jit(
        jax.shard_map(
            lambda v: stencil_matvec_halo(op_local, v, "z"),
            mesh=mesh,
            in_specs=P("z"),
            out_specs=P("z"),
        )
    )
    got = np.asarray(f(x))
    want = np.asarray(gprob.A.matvec(x))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_generation_matches_global(ndev):
    cfg = ProblemConfig(4, 3, 2)
    mesh = make_mesh(ndev)
    prob = generate_problem_sharded(cfg, mesh)
    gprob = generate_problem(global_cfg(cfg, ndev))
    np.testing.assert_array_equal(np.asarray(prob.b), np.asarray(gprob.b))
    assert prob.total_nnz_exact == gprob.total_nnz_exact
    # sharding really is one z-block per device
    assert len(prob.b.sharding.device_set) == ndev


@pytest.mark.slow
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_distributed_cg_matches_single_device(ndev):
    """Trajectory parity: distributed solve == single-device solve."""
    cfg = ProblemConfig(6, 5, 2)
    mesh = make_mesh(ndev)
    prob = generate_problem_sharded(cfg, mesh)
    solve = make_distributed_cg(cfg, mesh, max_iter=40, tolerance=0.0)
    res = solve(prob.b, prob.x0)

    gprob = generate_problem(global_cfg(cfg, ndev))
    gres = make_cg(gprob.A, max_iter=40)(gprob.b, gprob.x0)

    assert int(res.niters) == int(gres.niters)
    err = compute_residual(res.x, prob.xexact)
    assert float(err) < 1e-11
    t, gt = np.asarray(res.trace), np.asarray(gres.trace)
    mask = gt > 1e-11 * gt[0]
    np.testing.assert_allclose(t[mask], gt[mask], rtol=1e-7)


@pytest.mark.slow
def test_distributed_ell_cg_matches_stencil():
    """General all-gather ELL path == stencil halo path on the same problem."""
    ndev = 4
    cfg = ProblemConfig(4, 4, 2)
    mesh = make_mesh(ndev)
    gcfg = global_cfg(cfg, ndev)
    eprob = shard_problem(generate_ell(gcfg), mesh)
    solve = make_distributed_ell_cg(mesh, max_iter=30)
    res = solve(eprob.A, eprob.b, eprob.x0)
    assert float(compute_residual(res.x, eprob.xexact)) < 1e-11

    sprob = generate_problem_sharded(cfg, mesh)
    sres = make_distributed_cg(cfg, mesh, max_iter=30)(sprob.b, sprob.x0)
    t, st = np.asarray(res.trace), np.asarray(sres.trace)
    mask = st > 1e-11 * st[0]
    np.testing.assert_allclose(t[mask], st[mask], rtol=1e-7)


def test_distributed_trace_is_replicated():
    cfg = ProblemConfig(3, 3, 2)
    mesh = make_mesh(8)
    prob = generate_problem_sharded(cfg, mesh)
    res = make_distributed_cg(cfg, mesh, max_iter=10)(prob.b, prob.x0)
    assert len(res.x.sharding.device_set) == 8
    # replicated outputs are addressable as a whole
    assert np.isfinite(np.asarray(res.trace)[:10]).all()


@pytest.mark.slow
def test_distributed_single_reduction_cg():
    import numpy as np

    from hpccg_tpu import ProblemConfig
    from hpccg_tpu.ops.vector import compute_residual
    from hpccg_tpu.parallel import make_mesh
    from hpccg_tpu.parallel.cg import generate_problem_sharded, make_distributed_cg

    cfg = ProblemConfig(6, 5, 4)
    mesh = make_mesh(4)
    prob = generate_problem_sharded(cfg, mesh)
    r0 = make_distributed_cg(cfg, mesh, max_iter=30)(prob.b, prob.x0)
    t0 = np.asarray(r0.trace)
    good = t0 > 1e-10 * t0[0]
    r1 = make_distributed_cg(cfg, mesh, max_iter=30, method="cg1")(prob.b, prob.x0)
    t1 = np.asarray(r1.trace)
    np.testing.assert_allclose(t1[good], t0[good], rtol=1e-6)
    assert float(compute_residual(r1.x, prob.xexact)) < 1e-10


@pytest.mark.slow
def test_distributed_pipelined_cg():
    import numpy as np

    from hpccg_tpu import ProblemConfig
    from hpccg_tpu.ops.vector import compute_residual
    from hpccg_tpu.parallel import make_mesh
    from hpccg_tpu.parallel.cg import generate_problem_sharded, make_distributed_cg

    cfg = ProblemConfig(6, 5, 4)
    mesh = make_mesh(4)
    prob = generate_problem_sharded(cfg, mesh)
    r0 = make_distributed_cg(cfg, mesh, max_iter=30)(prob.b, prob.x0)
    t0 = np.asarray(r0.trace)
    good = t0 > 1e-8 * t0[0]
    r1 = make_distributed_cg(cfg, mesh, max_iter=30, method="pipecg")(prob.b, prob.x0)
    t1 = np.asarray(r1.trace)
    np.testing.assert_allclose(t1[good], t0[good], rtol=1e-5)
    assert float(compute_residual(r1.x, prob.xexact)) < 1e-9
