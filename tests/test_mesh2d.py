"""2-D (host, z) mesh control: halos stay within a host except at the
hosts-1 host boundaries, echoing the reference's z-stacked scaling model
(README.md:53-63).

The virtual CPU mesh has one process, so "hosts" here are imposed groups —
the assertions are structural: the mesh is built host-major *explicitly*,
the solve over the ('host', 'z') product axis matches the 1-D solve
bit-for-bit, and every halo ppermute's permutation crosses the host
boundary at exactly the hosts-1 slice boundaries.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # interpreter-heavy 2-D mesh structural checks

import jax
import jax.numpy as jnp

from hpccg_tpu import ProblemConfig
from hpccg_tpu.parallel import make_mesh
from hpccg_tpu.parallel.cg import generate_problem_sharded, make_distributed_cg
from hpccg_tpu.parallel.mesh import axis_size, make_mesh2d, row_axis

HOSTS, CHIPS = 2, 4


def _find_ppermute_perms(jaxpr):
    """All ppermute `perm` params anywhere in a (closed) jaxpr tree."""
    perms = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "ppermute":
                perms.append(list(eqn.params["perm"]))
            for v in eqn.params.values():
                for sub in _subjaxprs(v):
                    walk(sub)

    def _subjaxprs(v):
        # duck-typed: ClosedJaxpr has .jaxpr, Jaxpr has .eqns
        if hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
            return [v.jaxpr]
        if hasattr(v, "eqns"):
            return [v]
        if isinstance(v, (list, tuple)):
            out = []
            for item in v:
                out.extend(_subjaxprs(item))
            return out
        return []

    walk(jaxpr.jaxpr if hasattr(jaxpr, "jaxpr") else jaxpr)
    return perms


def test_mesh2d_shape_and_axes():
    mesh = make_mesh2d(HOSTS, CHIPS)
    assert mesh.shape == {"host": HOSTS, "z": CHIPS}
    assert row_axis(mesh) == ("host", "z")
    assert axis_size(mesh, ("host", "z")) == 8
    # host-major: row h of the device grid is a contiguous host-major slice
    flat = make_mesh(8).devices.ravel()
    np.testing.assert_array_equal(mesh.devices.ravel(), flat)


def test_mesh2d_solve_matches_1d():
    """Same device order, same shards: the ('host','z') solve is the 1-D
    solve with topology made explicit — trajectories agree exactly."""
    cfg = ProblemConfig(6, 5, 3)
    mesh1 = make_mesh(8)
    prob1 = generate_problem_sharded(cfg, mesh1)
    r1 = make_distributed_cg(cfg, mesh1, max_iter=20)(prob1.b, prob1.x0)

    mesh2 = make_mesh2d(HOSTS, CHIPS)
    ax = row_axis(mesh2)
    prob2 = generate_problem_sharded(cfg, mesh2, axis=ax)
    r2 = make_distributed_cg(cfg, mesh2, max_iter=20, axis=ax)(
        prob2.b, prob2.x0
    )
    assert int(r1.niters) == int(r2.niters)
    np.testing.assert_array_equal(np.asarray(r1.trace), np.asarray(r2.trace))
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))


def test_mesh2d_cg1_and_dia_paths():
    from hpccg_tpu.operators import DiaMatrix
    from hpccg_tpu.parallel import make_distributed_dia_cg

    cfg = ProblemConfig(4, 4, 2)
    mesh2 = make_mesh2d(HOSTS, CHIPS)
    ax = row_axis(mesh2)
    prob = generate_problem_sharded(cfg, mesh2, axis=ax)
    r = make_distributed_cg(cfg, mesh2, max_iter=10, axis=ax, method="cg1")(
        prob.b, prob.x0
    )
    assert float(r.normr) < float(r.trace[0])

    n = 256
    rng = np.random.default_rng(0)
    data = np.zeros((3, n))
    data[0, 1:] = rng.uniform(-1, -0.1, n - 1)
    data[1, :] = 6.0
    data[2, : n - 1] = rng.uniform(-1, -0.1, n - 1)
    A = DiaMatrix(data=jnp.asarray(data), offsets=(-1, 0, 1), total_nrow=n)
    b = A.matvec(jnp.ones((n,)))
    rd = make_distributed_dia_cg(mesh2, max_iter=20, axis=ax)(
        A, b, jnp.zeros_like(b)
    )
    assert float(rd.normr) < 1e-8 * float(rd.trace[0])


def test_halo_crosses_host_axis_only_at_slice_boundaries():
    """The jaxpr check: every halo ppermute moves data between flattened
    neighbors, and exactly hosts-1 of those pairs cross a host boundary —
    on hardware those are the only cross-host transfers; all others stay
    on the host's GPU interconnect."""
    cfg = ProblemConfig(4, 4, 2)
    mesh2 = make_mesh2d(HOSTS, CHIPS)
    ax = row_axis(mesh2)
    solve = make_distributed_cg(cfg, mesh2, max_iter=10, axis=ax)
    n = cfg.local_nrow * 8
    jaxpr = jax.make_jaxpr(solve)(
        jnp.zeros((n,)), jnp.zeros((n,))
    )
    perms = _find_ppermute_perms(jaxpr)
    assert perms, "no ppermute found in the distributed solve"
    ndev = HOSTS * CHIPS
    for perm in perms:
        # neighbor exchange on the flattened host-major order
        assert all(abs(dst - src) == 1 for src, dst in perm), perm
        crossing = [
            (src, dst) for src, dst in perm if src // CHIPS != dst // CHIPS
        ]
        assert len(crossing) == HOSTS - 1, (perm, crossing)
        assert len(perm) == ndev - 1, perm


def test_mesh2d_ragged_host_rejected():
    devs = jax.devices()[:6]
    with pytest.raises(ValueError, match="available"):
        make_mesh2d(2, 4, devices=devs)


def test_cli_mesh_2d_matches_1d():
    """--mesh HxZ drives the explicit ('host','z') mesh
    from the command line; the report names the axes and the solve matches
    --mesh 8 bit-for-bit (same flattened row layout)."""
    import contextlib
    import io as _io
    import json

    from hpccg_tpu.cli import main

    base = ["6", "5", "4", "--dtype", "float32", "--max-iter", "15",
            "--skip-kernel-bench", "--json", "--quiet"]

    def run(mesh):
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(base + ["--mesh", mesh])
        assert rc == 0
        return json.loads(buf.getvalue()[buf.getvalue().index("{"):])

    r1 = run("8")
    r2 = run("2x4")
    assert r2["Parallelism"]["Mesh axes"] == "('host', 'z')"
    assert r2["Parallelism"]["Number of mesh devices"] == 8
    assert r1["Parallelism"]["Mesh axes"] == "z"
    assert r2["Number of iterations"] == r1["Number of iterations"]
    assert r2["Final residual"] == r1["Final residual"]  # bit-for-bit


def test_cli_mesh_spec_errors():
    from hpccg_tpu.cli import parse_mesh

    assert parse_mesh("8") == (8, None)
    assert parse_mesh("2x4") == (8, (2, 4))
    import pytest as _pytest

    with _pytest.raises(SystemExit):
        parse_mesh("2x")
    with _pytest.raises(SystemExit):
        parse_mesh("abc")
    with _pytest.raises(SystemExit):
        parse_mesh("0x4")


def test_sweep_mesh_2d_point(capsys):
    import json

    from hpccg_tpu.sweep import main as sweep_main

    rc = sweep_main(
        ["weak", "--meshes", "2x4", "--per-chip", "4",
         "--dtype", "float64", "--iters", "4"]
    )
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    pts = [l for l in lines if l.get("mesh") == 8]
    assert pts and pts[0]["mesh_axes"] == ["host", "z"]
