"""Scaling-sweep harness smoke tests (runs on the 8 virtual CPU devices)."""

import pytest
import io
import json
from contextlib import redirect_stdout

import numpy as np

from hpccg_tpu.sweep import main as sweep_main


def run_sweep(args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = sweep_main(args)
    lines = [json.loads(l) for l in buf.getvalue().strip().splitlines()]
    return rc, lines


@pytest.mark.slow
def test_weak_sweep():
    rc, lines = run_sweep(
        ["weak", "--per-chip", "8", "--meshes", "1,2,4", "--iters", "4", "--dtype", "float64"]
    )
    assert rc == 0
    pts = [l for l in lines if "mesh" in l and "skipped" not in l]
    assert [p["mesh"] for p in pts] == [1, 2, 4]
    # weak scaling: global problem grows with the mesh
    assert pts[2]["global_nrow"] == 4 * pts[0]["global_nrow"]
    # points whose (t2 - t1) slope lands below timer resolution on these tiny
    # CPU problems report gnnz_per_s=None and are excluded from the summary,
    # so only require consistency, not that all 3 resolved
    summary = lines[-1]
    if "summary" in summary:
        assert summary["summary"] == "weak"
        assert len(summary["efficiency_vs_first"]) == len(summary["meshes"])
        assert set(summary["meshes"]) <= {1, 2, 4}


@pytest.mark.slow
def test_strong_sweep():
    rc, lines = run_sweep(
        ["strong", "--nx", "6", "--ny", "6", "--global-nz", "8",
         "--meshes", "1,2,4,3", "--iters", "4", "--dtype", "float64"]
    )
    assert rc == 0
    pts = [l for l in lines if "gnnz_per_s" in l]
    assert [p["mesh"] for p in pts] == [1, 2, 4, 3]
    # 8 % 3 != 0: the full protocol range runs via masked remainder shards
    # (strongScalingRunScript:6-12 goes to np=64), not a skip
    p3 = pts[-1]
    assert p3.get("remainder_masked") is True and p3["local_dims"][2] == 3
    # strong scaling: the REAL global problem is constant (nnz model keys
    # off the true nz even when rows are padded)
    divisible = [p for p in pts if not p.get("remainder_masked")]
    assert len({p["global_nrow"] for p in divisible}) == 1


@pytest.mark.slow
def test_halo_overlap_matches_nonoverlap():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.parallel import make_mesh
    from hpccg_tpu.parallel.cg import local_operator
    from hpccg_tpu.parallel.halo import stencil_matvec_halo

    for stencil in (27, 7):
        for nz_local in (1, 2, 5):
            cfg = ProblemConfig(5, 4, nz_local, stencil=stencil)
            mesh = make_mesh(4)
            op = local_operator(cfg)
            rng = np.random.default_rng(0)
            x = jnp.asarray(rng.standard_normal(cfg.local_nrow * 4))

            def run(overlap):
                f = jax.jit(
                    jax.shard_map(
                        lambda v: stencil_matvec_halo(op, v, "z", overlap=overlap),
                        mesh=mesh,
                        in_specs=P("z"),
                        out_specs=P("z"),
                    )
                )
                return np.asarray(f(x))

            np.testing.assert_allclose(run(True), run(False), rtol=1e-14)
