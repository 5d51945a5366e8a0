"""Every solver dot is multiply-then-reduce, never a ``dot_general``.

On GPU tensor cores an f32 ``dot`` may run in TF32 (about three decimal
digits) under the default matmul precision, which would corrupt CG's alpha
and beta. ops.vector.ddot, the one-reduction pairs and the ELL matvec are
written as an elementwise product and a sum, which no precision setting
touches. These tests walk the jaxprs of every solve path and fail on any
dot_general that is not pinned to HIGHEST.
"""

import pytest

import jax
import jax.numpy as jnp

from hpccg_tpu import ProblemConfig, generate_problem
from hpccg_tpu.models.stencil import generate_ell


def _subjaxprs(params):
    for v in params.values():
        vs = v if isinstance(v, (list, tuple)) else [v]
        for item in vs:
            if hasattr(item, "jaxpr") and hasattr(item.jaxpr, "eqns"):
                yield item.jaxpr
            elif hasattr(item, "eqns"):
                yield item


def unpinned_dots(jaxpr):
    """Names of dot_general eqns (recursively) without HIGHEST precision."""
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                prec = eqn.params.get("precision")
                pinned = prec is not None and all(
                    p == jax.lax.Precision.HIGHEST for p in (prec if isinstance(prec, tuple) else (prec,))
                )
                if not pinned:
                    found.append(str(eqn))
            for sub in _subjaxprs(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr if hasattr(jaxpr, "jaxpr") else jaxpr)
    return found


def _operator(kind, dtype):
    cfg = ProblemConfig(4, 4, 4, dtype=dtype)
    if kind == "stencil":
        prob = generate_problem(cfg)
        return prob.A, prob
    prob = generate_ell(cfg)
    return (prob.A if kind == "ell" else prob.A.to_dia()), prob


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
@pytest.mark.parametrize("kind", ["stencil", "ell", "dia"])
def test_single_device_solves_have_no_unpinned_dot(kind, method):
    from hpccg_tpu.solver import make_cg

    A, prob = _operator(kind, jnp.float32)
    solve = make_cg(A, max_iter=4, method=method)
    assert unpinned_dots(jax.make_jaxpr(solve)(prob.b, prob.x0)) == []


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
@pytest.mark.parametrize("kind", ["stencil", "ell", "dia"])
def test_distributed_solves_have_no_unpinned_dot(kind, method):
    from hpccg_tpu.parallel import (
        generate_problem_sharded,
        make_distributed_cg,
        make_distributed_dia_cg,
        make_distributed_ell_cg,
        make_mesh,
    )
    from hpccg_tpu.parallel.cg import shard_problem

    mesh = make_mesh(2)
    if kind == "stencil":
        cfg = ProblemConfig(4, 4, 2, dtype=jnp.float32)
        prob = generate_problem_sharded(cfg, mesh)
        fn = make_distributed_cg(cfg, mesh, max_iter=4, method=method)
        jaxpr = jax.make_jaxpr(fn)(prob.b, prob.x0)
    else:
        prob = generate_ell(ProblemConfig(4, 4, 4, dtype=jnp.float32))
        if kind == "dia":
            A = prob.A.to_dia()
            fn = make_distributed_dia_cg(mesh, max_iter=4, method=method)
        else:
            prob = shard_problem(prob, mesh)
            A = prob.A
            fn = make_distributed_ell_cg(mesh, max_iter=4, method=method)
        jaxpr = jax.make_jaxpr(lambda b, x0: fn(A, b, x0))(prob.b, prob.x0)
    assert unpinned_dots(jaxpr) == []


def test_ddot_is_a_reduction_not_a_dot():
    from hpccg_tpu.ops.vector import ddot

    x = jnp.arange(8.0, dtype=jnp.float32)
    jaxpr = jax.make_jaxpr(ddot)(x, x)
    prims = {e.primitive.name for e in jaxpr.jaxpr.eqns}
    assert "dot_general" not in prims and "reduce_sum" in prims
    assert float(ddot(x, x)) == float(jnp.sum(x * x))


def test_walker_sees_an_unpinned_vdot():
    """The check itself: a raw jnp.vdot inside a solve is reported."""
    from hpccg_tpu.solver import cg_solve

    prob = generate_problem(ProblemConfig(4, 4, 4, dtype=jnp.float32))
    raw = jax.make_jaxpr(
        lambda b, x0: cg_solve(prob.A.matvec, b, x0, max_iter=3, dot=jnp.vdot)
    )(prob.b, prob.x0)
    assert unpinned_dots(raw)
    pinned = jax.make_jaxpr(
        lambda b, x0: cg_solve(
            prob.A.matvec, b, x0, max_iter=3,
            dot=lambda u, v: jnp.vdot(u, v, precision=jax.lax.Precision.HIGHEST),
        )
    )(prob.b, prob.x0)
    assert unpinned_dots(pinned) == []
