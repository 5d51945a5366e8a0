"""The fused CG direction kernel (ops/stencil_kernel.py): interpret-mode
parity with the XLA stencil on the CPU, the wrapper's grid and routing, and
a compiled check on the card (``gpu`` marker)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hpccg_tpu.config import Stencil
from hpccg_tpu.operators import StencilOperator
from hpccg_tpu.ops.stencil_kernel import fused_direction, z_chunk

DIMS = [(5, 7, 9), (16, 16, 16), (3, 17, 20), (70, 9, 11), (1, 1, 1), (65, 3, 2)]


def _inputs(op, dtype, seed=0):
    k = jax.random.split(jax.random.PRNGKey(seed))
    n = op.local_nrow
    return (
        jax.random.normal(k[0], (n,), dtype),
        jax.random.normal(k[1], (n,), dtype),
        jnp.asarray(0.37, dtype),
    )


def _check(op, dtype, **kw):
    r, p, beta = _inputs(op, dtype)
    p_new, ap, pap = fused_direction(op, r, p, beta, **kw)
    p_ref = r + beta * p
    ap_ref = op.matvec(p_ref)
    eps = float(jnp.finfo(dtype).eps)
    # p_new is the same elementwise expression (a fused multiply-add may
    # round once instead of twice): within an ulp of its terms
    bound = 2 * eps * (jnp.abs(r) + jnp.abs(beta * p))
    assert bool(jnp.all(jnp.abs(p_new - p_ref) <= bound))
    # A p sums up to 27 terms in another order: a few ulp of the magnitude
    scale = float(jnp.max(jnp.abs(ap_ref)))
    assert float(jnp.max(jnp.abs(ap - ap_ref))) <= 32 * eps * scale
    # p . Ap: per-program partials, then a sum — another summation order
    pap_ref = float(jnp.sum(p_ref * ap_ref))
    mag = float(jnp.sum(jnp.abs(p_ref * ap_ref)))
    assert abs(float(pap) - pap_ref) <= 64 * eps * mag


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("stencil", [Stencil.S27, Stencil.S7])
@pytest.mark.parametrize("dims", DIMS)
def test_fused_direction_matches_xla(dims, stencil, dtype):
    op = StencilOperator(*dims, stencil=stencil, dtype_name=jnp.dtype(dtype).name)
    _check(op, dtype, interpret=True)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_beta_zero_direction_is_r(dtype):
    """k == 1 of CG runs beta = 0: the new direction is r itself."""
    op = StencilOperator(6, 5, 4, dtype_name=jnp.dtype(dtype).name)
    r, p, _ = _inputs(op, dtype, seed=3)
    p_new, ap, _ = fused_direction(op, r, p, jnp.asarray(0.0, dtype), interpret=True)
    np.testing.assert_array_equal(np.asarray(p_new), np.asarray(r))
    np.testing.assert_allclose(np.asarray(ap), np.asarray(op.matvec(r)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "dims,want",
    [
        ((1, 1, 1), 8),
        ((100, 100, 100), 8),  # 26 tiles: even zc=8 gives only 338 programs
        ((256, 256, 256), 32),  # 128 tiles x 8 chunks = 1024 programs
        ((512, 512, 512), 64),
        ((928, 928, 928), 64),
        ((64, 64, 1024), 8),  # 8 tiles: 512 programs at zc=16 is too few
    ],
)
def test_z_chunk_offers_enough_programs(dims, want):
    op = StencilOperator(*dims)
    assert z_chunk(op) == want


@pytest.mark.parametrize("stencil", [Stencil.S27, Stencil.S7])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_kernel_cg_matches_xla_cg(stencil, dtype):
    """A whole CG solve with the fused direction step reproduces the XLA
    solve's trajectory (summation order differs: rounding-level)."""
    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.solver import cg_solve, make_cg

    prob = generate_problem(ProblemConfig(6, 5, 4, stencil=stencil, dtype=dtype))
    ref = make_cg(prob.A, max_iter=12)(prob.b, prob.x0)
    direction = functools.partial(fused_direction, prob.A, interpret=True)
    got = jax.jit(
        lambda b, x0: cg_solve(prob.A.matvec, b, x0, max_iter=12, direction=direction)
    )(prob.b, prob.x0)
    assert int(got.niters) == int(ref.niters)
    t_ref, t_got = np.asarray(ref.trace, np.float64), np.asarray(got.trace, np.float64)
    floor = 1e-4 if dtype == jnp.float32 else 1e-12
    good = t_ref > floor * t_ref[0]
    rtol = 1e-3 if dtype == jnp.float32 else 1e-9
    np.testing.assert_allclose(t_got[good], t_ref[good], rtol=rtol)


@pytest.mark.parametrize("stencil", [Stencil.S27, Stencil.S7])
def test_make_cg_triton_routes_the_kernel(stencil):
    """backend="triton" puts the named kernel in the solve; the default
    backend does not (auto stays on XLA until the kernel wins)."""
    from hpccg_tpu import ProblemConfig, generate_problem
    from hpccg_tpu.solver import make_cg

    prob = generate_problem(ProblemConfig(6, 5, 4, stencil=stencil))
    for backend, want in (("triton", True), ("auto", False)):
        jaxpr = str(jax.make_jaxpr(make_cg(prob.A, max_iter=5, backend=backend))(prob.b, prob.x0))
        assert ("cg_fused_direction" in jaxpr) == want, backend


@pytest.mark.parametrize(
    "dims,stencil,dtype,want",
    [
        ((256, 256, 256), Stencil.S27, "float64", True),
        ((100, 100, 100), Stencil.S27, "float32", True),
        ((99, 100, 100), Stencil.S27, "float32", False),  # below the timed sizes
        ((32, 32, 32), Stencil.S27, "float64", False),  # bench.py's parity32
        ((256, 256, 256), Stencil.S7, "float32", False),  # 7-point: not timed
        ((256, 256, 256), Stencil.S27, "bfloat16", False),
        ((2048, 1024, 1024), Stencil.S27, "float32", False),  # int32 indexing
    ],
)
def test_auto_rule_on_gpu(monkeypatch, dims, stencil, dtype, want):
    """What auto picks when JAX's backend is the GPU (only the sizes and
    dtypes the kernel was timed faster or level at go to it)."""
    from hpccg_tpu.ops.stencil_kernel import auto_picks_kernel
    from hpccg_tpu.solver import resolve_backend

    op = StencilOperator(*dims, stencil=stencil, dtype_name=dtype)
    assert not auto_picks_kernel(op)  # never off the GPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert auto_picks_kernel(op) == want
    assert resolve_backend(op, "auto") == ("triton" if want else "stencil")


def test_kernel_rejects_int32_overflow():
    op = StencilOperator(2048, 1024, 1024, dtype_name="float32")
    sds = jax.ShapeDtypeStruct((op.local_nrow,), jnp.float32)
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(
            lambda r, p: fused_direction(op, r, p, jnp.float32(0.5)), sds, sds
        )


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_fused_direction_compiled_on_card(gpu, dtype):
    op = StencilOperator(96, 80, 64, dtype_name=jnp.dtype(dtype).name)
    _check(op, dtype)
