"""Fused CG direction step for the generated stencil: one Pallas kernel,
compiled through Triton for the GPU.

One CG iteration of the XLA path streams the state through several
fusions: ``p = r + beta*p``, the stencil ``A p``, and the ``p . Ap``
reduction each read their inputs from device memory again. This kernel does
the three in one pass: it reads r and the old p once, writes A p once, and
leaves one partial ``p . Ap`` per program, which a second small reduction
sums (blocks run in no fixed order on the GPU, so nothing is carried
between them). It does not write the new p: XLA recomputes ``r + beta*p``
inside the fusion that consumes it (the x update), which writes it straight
into the loop's p buffer — a kernel output would cost a copy into that
buffer every iteration.

Layout: vectors stay flat in the reference's row order (iz, iy, ix). Each
program owns one (y, x) tile of ``BY x BX`` points (powers of two, edges
masked) and walks a chunk of ``zc`` z-planes in a loop, keeping the
neighbour sums of three consecutive planes in registers: for the 27-point
stencil the 3x3 in-plane box sums of planes z-1, z, z+1; for the 7-point
stencil the centre values of z-1 and z+1 and the in-plane cross of z. The
new p of a neighbour point is formed on the fly from r and the old p.
z-chunks (one more grid axis) give the card enough independent programs;
each chunk re-reads one plane on either side.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from hpccg_tpu.config import DIAG_VALUE, OFFDIAG_VALUE, Stencil

# tile and warps: the fastest of six shapes timed end to end on the H200
# at 100^3 f32, 256^3 f32 and 256^3 f64 (PERF.md)
BY, BX = 8, 64
NUM_WARPS = 8
# programs the launch should offer at least: ~4 per SM of a 132-SM card
MIN_PROGRAMS = 528
# the smallest grid auto hands to the kernel: 100^3, the smallest size timed
# on the H200 (PERF.md)
AUTO_MIN_ROWS = 100**3


def auto_picks_kernel(op) -> bool:
    """The auto rule of solver.resolve_backend for this operator: the
    27-point stencil in f32 or f64 on a GPU, from 100^3 rows up. On the H200
    the kernel ran faster end to end than the XLA stencil at 256^3 and tied
    with it, within run-to-run spread, at 100^3 f32 (PERF.md). Smaller
    grids, the 7-point stencil and 16-bit state stay on XLA, where the
    kernel was not shown to win; so does anything off the GPU, where the
    kernel has no compiled route."""
    return (
        jax.default_backend() == "gpu"
        and op.stencil == Stencil.S27
        and jnp.dtype(op.dtype) in (jnp.float32, jnp.float64)
        and AUTO_MIN_ROWS <= op.local_nrow < 2**31
    )


def z_chunk(op) -> int:
    """Planes per program: the largest of 64/32/16/8 that still yields
    MIN_PROGRAMS programs (8 at small grids)."""
    tiles = pl.cdiv(op.ny, BY) * pl.cdiv(op.nx, BX)
    for zc in (64, 32, 16):
        if tiles * pl.cdiv(op.nz, zc) >= MIN_PROGRAMS:
            return zc
    return 8


def _kernel(beta_ref, r_ref, p_ref, ap_ref, part_ref, *, nx, ny, nz, zc, s27):
    jz, jy, jx = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    iy = jy * BY + jnp.arange(BY)
    ix = jx * BX + jnp.arange(BX)
    beta = beta_ref[0]
    plane = nx * ny
    base = iy[:, None] * nx + ix[None, :]
    shifts = (
        [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        if s27
        else [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    )
    # the in-plane masks do not depend on z: computed once per program
    xy_mask = {
        (dy, dx): (((iy + dy >= 0) & (iy + dy < ny))[:, None]
                   & ((ix + dx >= 0) & (ix + dx < nx))[None, :])
        for dy, dx in shifts
    }

    def load_p(z, dy, dx):
        """New p (= r + beta * old p) at (z, iy+dy, ix+dx); 0 off-grid."""
        m = xy_mask[(dy, dx)] & (z >= 0) & (z < nz)
        idx = base + (z * plane + dy * nx + dx)
        rv = plgpu.load(r_ref.at[idx], mask=m, other=0.0)
        pv = plgpu.load(p_ref.at[idx], mask=m, other=0.0)
        return rv + beta * pv

    def plane_terms(z):
        """(centre, term for the z-neighbours' sums, term for this plane's
        own sum) of plane z."""
        vals = [load_p(z, dy, dx) for dy, dx in shifts]
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        if s27:
            return vals[4], total, total
        return vals[0], vals[0], total

    z0 = jz * zc
    _, zt_prev, _ = plane_terms(z0 - 1)
    c0, zt0, ct0 = plane_terms(z0)
    inside = xy_mask[(0, 0)]

    def step(i, carry):
        a, b, c, acc = carry
        z = z0 + i
        c_n, zt_n, ct_n = plane_terms(z + 1)
        s = a + b + zt_n
        ap = (DIAG_VALUE - OFFDIAG_VALUE) * c + OFFDIAG_VALUE * s
        m = inside & (z < nz)
        plgpu.store(ap_ref.at[base + z * plane], ap, mask=m)
        acc = acc + jnp.where(m, c * ap, 0.0)
        if s27:
            return b, zt_n, c_n, acc
        return c, ct_n, c_n, acc

    init = (zt_prev, zt0 if s27 else ct0, c0, jnp.zeros((BY, BX), c0.dtype))
    *_, acc = jax.lax.fori_loop(0, zc, step, init)
    gy, gx = pl.num_programs(1), pl.num_programs(2)
    part_ref[(jz * gy + jy) * gx + jx] = jnp.sum(acc)


@functools.partial(jax.jit, static_argnames=("op", "interpret"))
def direction_kernel(op, r, p, beta, *, interpret=False):
    """(A p_new, p_new . A p_new) for p_new = r + beta * p: the kernel call
    alone (it does not return p_new)."""
    n = op.local_nrow
    if n >= 2**31:
        raise ValueError(f"{n} rows overflow the kernel's int32 indexing")
    zc = z_chunk(op)
    grid = (pl.cdiv(op.nz, zc), pl.cdiv(op.ny, BY), pl.cdiv(op.nx, BX))
    nprog = grid[0] * grid[1] * grid[2]
    kernel = functools.partial(
        _kernel, nx=op.nx, ny=op.ny, nz=op.nz, zc=zc,
        s27=op.stencil == Stencil.S27,
    )
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    ap, part = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[any_spec] * 3,
        out_specs=[any_spec] * 2,
        out_shape=[
            jax.ShapeDtypeStruct((n,), r.dtype),
            jax.ShapeDtypeStruct((nprog,), r.dtype),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="cg_fused_direction",
    )(jnp.reshape(beta, (1,)).astype(r.dtype), r, p)
    return ap, jnp.sum(part)


def fused_direction(op, r, p, beta, *, interpret: bool = False):
    """(p_new, A p_new, p_new . A p_new) with p_new = r + beta * p, for the
    StencilOperator ``op`` on flat vectors r, p — the ``direction`` step of
    solver.cg_solve. ``interpret`` runs the kernel in the Pallas
    interpreter (CPU tests)."""
    ap, pap = direction_kernel(op, r, p, beta, interpret=interpret)
    return r + beta * p, ap, pap
