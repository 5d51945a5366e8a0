"""27-pt / 7-pt stencil problem generator (ref generate_matrix.cpp:196-307).

The reference builds the matrix with a serial triple host loop emitting jagged
CSR. Here the implicit-operator path materializes *nothing* (the operator is
pure metadata) and the explicit-ELL path is fully vectorized — device-side
iota -> 3-D coords -> 27 candidate columns + validity mask — so problem setup
is O(1) host work instead of O(27 n) serial loop iterations.

Problem semantics reproduced exactly:
- z-stacked domain decomposition: rank r owns global rows
  [local_nrow*r, local_nrow*(r+1)) (generate_matrix.cpp:225-229)
- boundary clipping in x/y by coordinate, in z by global row range
  (generate_matrix.cpp:266)
- diag 27.0 / off-diag -1.0 (:268-274)
- b = A @ ones, i.e. b[i] = 27 - (nnz_in_row[i] - 1) (:285); xexact = 1 (:286);
  x0 = 0 (:284)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from hpccg_tpu.config import DIAG_VALUE, OFFDIAG_VALUE, ProblemConfig, Stencil
from hpccg_tpu.operators import EllMatrix, StencilOperator, stencil_offsets


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["A", "b", "x0", "xexact"],
    meta_fields=["total_nrow", "total_nnz_model", "total_nnz_exact"],
)
@dataclasses.dataclass(frozen=True)
class Problem:
    """A generated CG problem: A, b, x0, xexact + global metadata."""

    A: Union[StencilOperator, EllMatrix]
    b: jax.Array
    x0: jax.Array
    xexact: jax.Array
    total_nrow: int
    total_nnz_model: int  # reference's approximate 27*total_nrow (main.cpp:226)
    total_nnz_exact: int

    @property
    def local_nrow(self) -> int:
        return self.b.shape[0]


@partial(jax.jit, static_argnums=0)
def generate_problem(cfg: ProblemConfig) -> Problem:
    """Single-domain problem with the implicit stencil operator (fast path).

    Jitted as a unit (cfg is static): problem setup is one compiled program,
    not a chain of eager dispatches — the device-side answer to the
    reference's serial host loop.

    For the multi-shard (z-stacked) case, the parallel layer builds b/x0 inside
    shard_map — see hpccg_tpu.parallel.cg.
    """
    op = StencilOperator(
        nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, stencil=cfg.stencil, dtype_name=jnp.dtype(cfg.dtype).name
    )
    n = op.local_nrow
    xexact = jnp.ones((n,), cfg.dtype)
    b = op.matvec(xexact)  # exactly b[i] = 27 - (nnzrow-1)
    x0 = jnp.zeros((n,), cfg.dtype)
    return Problem(
        A=op,
        b=b,
        x0=x0,
        xexact=xexact,
        total_nrow=n,
        total_nnz_model=op.nnz_model,
        total_nnz_exact=op.nnz,
    )


def _ell_arrays(cfg: ProblemConfig, start_row: int, total_nrow: int):
    """Vectorized ELL construction for rows [start_row, start_row+local_nrow)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    n = cfg.local_nrow
    offs = stencil_offsets(cfg.stencil)
    width = len(offs)

    if total_nrow > 2**31:
        # EllMatrix.cols is int32 (half the index bytes of int64); a >2^31-row
        # explicit matrix would wrap silently. The implicit StencilOperator
        # has no such limit — use it (or shard the explicit build).
        raise ValueError(
            f"explicit ELL construction supports < 2^31 global rows "
            f"(got {total_nrow}); use the implicit StencilOperator instead"
        )
    lrow = jnp.arange(n, dtype=jnp.int32)
    ix = lrow % nx
    iy = (lrow // nx) % ny
    grow = lrow + start_row

    off = np.asarray(offs, dtype=np.int64)  # (width, 3) as (sz, sy, sx)
    dcol = off[:, 0] * nx * ny + off[:, 1] * nx + off[:, 2]

    cols = grow[:, None] + jnp.asarray(dcol)[None, :]
    sx = jnp.asarray(off[:, 2])[None, :]
    sy = jnp.asarray(off[:, 1])[None, :]
    valid = (
        (ix[:, None] + sx >= 0)
        & (ix[:, None] + sx < nx)
        & (iy[:, None] + sy >= 0)
        & (iy[:, None] + sy < ny)
        & (cols >= 0)
        & (cols < total_nrow)
    )
    is_diag = cols == grow[:, None]
    vals = jnp.where(
        valid, jnp.where(is_diag, DIAG_VALUE, OFFDIAG_VALUE), 0.0
    ).astype(cfg.dtype)
    cols = jnp.where(valid, cols, 0).astype(jnp.int32)
    return vals, cols, valid


@partial(jax.jit, static_argnums=(0, 1, 2))
def generate_ell(cfg: ProblemConfig, rank: int = 0, size: int = 1) -> Problem:
    """Explicit padded-ELL problem, rank's z-stacked shard (general path).

    Mirrors the reference generator exactly, including the partition metadata
    (generate_matrix.cpp:298-304).
    """
    n = cfg.local_nrow
    total_nrow = n * size
    start_row = n * rank
    vals, cols, valid = _ell_arrays(cfg, start_row, total_nrow)
    A = EllMatrix(
        vals=vals, cols=cols, valid=valid, start_row=start_row, total_nrow=total_nrow
    )
    nnz_row = valid.sum(axis=1)
    xexact = jnp.ones((n,), cfg.dtype)
    # b = A @ ones: the diagonal contributes 27, each of the (nnzrow-1)
    # off-diagonals contributes -1 (generate_matrix.cpp:285)
    b = DIAG_VALUE + OFFDIAG_VALUE * (nnz_row.astype(cfg.dtype) - 1.0)
    x0 = jnp.zeros((n,), cfg.dtype)
    # exact total nnz: sum of this shard's counts times... each shard differs at
    # z boundaries; compute exactly via a global-extent product (cheap, static).
    op_global = StencilOperator(
        nx=cfg.nx, ny=cfg.ny, nz=cfg.nz * size, stencil=cfg.stencil,
        dtype_name=jnp.dtype(cfg.dtype).name,
    )
    return Problem(
        A=A,
        b=b,
        x0=x0,
        xexact=xexact,
        total_nrow=total_nrow,
        total_nnz_model=cfg.stencil.value * total_nrow,
        total_nnz_exact=op_global.nnz,
    )
