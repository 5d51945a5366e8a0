"""Halo exchange + halo'd stencil matvec (ref exchange_externals.cpp:51-131).

The reference posts MPI_Irecv/MPI_Send per neighbor and packs a gather-list
send buffer before every SpMV. For the z-stacked stencil problem each rank
exchanges exactly its top/bottom nx*ny boundary plane with <=2 neighbors
(SURVEY.md §3.4) — here that is one ``jax.lax.ppermute`` per direction over
the 'z' mesh axis, which XLA lowers to the device interconnect (NCCL over
NVLink between GPUs). Non-periodic global boundaries fall out of
ppermute semantics for free: destinations with no source receive zeros, which
is exactly the stencil's boundary clipping.

The reference's comm-plan construction (make_local_matrix.cpp, 611 lines of
index scans and MPI handshakes) dissolves entirely: the halo is static
metadata of the partition, known at trace time.

All functions here run *inside* shard_map over a mesh with axis ``axis_name``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hpccg_tpu.config import DIAG_VALUE, OFFDIAG_VALUE, Stencil
from hpccg_tpu.operators import StencilOperator, _axis_sum3


def exchange_halo(u: jax.Array, axis_name: str = "z"):
    """Exchange boundary z-planes with mesh neighbors.

    u: local grid block (local_nz, ny, nx).
    Returns (below, above): the neighbor planes adjacent to our first/last
    z-plane, zeros at the global domain boundary.
    """
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        zero = jnp.zeros_like(u[0])
        return zero, zero
    # device i's last plane -> device i+1's "below" halo
    below = jax.lax.ppermute(u[-1], axis_name, [(i, i + 1) for i in range(n - 1)])
    # device i's first plane -> device i-1's "above" halo
    above = jax.lax.ppermute(u[0], axis_name, [(i + 1, i) for i in range(n - 1)])
    return below, above


def _neighbor_sum_halo(u: jax.Array, below: jax.Array, above: jax.Array, stencil: Stencil):
    """Boundary-clipped neighbor sum (incl. self) of the *global* field,
    restricted to this shard, given the exchanged halo planes."""
    ue = jnp.concatenate([below[None], u, above[None]], axis=0)
    nz = u.shape[0]
    if stencil == Stencil.S27:
        xy = _axis_sum3(_axis_sum3(ue, 2), 1)
        return xy[0:nz] + xy[1 : nz + 1] + xy[2 : nz + 2]
    # 7-pt: self + x/y face neighbors (local) + z face neighbors (from ue)
    xy_cross = _axis_sum3(u, 2) + _axis_sum3(u, 1) - u
    return xy_cross + ue[0:nz] + ue[2 : nz + 2]


def _neighbor_sum_halo_overlap(u, below, above, stencil: Stencil):
    """Same sum as _neighbor_sum_halo, but grouped so that everything except
    the two boundary planes is independent of the exchanged halos — XLA's
    latency-hiding scheduler can then run the ppermute concurrently with the
    interior compute (the halo/compute overlap of SURVEY.md §7.7, the analog
    of overlapping exchange_externals with interior SpMV)."""
    nz = u.shape[0]
    if stencil == Stencil.S27:
        xy = _axis_sum3(_axis_sum3(u, 2), 1)  # halo-independent
        xy_b = _axis_sum3(_axis_sum3(below[None], 2), 1)
        xy_a = _axis_sum3(_axis_sum3(above[None], 2), 1)
        lo = xy_b[0] + xy[0] + (xy[1] if nz > 1 else xy_a[0])
        if nz == 1:
            return lo[None]
        hi = xy[nz - 2] + xy[nz - 1] + xy_a[0]
        interior = xy[0 : nz - 2] + xy[1 : nz - 1] + xy[2:nz]
        return jnp.concatenate([lo[None], interior, hi[None]], axis=0)
    cross = _axis_sum3(u, 2) + _axis_sum3(u, 1) - u  # halo-independent
    z_lo = jnp.concatenate([below[None], u[:-1]], axis=0)
    z_hi = jnp.concatenate([u[1:], above[None]], axis=0)
    return cross + z_lo + z_hi


def stencil_matvec_halo(
    op: StencilOperator,
    x_local: jax.Array,
    axis_name: str = "z",
    overlap: bool = True,
) -> jax.Array:
    """Distributed A @ x for one z-shard (op holds the *local* dims).

    y = (DIAG-OFFDIAG)*x + OFFDIAG * S(x) with S the halo'd neighbor sum —
    the fused equivalent of exchange_externals + HPC_sparsemv per iteration
    (HPCCG.cpp:377-379). With overlap=True (default) the interior compute
    carries no data dependency on the ppermute.
    """
    u = op.grid(x_local)
    below, above = exchange_halo(u, axis_name)
    if overlap:
        s = _neighbor_sum_halo_overlap(u, below, above, op.stencil)
    else:
        s = _neighbor_sum_halo(u, below, above, op.stencil)
    y = (DIAG_VALUE - OFFDIAG_VALUE) * u + OFFDIAG_VALUE * s
    return y.reshape(-1)

