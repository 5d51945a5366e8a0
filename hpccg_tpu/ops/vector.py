"""Vector kernels: ddot, waxpby, compute_residual.

These replace the reference's OMP/SYCL loops (ddot.cpp:60-73, waxpby.cpp:69-93,
compute_residual.cpp:62-67). Standing alone they are single jnp ops; inside the
jitted CG loop XLA fuses them into neighboring computations — the reference's
hand-written alpha==1/beta==1 specializations (waxpby.cpp:71-85) and SYCL
event-chaining (waxpby.cpp:100-119) dissolve into the XLA dataflow graph.

The distributed variants take an ``axis_name`` and reduce with psum/pmax —
the psum is the exact role of MPI_Allreduce in ddot.cpp:75-82 and
compute_residual.cpp:68-75, lowered by XLA to the device collective (NCCL on
GPUs).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def ddot(x: jax.Array, y: jax.Array, *, axis_name: Optional[str] = None) -> jax.Array:
    """Global dot product (ref ddot.cpp). With axis_name, psum across the mesh.

    Written as multiply-then-reduce, never as a ``dot``: XLA may run an f32
    dot on GPU tensor cores in TF32 (about three decimal digits), which
    would corrupt CG's alpha and beta. An elementwise product and a sum
    keep full precision under any ``jax_default_matmul_precision``, and
    fuse into the neighbouring vector update."""
    local = jnp.sum(x * y)
    if axis_name is not None:
        local = jax.lax.psum(local, axis_name)
    return local


def waxpby(alpha, x: jax.Array, beta, y: jax.Array) -> jax.Array:
    """w = alpha*x + beta*y (ref waxpby.cpp:54-93)."""
    return alpha * x + beta * y


def compute_residual(
    v1: jax.Array, v2: jax.Array, *, axis_name: Optional[str] = None
) -> jax.Array:
    """max_i |v1 - v2| (ref compute_residual.cpp:59-81; MPI_MAX -> pmax)."""
    local = jnp.max(jnp.abs(v1 - v2))
    if axis_name is not None:
        local = jax.lax.pmax(local, axis_name)
    return local
