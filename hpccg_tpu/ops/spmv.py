"""SpMV dispatch (ref HPC_sparsemv.cpp:68-109).

Every operator representation carries its own ``matvec``:
- StencilOperator: implicit stencil (separable neighbor sums; no gather);
- DiaMatrix: masked roll-multiply-add per diagonal, one XLA fusion;
- EllMatrix: gather by column index + row reduction (the general path and
  correctness oracle).
"""

from __future__ import annotations

import jax

from hpccg_tpu.operators import DiaMatrix, EllMatrix, StencilOperator


def spmv(A, x: jax.Array) -> jax.Array:
    """y = A @ x for any operator representation."""
    if isinstance(A, (StencilOperator, EllMatrix, DiaMatrix)):
        return A.matvec(x)
    raise TypeError(f"unknown operator type {type(A)}")
