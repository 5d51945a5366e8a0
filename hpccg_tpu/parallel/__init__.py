"""Distributed layer (the reference's L2 tier: make_local_matrix.cpp,
exchange_externals.cpp, MPI collectives) rebuilt on jax.sharding.

- mesh.py: mesh construction over chips/hosts (1-D 'z' row axis)
- halo.py: ppermute halo exchange of boundary z-planes + halo'd stencil matvec
- cg.py:   shard_map-ed distributed CG (psum ddots), distributed problem gen,
           and the all-gather fallback path for general ELL matrices
"""

from hpccg_tpu.parallel.mesh import make_mesh, make_mesh2d, row_axis
from hpccg_tpu.parallel.halo import exchange_halo, stencil_matvec_halo
from hpccg_tpu.parallel.cg import (
    generate_problem_sharded,
    make_distributed_cg,
    make_distributed_dia_cg,
    make_distributed_ell_cg,
)

__all__ = [
    "make_mesh",
    "make_mesh2d",
    "row_axis",
    "exchange_halo",
    "stencil_matvec_halo",
    "generate_problem_sharded",
    "make_distributed_cg",
    "make_distributed_dia_cg",
    "make_distributed_ell_cg",
]
