"""hpccg_tpu — a sparse linear-algebra / conjugate-gradient framework in JAX.

Built from scratch in JAX/XLA (one Pallas kernel, compiled through Triton
for NVIDIA GPUs) with the full capability surface of the HPCCG mini-app
(reference: Dart120/HPCCG-SYCL):

- 27-point / 7-point 3-D stencil problem generators (ref generate_matrix.cpp)
- SpMV as (a) an implicit stencil operator — A@x is a one-pass 27-point
  stencil, not a random gather — and (b) explicit matrices: banded DIA
  (gather-free) or padded ELL with an XLA gather (ref HPC_sparsemv.cpp)
- fused ddot / waxpby / residual vector ops (ref ddot.cpp, waxpby.cpp,
  compute_residual.cpp)
- the full CG iteration loop as a single jitted lax.while_loop
  (ref HPCCG.cpp:312-402)
- distributed execution over a jax.sharding.Mesh: ppermute halo exchange of
  boundary z-planes (ref exchange_externals.cpp) + psum reductions
  (ref ddot.cpp:75-82), all inside shard_map
- a structured YAML/JSON benchmark reporter (ref YAML_Doc.{hpp,cpp}, main.cpp)

The package layout maps the reference's layer map (SURVEY.md §1):
  models/    — problem construction (L1): stencil generator, HPC-row file IO
  ops/       — compute kernels (L3): SpMV, ddot, waxpby, residual; the fused
               Triton direction kernel (stencil_kernel.py)
  parallel/  — communication layer (L2): mesh, halo exchange, distributed CG
  solver.py  — CG solver (L4)
  cli.py     — driver / report (L5/L0)
  utils/     — timing + YAML reporting (L0)
"""

__version__ = "0.1.0"

from hpccg_tpu.config import ProblemConfig, SolverConfig, Stencil
from hpccg_tpu.operators import DiaMatrix, EllMatrix, StencilOperator
from hpccg_tpu.models.stencil import generate_problem
from hpccg_tpu.reorder import auto_structure, rcm_permutation
from hpccg_tpu.solver import CGResult, cg_solve, cg_solve_refined, make_cg

__all__ = [
    "ProblemConfig",
    "SolverConfig",
    "Stencil",
    "StencilOperator",
    "EllMatrix",
    "DiaMatrix",
    "generate_problem",
    "auto_structure",
    "rcm_permutation",
    "cg_solve",
    "cg_solve_refined",
    "make_cg",
    "CGResult",
    "__version__",
]
