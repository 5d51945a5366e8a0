"""Distributed CG over a device mesh (ref HPCCG.cpp under -DUSING_MPI).

The whole solve runs inside one jitted shard_map: vectors are sharded z-plane
blocks (P('z')), the SpMV exchanges halo planes with ppermute, dot products
psum across the mesh, and the while_loop's scalar state (rtrans, normr, k) is
replicated on every device — the loop condition never touches the host.

This mirrors the reference cost shape exactly (SURVEY.md §3.2): per iteration
two allreduces (psum), one halo exchange (2x ppermute), one SpMV, three
axpbys — but with zero per-iteration host dispatch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hpccg_tpu.config import ProblemConfig
from hpccg_tpu.models.stencil import Problem
from hpccg_tpu.operators import EllMatrix, StencilOperator
from hpccg_tpu.ops.vector import ddot
from hpccg_tpu.parallel.halo import stencil_matvec_halo
from hpccg_tpu.parallel.mesh import Axis, Z_AXIS, axis_size
from hpccg_tpu.solver import CGResult, cg_solve


def _result_specs(shard_spec: P) -> CGResult:
    """out_specs pytree: x sharded, scalar state + trace replicated."""
    return CGResult(x=shard_spec, niters=P(), normr=P(), rtrans=P(), trace=P())


def _method_runner(method: str, axis: Axis, replace_every: int = 0):
    """run(matvec, b, x0, *, max_iter, tolerance) for use INSIDE shard_map,
    dispatching on the CG recurrence with mesh-reduced dot products:
    "cg" = the reference 2-allreduce recurrence (HPCCG.cpp:367,381),
    "cg1" = Chronopoulos-Gear single fused reduction, "pipecg" =
    Ghysels-Vanroose (the reduction overlaps the SpMV). Shared by every
    distributed factory so --method works on loaded matrices and the
    generated stencil alike."""
    if method == "cg":

        def run(matvec, b, x0, *, max_iter, tolerance):
            return cg_solve(
                matvec, b, x0, max_iter=max_iter, tolerance=tolerance,
                dot=lambda u, v: ddot(u, v, axis_name=axis),
            )

        return run
    if method not in ("cg1", "pipecg"):
        raise ValueError(f"unknown CG method {method!r}")
    from hpccg_tpu.solver import SOLVERS

    solver_fn = SOLVERS[method]

    def pdot2(p1, p2):
        tot = jax.lax.psum(jnp.stack([ddot(*p1), ddot(*p2)]), axis)
        return tot[0], tot[1]

    def run(matvec, b, x0, *, max_iter, tolerance):
        return solver_fn(
            matvec, b, x0, max_iter=max_iter, tolerance=tolerance, dot2=pdot2,
            replace_every=replace_every,
        )

    return run


class _BoundedCache(dict):
    """FIFO-bounded memo dict for the solver factories' jitted closures.
    The memo exists so a warm call never retraces inside the caller's timed
    region; the bound exists so a long-lived process sweeping many matrix
    layouts cannot grow it without limit. Eviction drops the oldest entry —
    its XLA executable is reclaimed once no caller holds it; re-solving that
    layout later costs one retrace, not correctness."""

    def __init__(self, maxsize: int = 16):
        super().__init__()
        self._maxsize = maxsize

    def __setitem__(self, key, value):
        if key not in self and len(self) >= self._maxsize:
            del self[next(iter(self))]
        super().__setitem__(key, value)


def local_operator(cfg_local: ProblemConfig) -> StencilOperator:
    return StencilOperator(
        nx=cfg_local.nx,
        ny=cfg_local.ny,
        nz=cfg_local.nz,
        stencil=cfg_local.stencil,
        dtype_name=jnp.dtype(cfg_local.dtype).name,
    )


def generate_problem_sharded(
    cfg_local: ProblemConfig, mesh: Mesh, *, axis: Axis = Z_AXIS
) -> Problem:
    """Generate the global z-stacked problem, sharded over the mesh.

    b is computed *in place on each shard* as A @ ones with halo'd matvec —
    ones arrive from neighbors, zeros at global boundaries — reproducing the
    reference's per-rank generation (generate_matrix.cpp:284-286) with no
    host loop and no cross-host data movement beyond the halo planes.
    """
    size = axis_size(mesh, axis)
    op_local = local_operator(cfg_local)
    n_local = cfg_local.local_nrow
    n_total = n_local * size
    dtype = cfg_local.dtype

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    def build():
        ones = jnp.ones((n_local,), dtype)
        b = stencil_matvec_halo(op_local, ones, axis)
        x0 = jnp.zeros((n_local,), dtype)
        return b, x0, ones

    b, x0, xexact = build()
    op_global = StencilOperator(
        nx=cfg_local.nx,
        ny=cfg_local.ny,
        nz=cfg_local.nz * size,
        stencil=cfg_local.stencil,
        dtype_name=jnp.dtype(dtype).name,
    )
    return Problem(
        A=op_global,
        b=b,
        x0=x0,
        xexact=xexact,
        total_nrow=n_total,
        total_nnz_model=cfg_local.stencil.value * n_total,
        total_nnz_exact=op_global.nnz,
    )


def make_distributed_cg(
    cfg_local: ProblemConfig,
    mesh: Mesh,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    axis: Axis = Z_AXIS,
    method: str = "cg",
    replace_every: int = 0,
):
    """Jitted distributed solve(b, x0) -> CGResult for the stencil operator.

    b/x0 are global flat (n_total,) arrays sharded P(axis); the result x comes
    back sharded the same way, trace/niters/normr replicated. Each shard
    runs the XLA halo stencil (ppermuted boundary planes, overlapped with
    the interior); method="cg1"/"pipecg" collapse the iteration's two
    allreduces into one psum of a stacked 2-vector (pipecg also overlaps it
    with the SpMV; PAPERS.md).
    """
    op_local = local_operator(cfg_local)
    run = _method_runner(method, axis, replace_every)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=_result_specs(P(axis)),
    )
    def solve(b, x0):
        return run(
            lambda v: stencil_matvec_halo(op_local, v, axis),
            b, x0, max_iter=max_iter, tolerance=tolerance,
        )

    return solve


def make_distributed_ell_cg(
    mesh: Mesh,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    axis: Axis = Z_AXIS,
    method: str = "cg",
    replace_every: int = 0,
):
    """General explicit-matrix path: solve(A_global, b, x0) with A in padded
    ELL, rows sharded P(axis), columns global.

    The SpMV all-gathers x across the mesh then gathers by global column —
    the equivalent of the reference's general gather-list comm plan
    (make_local_matrix.cpp) for matrices without z-stacked structure.
    """
    row_spec = P(axis, None)
    run = _method_runner(method, axis, replace_every)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(row_spec, row_spec, row_spec, P(axis), P(axis)),
        out_specs=_result_specs(P(axis)),
    )
    def _solve(vals, cols, valid, b, x0):
        A_local = EllMatrix(vals=vals, cols=cols, valid=valid, start_row=0)

        def matvec(v):
            xg = jax.lax.all_gather(v, axis, tiled=True)
            return A_local.matvec(xg)

        return run(matvec, b, x0, max_iter=max_iter, tolerance=tolerance)

    def solve(A: EllMatrix, b, x0):
        if A.start_row != 0:
            raise ValueError("pass the assembled global EllMatrix (start_row=0)")
        return _solve(A.vals, A.cols, A.valid, b, x0)

    return solve


def _z_mask(op_local: StencilOperator, shard_idx, nz_global: int, dtype):
    """(nz_local, 1) mask of this shard's planes inside the real domain."""
    z = jnp.arange(op_local.nz) + shard_idx * op_local.nz
    return (z < nz_global).astype(dtype)[:, None]


def make_distributed_cg_masked(
    cfg_local: ProblemConfig,
    mesh: Mesh,
    *,
    nz_global: int,
    max_iter: int,
    tolerance: float = 0.0,
    axis: Axis = Z_AXIS,
):
    """Distributed stencil CG for a global nz that does NOT divide the mesh.

    The reference's strong-scaling protocol runs nz = 1024/np for np up to
    64 (strongScalingRunScript:6-12) — non-divisible points need remainder
    handling (read_HPC_row.cpp:255-266 does ragged blocks; shard_map needs
    equal shards). Here every shard carries ceil(nz/np) planes and the
    operator is masked to the real domain: y = M A (M x) with M zeroing the
    trailing padded planes. Because the generated diagonal is constant
    (27.0) and off-diagonals couple only through x values (zero on padding),
    M A M restricted to real rows IS the true global operator — and with
    b = x0 = 0 on padding, the padded residuals are identically zero, so the
    CG trajectory equals the unpadded problem's exactly.
    """
    op_local = local_operator(cfg_local)
    nz_l = cfg_local.nz
    plane = cfg_local.nx * cfg_local.ny
    if nz_l * axis_size(mesh, axis) < nz_global:
        raise ValueError("local nz too small to cover the global domain")

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=_result_specs(P(axis)),
    )
    def solve(b, x0):
        idx = jax.lax.axis_index(axis)
        m = _z_mask(op_local, idx, nz_global, b.dtype)

        def matvec(v):
            vm = (v.reshape(nz_l, plane) * m).reshape(-1)
            y = stencil_matvec_halo(op_local, vm, axis)
            return (y.reshape(nz_l, plane) * m).reshape(-1)

        return cg_solve(
            matvec,
            b,
            x0,
            max_iter=max_iter,
            tolerance=tolerance,
            dot=lambda u, w: ddot(u, w, axis_name=axis),
        )

    return solve


def generate_problem_sharded_masked(
    cfg_local: ProblemConfig, mesh: Mesh, *, nz_global: int, axis: Axis = Z_AXIS
) -> Problem:
    """Sharded problem generation for the masked (remainder) decomposition:
    b = M A (M 1), xexact = M 1 — the true global problem's data on real
    planes, zeros on padding.

    The returned Problem describes the PADDED enclosure: vectors span
    ceil(nz/np)*np planes and ``A`` is the padded-extent StencilOperator
    (shape-consistent with the vectors), while the operator actually solved
    by :func:`make_distributed_cg_masked` is its masked restriction M A M.
    ``total_nrow``/``total_nnz_*`` carry the TRUE nz_global counts (what
    sweeps should report). ``b != A @ xexact`` on padded planes by
    construction — validate against make_distributed_cg_masked, not
    validate_problem."""
    size = axis_size(mesh, axis)
    op_local = local_operator(cfg_local)
    n_local = cfg_local.local_nrow
    nz_l = cfg_local.nz
    plane = cfg_local.nx * cfg_local.ny
    dtype = cfg_local.dtype

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    def build():
        idx = jax.lax.axis_index(axis)
        m = _z_mask(op_local, idx, nz_global, dtype)
        ones = jnp.broadcast_to(m, (nz_l, plane)).reshape(-1)
        b = stencil_matvec_halo(op_local, ones, axis)
        b = (b.reshape(nz_l, plane) * m).reshape(-1)
        return b, jnp.zeros((n_local,), dtype), ones

    b, x0, xexact = build()
    op_true = StencilOperator(
        nx=cfg_local.nx, ny=cfg_local.ny, nz=nz_global,
        stencil=cfg_local.stencil, dtype_name=jnp.dtype(dtype).name,
    )
    op_padded = StencilOperator(
        nx=cfg_local.nx, ny=cfg_local.ny, nz=nz_l * size,
        stencil=cfg_local.stencil, dtype_name=jnp.dtype(dtype).name,
    )
    return Problem(
        A=op_padded,
        b=b,
        x0=x0,
        xexact=xexact,
        total_nrow=plane * nz_global,
        total_nnz_model=cfg_local.stencil.value * plane * nz_global,
        total_nnz_exact=op_true.nnz,
    )


def dia_halo_plan(A, L: int):
    """(ok, reason): can this DiaMatrix ride the ppermute banded-halo path
    on L-row shards?

    The single source of truth for the viability predicate — the CLI's
    fallback decision and make_distributed_dia_cg's errors both call this,
    so they cannot drift (a drift would turn the CLI's graceful all-gather
    fallback into an uncaught solver ValueError)."""
    from hpccg_tpu.reorder import MAX_DIAGS

    offs = tuple(int(o) for o in A.offsets)
    # the per-shard sweep unrolls one slice per diagonal at trace time
    if len(offs) > MAX_DIAGS:
        return False, (
            f"{len(offs)} diagonals exceed the distributed DIA unroll cap "
            f"({MAX_DIAGS})"
        )
    bw_lo = max(0, -min(offs)) if offs else 0
    bw_hi = max(0, max(offs)) if offs else 0
    if bw_lo > L or bw_hi > L:
        return False, (
            f"bandwidth ({bw_lo}/{bw_hi}) exceeds the {L}-row shard: "
            "neighbor halo insufficient"
        )
    return True, ""


def _dia_shard_matvec(offs, L: int, bw_lo: int, bw_hi: int):
    """Zero-halo interior sweep of one L-row DIA shard: y = sum_d data[d] *
    v[row + off_d], with rows reaching past the shard reading zeros."""

    def matvec(data_l, v):
        x_ext = jnp.pad(v, (bw_lo, bw_hi))
        y = jnp.zeros((L,), v.dtype)
        for d, off in enumerate(offs):
            y = y + data_l[d] * jax.lax.slice_in_dim(
                x_ext, bw_lo + off, bw_lo + off + L
            )
        return y

    return matvec


def make_distributed_dia_cg(
    mesh: Mesh,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    axis: Axis = Z_AXIS,
    method: str = "cg",
    replace_every: int = 0,
):
    """Distributed CG for a banded explicit matrix (DIA): rows block-sharded,
    halo = the bandwidth-wide boundary strips, exchanged with ppermute.

    This is the file-loaded-matrix analog of the stencil halo path — the
    reference reaches it via read_HPC_row -> make_local_matrix -> MPI CG
    (main.cpp:161-179). A DIA matrix's comm plan is static: shard r needs
    rows [rL - bw_lo, rL) from its lower neighbor and [(r+1)L, (r+1)L+bw_hi)
    from its upper neighbor, where bw_lo/bw_hi are the extreme negative/
    positive diagonal offsets. Out-of-domain strips arrive as ppermute's
    zero fill — exactly the boundary clipping the matrix's zero-padded
    diagonals expect.

    Returns solve(A_global, b, x0); A's row count must divide the mesh
    (pad with ``hpccg_tpu.io.pad_problem_rows``) and its bandwidth must fit
    one shard (else fall back to the all-gather ELL path).

    HALO/COMPUTE OVERLAP: the interior sweep runs with a ZERO halo — correct
    everywhere except the first bw_lo and last bw_hi rows — so it carries no
    data dependency on the ppermutes; the exchanged strips land as two tiny
    boundary corrections afterwards (XLA's latency-hiding scheduler is then
    free to fly the exchange during the interior sweep).
    """
    import numpy as np

    from hpccg_tpu.operators import DiaMatrix

    ndev = axis_size(mesh, axis)
    run = _method_runner(method, axis, replace_every)
    # jitted solves memoized on (offsets, L, dtype): jax.jit caches per
    # FUNCTION OBJECT, so a fresh closure per call would retrace inside the
    # caller's timed region (cli.py times the post-warmup call)
    _jit_cache: dict = _BoundedCache()

    def solve(A: DiaMatrix, b, x0):
        if not isinstance(A, DiaMatrix):
            raise TypeError("make_distributed_dia_cg needs a DiaMatrix")
        n = A.local_nrow
        if n % ndev:
            raise ValueError(
                f"{n} rows do not divide a {ndev}-device mesh; pad with "
                "hpccg_tpu.io.pad_problem_rows(prob, ndev)"
            )
        L = n // ndev
        offs = tuple(int(o) for o in A.offsets)
        ok, reason = dia_halo_plan(A, L)
        if not ok:
            raise ValueError(f"{reason} — use make_distributed_ell_cg")
        bw_lo = max(0, -min(offs)) if offs else 0
        bw_hi = max(0, max(offs)) if offs else 0
        fwd = [(i, i + 1) for i in range(ndev - 1)]
        bwd = [(i + 1, i) for i in range(ndev - 1)]
        vec_sh = NamedSharding(mesh, P(axis))
        b = jax.device_put(b, vec_sh)
        x0 = jax.device_put(x0, vec_sh)
        data = jax.device_put(A.data, NamedSharding(mesh, P(None, axis)))

        jit_key = (offs, L, str(jnp.dtype(A.dtype)), method, replace_every)
        cached = _jit_cache.get(jit_key)
        if cached is not None:
            return cached(data, b, x0)

        # static gather maps for the boundary corrections: row i of the low
        # strip reads hl[i + off + bw_lo] with hl = [halo_lo | zeros] (zeros
        # where the position was already covered by the zero-halo sweep);
        # row L-bw_hi+t of the high strip reads hh[t + off + bw_lo] with
        # hh = [zeros | halo_hi]
        idx_lo = (
            jnp.asarray(np.asarray(offs)[:, None] + np.arange(bw_lo)[None, :] + bw_lo)
            if bw_lo
            else None
        )
        idx_hi = (
            jnp.asarray(np.asarray(offs)[:, None] + np.arange(bw_hi)[None, :] + bw_lo)
            if bw_hi
            else None
        )
        interior = _dia_shard_matvec(offs, L, bw_lo, bw_hi)

        @jax.jit
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(None, axis), P(axis), P(axis)),
            out_specs=_result_specs(P(axis)),
        )
        def _solve(data_l, b_l, x0_l):
            strip_lo = data_l[:, :bw_lo] if bw_lo else None
            strip_hi = data_l[:, L - bw_hi :] if bw_hi else None

            def matvec(v):
                lo = jax.lax.ppermute(v[L - bw_lo :], axis, fwd) if bw_lo else None
                hi = jax.lax.ppermute(v[:bw_hi], axis, bwd) if bw_hi else None
                y = interior(data_l, v)
                # O(ndiag * bw) corrections against the O(ndiag * L) sweep
                if bw_lo:
                    hl = jnp.concatenate([lo, jnp.zeros((bw_lo + bw_hi,), y.dtype)])
                    y = y.at[:bw_lo].add(jnp.sum(strip_lo * hl[idx_lo], axis=0))
                if bw_hi:
                    hh = jnp.concatenate([jnp.zeros((bw_lo + bw_hi,), y.dtype), hi])
                    y = y.at[L - bw_hi :].add(jnp.sum(strip_hi * hh[idx_hi], axis=0))
                return y

            return run(matvec, b_l, x0_l, max_iter=max_iter, tolerance=tolerance)

        _jit_cache[jit_key] = _solve
        return _solve(data, b, x0)

    return solve


def shard_problem(prob: Problem, mesh: Mesh, *, axis: Axis = Z_AXIS) -> Problem:
    """Place an existing (host/global) problem onto the mesh with P(axis)
    shardings — vectors row-sharded; an EllMatrix row-sharded with global
    columns."""
    vec_sh = NamedSharding(mesh, P(axis))
    A = prob.A
    if isinstance(A, EllMatrix):
        mat_sh = NamedSharding(mesh, P(axis, None))
        A = EllMatrix(
            vals=jax.device_put(A.vals, mat_sh),
            cols=jax.device_put(A.cols, mat_sh),
            valid=jax.device_put(A.valid, mat_sh),
            start_row=A.start_row,
            total_nrow=A.total_nrow,
        )
    return Problem(
        A=A,
        b=jax.device_put(prob.b, vec_sh),
        x0=jax.device_put(prob.x0, vec_sh),
        xexact=jax.device_put(prob.xexact, vec_sh),
        total_nrow=prob.total_nrow,
        total_nnz_model=prob.total_nnz_model,
        total_nnz_exact=prob.total_nnz_exact,
    )


def make_distributed_spmv_bench(mesh: Mesh, A, *, axis: Axis = Z_AXIS):
    """(make_loop, tier) for slope-timing the distributed file-mode SpMV.

    Feeds the CLI's Time Summary SPARSEMV row for file matrices at
    --mesh > 1 (the reference prints real kernel rows in file mode too,
    main.cpp:266-298). The loop times the PER-SHARD kernel exactly as the
    reference's TICK/TOCK brackets HPC_sparsemv — the halo exchange is a
    separate cost there as well (times[5], HPCCG.cpp:394) — so the DIA loop
    runs the same zero-halo sweep the solver runs; the all-gather ELL loop
    keeps its all_gather (for that path the gather IS the matvec
    structure).

    ``A``: a DiaMatrix (banded halo path) or assembled EllMatrix
    (all-gather path). make_loop(k) returns a callable of one
    P(axis)-shardable global vector running k chained rescaled matvecs;
    pass to utils.timing.time_loop_slope. Raises ValueError when the matrix
    cannot ride the distributed DIA path.
    """
    from hpccg_tpu.operators import DiaMatrix

    if isinstance(A, DiaMatrix):
        n = A.local_nrow
        ndev = axis_size(mesh, axis)
        if n % ndev:
            raise ValueError(f"{n} rows do not divide {ndev} shards")
        L = n // ndev
        ok, reason = dia_halo_plan(A, L)
        if not ok:
            raise ValueError(reason)
        offs = tuple(int(o) for o in A.offsets)
        bw_lo = max(0, -min(offs)) if offs else 0
        bw_hi = max(0, max(offs)) if offs else 0
        leaves = (jax.device_put(A.data, NamedSharding(mesh, P(None, axis))),)
        specs = (P(None, axis),)
        interior = _dia_shard_matvec(offs, L, bw_lo, bw_hi)

        def shard_matvec(mats, v):
            return interior(mats[0], v)

        tier = "dia-halo"
    elif isinstance(A, EllMatrix):
        if A.start_row != 0:
            raise ValueError("pass the assembled global EllMatrix")
        leaves = (A.vals, A.cols, A.valid)
        specs = (P(axis, None),) * 3

        def shard_matvec(mats, v):
            A_local = EllMatrix(vals=mats[0], cols=mats[1], valid=mats[2], start_row=0)
            xg = jax.lax.all_gather(v, axis, tiled=True)
            return A_local.matvec(xg)

        tier = "ell-allgather"
    else:
        raise TypeError(f"no distributed SpMV bench for {type(A).__name__}")

    def make_loop(k: int):
        @jax.jit
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=specs + (P(axis),),
            out_specs=P(axis),
        )
        def loop(*args):
            *mats, v = args

            def body(i, c):
                # the 1/54 rescale keeps the chained carry bounded for the
                # generated stencil class
                y = shard_matvec(mats, c) * jnp.asarray(1.0 / 54.0, v.dtype)
                return y.astype(c.dtype)

            return jax.lax.fori_loop(0, k, body, v)

        return lambda v: loop(*leaves, v)

    return make_loop, tier
