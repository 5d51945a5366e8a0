"""Matrix operators — the framework's central data contract.

Replaces the reference's jagged-CSR ``HPC_Sparse_Matrix`` struct
(HPC_Sparse_Matrix.hpp:54-85) with three representations:

- :class:`StencilOperator` — an *implicit* operator for the generated 27/7-pt
  problems. The reference stores 27 explicit (val, col) pairs per row and does
  a random gather per nonzero (HPC_sparsemv.cpp:76-87). The same A@x is
  a dense 3-D stencil: A@x = 28*x - S(x) where S is the (boundary-clipped)
  neighbor sum *including self* — because every off-diagonal is -1.0 and every
  diagonal is 27.0 (generate_matrix.cpp:268-274). This turns a ~12 B/nnz
  bandwidth-bound gather into ~2 passes over x: the single biggest design win
  over a literal CSR port.

- :class:`EllMatrix` — a general explicit matrix in padded ELL format (dense
  (nrow, width) vals/cols with a validity mask), for file-loaded or arbitrary
  matrices. Fixed width keeps everything static-shaped for XLA.

- :class:`DiaMatrix` — diagonal storage for banded explicit matrices: a
  gather-free matvec of one shifted multiply-add per diagonal.

Vectors are flat (n,) arrays ordered row-major over (iz, iy, ix), exactly the
reference's ``currow = iz*nx*ny + iy*nx + ix`` numbering
(generate_matrix.cpp:254), so ``x.reshape(nz, ny, nx)`` is free and exact.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from hpccg_tpu.config import DIAG_VALUE, OFFDIAG_VALUE, Stencil

# ---------------------------------------------------------------------------
# Stencil offsets, in the reference's exact enumeration order
# (generate_matrix.cpp:259-261: sz outer, sy middle, sx inner, each -1..1).
# ---------------------------------------------------------------------------


def stencil_offsets(stencil: Stencil):
    """(sz, sy, sx) offset triples in reference order."""
    offs = [
        (sz, sy, sx)
        for sz in (-1, 0, 1)
        for sy in (-1, 0, 1)
        for sx in (-1, 0, 1)
    ]
    if stencil == Stencil.S7:
        # ref generate_matrix.cpp:267 — keep sz^2+sy^2+sx^2 <= 1
        offs = [o for o in offs if o[0] ** 2 + o[1] ** 2 + o[2] ** 2 <= 1]
    return offs


# ---------------------------------------------------------------------------
# Neighbor sums (the stencil-matvec building block)
# ---------------------------------------------------------------------------


def _axis_sum3(u: jax.Array, axis: int) -> jax.Array:
    """v[i] = u[i-1] + u[i] + u[i+1] along `axis`, zero beyond the ends."""
    n = u.shape[axis]
    pad = [(0, 0)] * u.ndim
    pad[axis] = (1, 1)
    p = jnp.pad(u, pad)
    s0 = jax.lax.slice_in_dim(p, 0, n, axis=axis)
    s1 = jax.lax.slice_in_dim(p, 1, n + 1, axis=axis)
    s2 = jax.lax.slice_in_dim(p, 2, n + 2, axis=axis)
    return s0 + s1 + s2


def neighbor_sum_27(u: jax.Array) -> jax.Array:
    """Sum of u over the full 3x3x3 neighborhood (incl. self), zero-clipped.

    Separable: three 1-D [1,1,1] passes instead of 27 shifted adds.
    """
    return _axis_sum3(_axis_sum3(_axis_sum3(u, 2), 1), 0)


def neighbor_sum_7(u: jax.Array) -> jax.Array:
    """Sum of u over self + 6 face neighbors, zero beyond boundaries."""
    s = u
    for axis in range(3):
        s = s + _axis_sum3(u, axis) - u  # adds the two face neighbors on `axis`
    return s


def neighbor_sum(u: jax.Array, stencil: Stencil) -> jax.Array:
    return neighbor_sum_27(u) if stencil == Stencil.S27 else neighbor_sum_7(u)


# ---------------------------------------------------------------------------
# StencilOperator
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[],
    meta_fields=["nx", "ny", "nz", "stencil", "dtype_name"],
)
@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Implicit A for the generated problem on an nx*ny*nz grid.

    All fields are static (pytree aux data): the operator carries no device
    arrays at all — the matrix never materializes. ``nz`` is the *local*
    z-extent when used as one shard of a z-stacked global domain.
    """

    nx: int
    ny: int
    nz: int
    stencil: Stencil = Stencil.S27
    dtype_name: str = "float64"

    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)

    @property
    def local_nrow(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def shape(self):
        n = self.local_nrow
        return (n, n)

    def grid(self, x: jax.Array) -> jax.Array:
        return x.reshape(self.nz, self.ny, self.nx)

    def matvec(self, x: jax.Array) -> jax.Array:
        """A @ x = (DIAG - OFFDIAG)*x + OFFDIAG * neighbor_sum(x).

        With DIAG=27, OFFDIAG=-1: 28*x - S(x). Exact for boundary rows too:
        clipped neighbors simply contribute 0 to S, matching the reference's
        validity test (generate_matrix.cpp:266).
        """
        u = self.grid(x)
        s = neighbor_sum(u, self.stencil)
        y = (DIAG_VALUE - OFFDIAG_VALUE) * u + OFFDIAG_VALUE * s
        return y.reshape(-1)

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.matvec(x)

    def nnz_per_row(self) -> jax.Array:
        """Exact per-row nonzero counts = neighbor_sum(ones)."""
        ones = jnp.ones((self.nz, self.ny, self.nx), self.dtype)
        return neighbor_sum(ones, self.stencil).reshape(-1).astype(jnp.int32)

    @property
    def nnz(self) -> int:
        """Exact local nonzero count (boundary-clipped)."""

        def clip_counts(n):
            c = [min(i + 1, 2) + min(n - i, 2) - 1 for i in range(n)]
            return c

        if self.stencil == Stencil.S27:
            cx = sum(clip_counts(self.nx))
            cy = sum(clip_counts(self.ny))
            cz = sum(clip_counts(self.nz))
            return cx * cy * cz
        # 7-pt: self + up to 2 per axis
        total = 0
        ex = sum(c - 1 for c in clip_counts(self.nx))
        ey = sum(c - 1 for c in clip_counts(self.ny))
        ez = sum(c - 1 for c in clip_counts(self.nz))
        total = self.local_nrow + ex * self.ny * self.nz + ey * self.nx * self.nz + ez * self.nx * self.ny
        return total

    @property
    def nnz_model(self) -> int:
        """The reference's approximate count: stencil_size * nrow
        (generate_matrix.cpp:223,226 uses 27*nrow regardless of boundary)."""
        return self.stencil.value * self.local_nrow


# ---------------------------------------------------------------------------
# EllMatrix — general explicit path
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["vals", "cols", "valid"],
    meta_fields=["start_row", "total_nrow"],
)
@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded-ELL sparse matrix: dense (nrow, width) vals/cols + validity mask.

    Replaces HPC_Sparse_Matrix's jagged CSR (HPC_Sparse_Matrix.hpp:63-66) with
    a fixed-width dense layout: invalid slots carry val=0, col=0 so no masking
    is needed in the matvec sum. ``cols`` are *global* column indices;
    ``start_row``/``total_nrow`` are the partition metadata
    (HPC_Sparse_Matrix.hpp:56-62).
    """

    vals: jax.Array  # (nrow, width) dtype
    cols: jax.Array  # (nrow, width) int32, global indices, 0 where invalid
    valid: jax.Array  # (nrow, width) bool
    start_row: int = 0
    total_nrow: Optional[int] = None

    @property
    def local_nrow(self) -> int:
        return self.vals.shape[0]

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        return int(self.valid.sum())

    def nnz_per_row(self) -> jax.Array:
        return self.valid.sum(axis=1).astype(jnp.int32)

    def local_cols(self) -> jax.Array:
        """Columns relative to this partition's row range."""
        return self.cols - self.start_row

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x with x indexed by *global* column ids.

        x must cover [0, total_nrow) — i.e. the single-process case or an
        all-gathered distributed vector. Invalid slots have val=0 so they
        contribute nothing regardless of the (clamped) gathered value.
        """
        gathered = jnp.take(x, self.cols, axis=0, mode="clip")
        # multiply-reduce, not einsum: a dot may run in TF32 on GPU tensor
        # cores (see ops.vector.ddot)
        return jnp.sum(self.vals * gathered, axis=1)

    def matvec_local(self, x_local: jax.Array) -> jax.Array:
        """y = A @ x for a single partition holding the full row range."""
        gathered = jnp.take(x_local, self.local_cols(), axis=0, mode="clip")
        return jnp.sum(self.vals * gathered, axis=1)

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.matvec(x)

    def to_dense(self) -> jax.Array:
        """Dense (local_nrow, total_nrow) materialization — tests/debug only."""
        n = self.total_nrow if self.total_nrow is not None else self.local_nrow
        dense = jnp.zeros((self.local_nrow, n), self.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(self.local_nrow)[:, None], self.cols.shape
        )
        return dense.at[rows, self.cols].add(self.vals)

    def to_coo(self):
        """(rows, cols, vals) numpy triplets of valid entries, row-major,
        entries within a row in storage order (matches the reference's CSR
        serialization order, generate_matrix.cpp:259-276)."""
        import numpy as np

        valid = np.asarray(self.valid)
        rows = np.broadcast_to(
            np.arange(self.local_nrow)[:, None], valid.shape
        )[valid]
        cols = np.asarray(self.cols)[valid]
        vals = np.asarray(self.vals)[valid]
        return rows + self.start_row, cols, vals

    def to_dia(self, max_diags: int = 128) -> Optional["DiaMatrix"]:
        """Convert to diagonal storage if the matrix has few distinct
        diagonals (stencil-generated matrices have <= 27). Returns None when
        more than ``max_diags`` distinct offsets exist (truly unstructured).

        Requires the full square matrix in one partition (start_row == 0 and
        local_nrow == total_nrow). Matrices carrying explicit zero entries
        also return None: DIA treats stored zeros as structural zeros, which
        would make the HPC-row write round trip lossy."""
        import numpy as np

        if self.start_row != 0:
            return None
        n = self.local_nrow
        if self.total_nrow is not None and self.total_nrow != n:
            return None  # rectangular row shard: offsets would wrap
        rows, cols, vals = self.to_coo()
        if np.any(np.asarray(vals) == 0):
            return None
        offs = cols.astype(np.int64) - rows.astype(np.int64)
        uniq = np.unique(offs)
        if uniq.size > max_diags:
            return None
        lookup = {int(o): i for i, o in enumerate(uniq)}
        data = np.zeros((uniq.size, n), dtype=np.asarray(vals).dtype)
        didx = np.vectorize(lookup.__getitem__, otypes=[np.int64])(offs)
        # duplicate (row, col) entries accumulate, matching to_dense()
        np.add.at(data, (didx, rows), vals)
        return DiaMatrix(
            data=jnp.asarray(data, self.dtype),
            offsets=tuple(int(o) for o in uniq),
            total_nrow=self.total_nrow or n,
        )


# ---------------------------------------------------------------------------
# DiaMatrix — banded explicit path (no gather)
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["offsets", "total_nrow"],
)
@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal (DIA) storage: y = sum_d data[d, :] * x[row + offsets[d]].

    The matrices in this domain are banded — a stencil matrix has <= 27
    distinct (col - row) offsets. With static offsets every diagonal's
    contribution is a shifted elementwise multiply, so the whole SpMV is one
    fused vectorized pass: ~8 B/nnz of traffic (value only) vs the reference
    CSR's >= 12 B/nnz (value + index + gather), and zero data-dependent
    addressing. reorder.auto_structure picks it over ELL only while its
    stored slots cost fewer bytes than ELL's (value, index) pairs.

    ``offsets`` are static pytree metadata — each distinct sparsity pattern
    compiles once, exactly like the reference rebuilding its comm-plan per
    matrix (make_local_matrix.cpp).
    """

    data: jax.Array  # (ndiag, nrow): data[d, r] = A[r, r + offsets[d]]
    offsets: tuple  # static ints, strictly increasing
    total_nrow: Optional[int] = None

    @property
    def local_nrow(self) -> int:
        return self.data.shape[1]

    @property
    def ndiag(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int((self.data != 0).sum())

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x: one masked roll-multiply-add per diagonal, no gather.

        Rolls + iota masks (instead of .at[].add slice updates, which
        materialize a fresh y per diagonal) let XLA fuse the whole band into
        a single pass: traffic = ndiag+2 vector reads."""
        n = self.local_nrow
        rows = jax.lax.iota(jnp.int32, n)
        y = jnp.zeros((n,), jnp.result_type(self.dtype, x.dtype))
        for d, off in enumerate(self.offsets):
            contrib = self.data[d] * jnp.roll(x, -off)
            if off > 0:
                contrib = jnp.where(rows < n - off, contrib, 0)
            elif off < 0:
                contrib = jnp.where(rows >= -off, contrib, 0)
            y = y + contrib
        return y

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.matvec(x)

    def to_coo(self):
        """(rows, cols, vals) numpy triplets of stored nonzeros, row-major
        with entries within a row ordered by column (= offset order)."""
        import numpy as np

        n = self.local_nrow
        data = np.asarray(self.data)
        rs, cs, vs = [], [], []
        for d, off in enumerate(self.offsets):
            rows = np.arange(max(0, -off), min(n, n - off))
            v = data[d, rows]
            keep = v != 0
            rs.append(rows[keep])
            cs.append(rows[keep] + off)
            vs.append(v[keep])
        rows = np.concatenate(rs)
        cols = np.concatenate(cs)
        vals = np.concatenate(vs)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order], vals[order]

    def nnz_per_row(self) -> jax.Array:
        counts = jnp.zeros((self.local_nrow,), jnp.int32)
        n = self.local_nrow
        for d, off in enumerate(self.offsets):
            lo, hi = max(0, -off), min(n, n - off)
            counts = counts.at[lo:hi].add(
                (self.data[d, lo:hi] != 0).astype(jnp.int32)
            )
        return counts

    def to_ell(self) -> "EllMatrix":
        """Padded-ELL view of the stored nonzeros (for the all-gather
        distributed path when the band is wider than a shard)."""
        import numpy as np

        rows, cols, vals = self.to_coo()
        n = self.local_nrow
        counts = np.bincount(rows, minlength=n)
        width = max(int(counts.max()) if n else 0, 1)
        ev = np.zeros((n, width), np.asarray(self.data).dtype)
        ec = np.zeros((n, width), np.int32)
        em = np.zeros((n, width), bool)
        offsets_in_row = np.arange(len(rows)) - np.concatenate(
            [[0], np.cumsum(counts)[:-1]]
        )[rows]
        ev[rows, offsets_in_row] = vals
        ec[rows, offsets_in_row] = cols
        em[rows, offsets_in_row] = True
        return EllMatrix(
            vals=jnp.asarray(ev), cols=jnp.asarray(ec), valid=jnp.asarray(em),
            start_row=0, total_nrow=self.total_nrow or n,
        )

    def to_dense(self) -> jax.Array:
        """Dense materialization — tests/debug only."""
        import numpy as np

        n = self.local_nrow
        dense = np.zeros((n, n), self.dtype)
        data = np.asarray(self.data)
        for d, off in enumerate(self.offsets):
            rows = np.arange(max(0, -off), min(n, n - off))
            dense[rows, rows + off] = data[d, rows]
        return jnp.asarray(dense)
