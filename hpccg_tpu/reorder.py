"""Bandwidth-reducing reordering and the explicit-matrix format chooser.

The reference's make_local_matrix (make_local_matrix.cpp:58-610) spends its
setup phase relabeling column indices into a layout its kernels like; this
module is the same one-time host-side investment. An explicit matrix whose
nonzeros lie on few distinct diagonals runs gather-free as a DiaMatrix; any
other runs the ELL gather, whose cost depends on how local its column
indices are. Many "unstructured" matrices are a hidden banded matrix
composed with a permutation — and CG is basis-invariant, so the *solve* can
run entirely in the reordered basis:

    solve (P A P^T) y = P b   ==>   x = P^T y

with the two vector permutations done once on the host (O(n), setup-time),
never inside the iteration.

``rcm_permutation`` computes the reverse Cuthill-McKee ordering (native
library, then scipy's csgraph, then a self-contained NumPy BFS), and
``auto_structure`` is the policy: DIA (one XLA roll fusion) when its stored
diagonal slots cost no more bytes than ELL's (value, index) pairs, in the
loaded basis or after RCM; otherwise ELL gather, in whichever basis has the
smaller bandwidth (better gather locality).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from hpccg_tpu.operators import EllMatrix


def _rcm_numpy(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee by plain BFS with degree-sorted tie-breaking
    (fallback when scipy is unavailable)."""
    degrees = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for seed in np.argsort(degrees, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = indices[indptr[u] : indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)
                nbrs = nbrs[np.argsort(degrees[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos : pos + nbrs.size] = nbrs
                pos += nbrs.size
    return order[::-1].copy()


def rcm_permutation(A: EllMatrix) -> np.ndarray:
    """perm such that B = A[perm][:, perm] has (near-)minimal bandwidth.

    Returns the row order: new row i is old row perm[i]."""
    if A.start_row != 0 or (A.total_nrow or A.local_nrow) != A.local_nrow:
        raise ValueError("rcm_permutation needs the assembled square matrix")
    n = A.local_nrow
    rows, cols, _ = A.to_coo()
    try:
        # native host tier first (csrc/hpccg_host.cpp — the setup-phase
        # index-relabeling role of make_local_matrix.cpp)
        from hpccg_tpu import native

        perm = native.rcm(n, rows, cols)
        if perm is not None:
            return perm
    except ImportError:
        pass
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        sym = csr_matrix(
            (np.ones(2 * len(rows)), (np.r_[rows, cols], np.r_[cols, rows])),
            shape=(n, n),
        )
        return np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True))
    except ImportError:
        sym_rows = np.r_[rows, cols]
        sym_cols = np.r_[cols, rows]
        order = np.lexsort((sym_cols, sym_rows))
        sym_rows, sym_cols = sym_rows[order], sym_cols[order]
        indptr = np.searchsorted(sym_rows, np.arange(n + 1))
        return _rcm_numpy(indptr, sym_cols, n)


def permute_ell(A: EllMatrix, perm: np.ndarray) -> EllMatrix:
    """B = P A P^T in ELL form: B[i, j] = A[perm[i], perm[j]]."""
    n = A.local_nrow
    perm = np.asarray(perm)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    vals = np.asarray(A.vals)[perm]
    cols = np.asarray(A.cols)[perm]
    valid = np.asarray(A.valid)[perm]
    new_cols = np.where(valid, inv[cols], 0).astype(np.int32)
    # host leaves on purpose: every consumer (bandwidth, to_dia,
    # auto_structure's basis stats) reads with np.asarray, and uploading here would force a full device round trip
    # of a matrix that is usually about to be re-encoded anyway
    # (io._matrix_to_device puts the surviving representation on device)
    return EllMatrix(
        vals=vals,
        cols=new_cols,
        valid=valid,
        start_row=0,
        total_nrow=A.total_nrow,
    )


def bandwidth(A: EllMatrix) -> int:
    """max |col - row| over stored nonzeros."""
    rows, cols, _ = A.to_coo()
    if len(rows) == 0:
        return 0
    return int(np.max(np.abs(cols.astype(np.int64) - rows.astype(np.int64))))


@dataclasses.dataclass(frozen=True)
class StructureReport:
    """What auto_structure decided and why (for logs/reports)."""

    format: str  # "dia" | "ell", each optionally +"+rcm"
    ndiag: Optional[int]
    bandwidth_before: int
    bandwidth_after: Optional[int]
    inflation: Optional[float]  # stored diagonal slots / true nnz
    reason: str


# The chooser compares bytes streamed per SpMV, not a fitted rate: DIA reads
# every slot of every kept diagonal (ndiag * n values), ELL reads a value and
# a 4-byte column index per padded slot (width * n) plus the gathered x. The
# rule has not been measured against the two paths on the H200.
MAX_DIAGS = 128  # the DIA matvec unrolls one roll per diagonal at trace time


def dia_beats_ell(ndiag: int, width: int, itemsize: int) -> bool:
    """True when a DiaMatrix streams no more bytes than the padded ELL.

    A byte count, not a timing: the rule is not measured on the H200."""
    return ndiag <= MAX_DIAGS and ndiag * itemsize <= width * (itemsize + 4)


def basis_stats(mat: EllMatrix):
    """(ndiag, bandwidth, has_stored_zeros) from ONE to_coo pass."""
    rows, cols, vals = mat.to_coo()
    offs = cols.astype(np.int64) - rows.astype(np.int64)
    bw = int(np.abs(offs).max()) if offs.size else 0
    return int(np.unique(offs).size), bw, bool(np.any(vals == 0))


def auto_structure(
    A: EllMatrix, *, reorder: bool = True
) -> Tuple[object, Optional[np.ndarray], StructureReport]:
    """Pick the representation an explicit matrix solves in.

    Returns (operator, perm, report). perm is None when the matrix is used
    in its original ordering; otherwise the operator represents P A P^T and
    the caller must solve in the permuted basis (permute b once, unpermute
    x once — see io.read_hpc_row_structured). ``reorder=False`` keeps the
    loaded order (no RCM).

    DIA drops stored zeros, so a matrix holding explicit zero entries stays
    in ELL (dumps and round trips would otherwise be lossy).
    """
    n = A.local_nrow
    nnz = max(A.nnz, 1)
    itemsize = np.dtype(np.asarray(A.vals).dtype).itemsize
    width = max(A.width, 1)

    def dia_ok(ndiag):
        return not zeros and dia_beats_ell(ndiag, width, itemsize)

    ndiag0, bw0, zeros = basis_stats(A)
    if dia_ok(ndiag0):
        return A.to_dia(max_diags=MAX_DIAGS), None, StructureReport(
            format="dia", ndiag=ndiag0, bandwidth_before=bw0,
            bandwidth_after=bw0, inflation=ndiag0 * n / nnz,
            reason=f"banded as loaded: {ndiag0} diagonals",
        )
    why = (
        "matrix stores explicit zero entries, which DIA would drop"
        if zeros
        else f"{ndiag0} diagonals stream more bytes than ELL"
    )
    if reorder:
        perm = rcm_permutation(A)
        B = permute_ell(A, perm)
        ndiag1, bw1, _ = basis_stats(B)
        if dia_ok(ndiag1):
            return B.to_dia(max_diags=MAX_DIAGS), perm, StructureReport(
                format="dia+rcm", ndiag=ndiag1, bandwidth_before=bw0,
                bandwidth_after=bw1, inflation=ndiag1 * n / nnz,
                reason=f"RCM reduced bandwidth {bw0} -> {bw1}; "
                f"{ndiag1} diagonals",
            )
        if bw1 < bw0:
            return B, perm, StructureReport(
                format="ell+rcm", ndiag=None, bandwidth_before=bw0,
                bandwidth_after=bw1, inflation=None,
                reason=f"{why}; ELL gather after RCM reduced bandwidth "
                f"{bw0} -> {bw1}",
            )
    return A, None, StructureReport(
        format="ell", ndiag=None, bandwidth_before=bw0, bandwidth_after=None,
        inflation=None, reason=f"{why}; ELL gather in the loaded order",
    )
