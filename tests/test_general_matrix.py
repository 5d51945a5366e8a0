"""General explicit matrices: the DIA/ELL chooser and RCM reordering (the
reference SpMV runs ANY matrix, HPC_sparsemv.cpp:68-87).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hpccg_tpu import ProblemConfig
from hpccg_tpu.models.stencil import generate_ell
from hpccg_tpu.operators import DiaMatrix, EllMatrix


def random_banded_dia(n, noffs, rng, span=None, dtype=np.float32, diag_scale=2.0):
    """SPD-ish DiaMatrix with ``noffs`` distinct symmetric offsets."""
    span = min(span or 4 * noffs, n - 1)
    pos = rng.choice(np.arange(1, span), size=(noffs - 1) // 2, replace=False)
    offs = np.unique(np.r_[-pos, 0, pos])
    data = np.zeros((offs.size, n), dtype)
    for d, off in enumerate(offs):
        lo, hi = max(0, -off), min(n, n - off)
        if off == 0:
            data[d, :] = diag_scale * noffs  # diagonally dominant => SPD
        else:
            data[d, lo:hi] = rng.uniform(-1.0, -0.1, hi - lo)
    # symmetrize: A[r, r+off] = A[r+off, r]
    for d, off in enumerate(offs):
        if off <= 0:
            continue
        dn = int(np.where(offs == -off)[0][0])
        rows = np.arange(0, n - off)
        data[dn, rows + off] = data[d, rows]
    return DiaMatrix(
        data=jnp.asarray(data),
        offsets=tuple(int(o) for o in offs),
        total_nrow=n,
    )


class TestReorder:
    def _permuted_band(self, n=400, seed=3, width_offsets=(-9, -4, -1, 0, 1, 4, 9)):
        """A banded matrix hidden behind a random symmetric permutation."""
        rng = np.random.default_rng(seed)
        dia = random_banded_dia(n, len(width_offsets), rng, span=10)
        dense = np.asarray(dia.to_dense())
        perm = rng.permutation(n)
        scrambled = dense[np.ix_(perm, perm)]
        width = int((scrambled != 0).sum(axis=1).max())
        vals = np.zeros((n, width), np.float32)
        cols = np.zeros((n, width), np.int32)
        valid = np.zeros((n, width), bool)
        for i in range(n):
            js = np.nonzero(scrambled[i])[0]
            vals[i, : js.size] = scrambled[i, js]
            cols[i, : js.size] = js
            valid[i, : js.size] = True
        return (
            EllMatrix(
                vals=jnp.asarray(vals), cols=jnp.asarray(cols),
                valid=jnp.asarray(valid), total_nrow=n,
            ),
            dense,
        )

    def test_permute_ell_is_similarity_transform(self):
        from hpccg_tpu.reorder import permute_ell

        ell, dense = self._permuted_band(n=120)
        rng = np.random.default_rng(1)
        perm = rng.permutation(120)
        B = permute_ell(ell, perm)
        d0 = np.asarray(ell.to_dense())
        np.testing.assert_array_equal(
            np.asarray(B.to_dense()), d0[np.ix_(perm, perm)]
        )

    def test_auto_structure_recovers_hidden_band(self):
        from hpccg_tpu.reorder import auto_structure, bandwidth

        ell, _ = self._permuted_band()
        assert bandwidth(ell) > 100  # scrambled
        A, perm, report = auto_structure(ell)
        assert report.format == "dia+rcm", report
        assert isinstance(A, DiaMatrix)
        assert perm is not None
        assert report.bandwidth_after < report.bandwidth_before / 4
        # similarity: P A P^T equals the structured operator
        d = np.asarray(ell.to_dense(), np.float64)
        np.testing.assert_allclose(
            np.asarray(A.to_dense(), np.float64),
            d[np.ix_(perm, perm)],
            rtol=1e-6,
        )

    def test_auto_structure_banded_passthrough(self):
        from hpccg_tpu.reorder import auto_structure

        prob = generate_ell(ProblemConfig(6, 5, 4, dtype=jnp.float32))
        A, perm, report = auto_structure(prob.A)
        assert report.format == "dia" and perm is None
        assert isinstance(A, DiaMatrix)

    def test_auto_structure_permuted_stencil_rides_ell_after_rcm(self):
        """A randomly permuted 3-D stencil has no small-diagonal-count
        representation even after RCM: DIA would stream more bytes than the
        ELL gather, so auto_structure keeps ELL in the RCM basis (better
        gather locality) and says so."""
        from hpccg_tpu.reorder import auto_structure

        prob = generate_ell(ProblemConfig(8, 8, 8, dtype=jnp.float32))
        rng = np.random.default_rng(5)
        dense = np.asarray(prob.A.to_dense())
        perm = rng.permutation(512)
        scrambled = dense[np.ix_(perm, perm)]
        width = int((scrambled != 0).sum(axis=1).max())
        n = 512
        vals = np.zeros((n, width), np.float32)
        cols = np.zeros((n, width), np.int32)
        valid = np.zeros((n, width), bool)
        for i in range(n):
            js = np.nonzero(scrambled[i])[0]
            vals[i, : js.size] = scrambled[i, js]
            cols[i, : js.size] = js
            valid[i, : js.size] = True
        ell = EllMatrix(
            vals=jnp.asarray(vals), cols=jnp.asarray(cols),
            valid=jnp.asarray(valid), total_nrow=n,
        )
        A, perm_out, report = auto_structure(ell)
        assert report.format == "ell+rcm", report
        assert isinstance(A, EllMatrix) and perm_out is not None
        assert report.bandwidth_after < report.bandwidth_before
        assert "ELL" in report.reason
        # P A P^T exactly
        np.testing.assert_array_equal(
            np.asarray(A.to_dense()), scrambled[np.ix_(perm_out, perm_out)]
        )

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_auto_structure_wide_scatter_stays_ell(self, dtype):
        """Genuinely wide scatter — random columns across the whole range:
        no basis gives a cheap band, so the gather path serves it, in
        either dtype, and the operator is the loaded or permuted matrix."""
        from hpccg_tpu.reorder import auto_structure, permute_ell

        rng = np.random.default_rng(9)
        n, width = 3000, 5
        cols = np.zeros((n, width), np.int32)
        vals = np.zeros((n, width), dtype)
        valid = np.ones((n, width), bool)
        for i in range(n):
            js = rng.choice(n, size=width - 1, replace=False)
            cols[i] = np.r_[i, js]
            vals[i] = np.r_[10.0, rng.uniform(-0.1, 0.1, width - 1)]
        ell = EllMatrix(vals=vals, cols=cols, valid=valid, total_nrow=n)
        A, perm_out, report = auto_structure(ell)
        assert report.format in ("ell", "ell+rcm"), report
        src = ell if perm_out is None else permute_ell(ell, perm_out)
        x = rng.standard_normal(n).astype(dtype)
        y_ref = np.asarray(src.to_dense(), np.float64) @ x.astype(np.float64)
        y = np.asarray(A.matvec(jnp.asarray(x)), np.float64)
        rtol = 1e-5 if dtype == np.float32 else 1e-12
        assert np.max(np.abs(y - y_ref)) / np.max(np.abs(y_ref)) < rtol

    @pytest.mark.parametrize(
        "ndiag,width,itemsize,want",
        [
            (27, 27, 8, True),  # stencil file: DIA 8 B/slot vs ELL 12 B/slot
            (40, 27, 8, True),  # 320 <= 27 * 12 = 324
            (41, 27, 8, False),  # 328 > 324
            (54, 27, 4, True),  # 216 <= 27 * 8 = 216
            (55, 27, 4, False),
            (129, 400, 8, False),  # past the unroll cap, whatever the bytes
        ],
    )
    def test_dia_beats_ell_rule(self, ndiag, width, itemsize, want):
        from hpccg_tpu.reorder import dia_beats_ell

        assert dia_beats_ell(ndiag, width, itemsize) == want


@pytest.mark.slow
def test_solve_in_permuted_basis_matches_direct():
    """CG is basis-invariant: solving P A P^T y = P b and unpermuting gives
    the direct solution (the mechanism read_hpc_row_structured relies on)."""
    from hpccg_tpu.reorder import auto_structure
    from hpccg_tpu.solver import make_cg

    prob = generate_ell(ProblemConfig(5, 4, 6, dtype=jnp.float64))
    rng = np.random.default_rng(11)
    # scramble the generated problem
    n = prob.total_nrow
    dense = np.asarray(prob.A.to_dense(), np.float64)
    p0 = rng.permutation(n)
    scrambled = dense[np.ix_(p0, p0)]
    b_s = np.asarray(prob.b)[p0]
    width = int((scrambled != 0).sum(axis=1).max())
    vals = np.zeros((n, width)); cols = np.zeros((n, width), np.int32)
    valid = np.zeros((n, width), bool)
    for i in range(n):
        js = np.nonzero(scrambled[i])[0]
        vals[i, : js.size] = scrambled[i, js]; cols[i, : js.size] = js
        valid[i, : js.size] = True
    ell = EllMatrix(vals=jnp.asarray(vals), cols=jnp.asarray(cols),
                    valid=jnp.asarray(valid), total_nrow=n)

    A, perm, report = auto_structure(ell)
    if perm is None:
        perm = np.arange(n)
    y = make_cg(A, max_iter=80, tolerance=0.0)(
        jnp.asarray(b_s[perm]), jnp.zeros((n,), jnp.float64)
    )
    x = np.empty(n)
    x[perm] = np.asarray(y.x)  # back to the scrambled basis
    x_direct = np.linalg.solve(scrambled, b_s)
    np.testing.assert_allclose(x, x_direct, rtol=1e-8, atol=1e-9)


def test_auto_structure_stored_zero_reason():
    """A banded matrix carrying one explicit 0.0 entry falls to ELL with a
    reason that names the stored zero (not a bogus bandwidth claim)."""
    from hpccg_tpu.reorder import auto_structure

    n = 60
    vals = np.zeros((n, 3), np.float32)
    cols = np.zeros((n, 3), np.int32)
    valid = np.zeros((n, 3), bool)
    for i in range(n):
        cols[i, 0], vals[i, 0], valid[i, 0] = i, 4.0, True
        if i + 1 < n:
            cols[i, 1], vals[i, 1], valid[i, 1] = i + 1, -1.0, True
    vals[10, 1] = 0.0  # explicit stored zero
    ell = EllMatrix(vals=jnp.asarray(vals), cols=jnp.asarray(cols),
                    valid=jnp.asarray(valid), total_nrow=n)
    A, perm, report = auto_structure(ell)
    assert report.format == "ell"
    assert "zero" in report.reason
