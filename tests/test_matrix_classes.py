"""Explicit-matrix classes through the chooser's XLA routes, against the
NumPy oracle (tests/oracle.py).

Each class is a symmetric, diagonally dominant matrix of a kind HPCCG's
file mode can load: the generated stencil (banded), a band hidden behind a
permutation, a scattered narrow band, a randomly permuted stencil, and a
banded matrix that stores an explicit zero. Each runs through
reorder.auto_structure and then the path the CLI takes for that choice —
make_cg on one device; the DIA-halo or all-gather ELL factories on 2 and 4
virtual devices — in f32 and f64, with the cg, cg1 and pipecg recurrences.
The residual trajectory must match the oracle's CG (basis-invariant, so a
reordered solve is compared as is).
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from oracle import oracle_cg

from hpccg_tpu import ProblemConfig
from hpccg_tpu.models.stencil import Problem, generate_ell
from hpccg_tpu.operators import DiaMatrix, EllMatrix

MAX_ITER = 16


def _ell_from_dense(dense):
    n = dense.shape[0]
    width = int((dense != 0).sum(axis=1).max())
    vals = np.zeros((n, width))
    cols = np.zeros((n, width), np.int32)
    valid = np.zeros((n, width), bool)
    for i in range(n):
        js = np.nonzero(dense[i])[0]
        vals[i, : js.size] = dense[i, js]
        cols[i, : js.size] = js
        valid[i, : js.size] = True
    return vals, cols, valid


def _stencil_dense():
    return np.asarray(generate_ell(ProblemConfig(4, 4, 6)).A.to_dense(), np.float64)


def _random_band_dense(n, offsets, rng):
    dense = np.zeros((n, n))
    for off in offsets:
        if off <= 0:
            continue
        v = rng.uniform(-1.0, -0.1, n - off)
        idx = np.arange(n - off)
        dense[idx, idx + off] = v
        dense[idx + off, idx] = v
    dense[np.arange(n), np.arange(n)] = 0.05 + np.abs(dense).sum(axis=1)
    return dense


@functools.lru_cache(maxsize=None)
def matrix_class(name):
    """(dense A, stored-zero position or None) for one class, f64. The
    random classes are diagonally dominant by a small margin, so CG needs
    all MAX_ITER iterations."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "banded":
        return _stencil_dense(), None
    if name == "permuted_banded":
        dense = _random_band_dense(96, (1, 3, 7), rng)
        p = rng.permutation(96)
        return dense[np.ix_(p, p)], None
    if name == "scattered_narrow":
        n = 96
        dense = np.zeros((n, n))
        for i in range(n):
            for j in i + rng.choice(np.arange(1, 40), size=2, replace=False):
                if j < n:
                    dense[i, j] = dense[j, i] = rng.uniform(-1.0, -0.1)
        dense[np.arange(n), np.arange(n)] = 0.05 + np.abs(dense).sum(axis=1)
        return dense, None
    if name == "permuted_stencil":
        dense = _stencil_dense()
        p = rng.permutation(dense.shape[0])
        return dense[np.ix_(p, p)], None
    if name == "stored_zeros":
        return _random_band_dense(96, (1, 2, 5), rng), (10, 11)
    raise KeyError(name)


def load(name, dtype):
    """The class as a host-leaf EllMatrix (the way io.read_hpc_row hands
    it to the chooser), its dense stored form, and b = A @ x for a random x
    (ones would be an eigenvector of the zero-row-sum random classes)."""
    dense, zero_at = matrix_class(name)
    vals, cols, valid = _ell_from_dense(dense)
    if zero_at is not None:
        # an explicit stored zero (still "valid"), on both sides of the
        # diagonal so the stored matrix stays symmetric
        for i, j in (zero_at, zero_at[::-1]):
            slot = int(np.nonzero(cols[i] == j)[0][0])
            vals[i, slot] = 0.0
    n = dense.shape[0]
    A = EllMatrix(vals=vals.astype(dtype), cols=cols, valid=valid, total_nrow=n)
    dense_stored = np.zeros((n, n))
    np.add.at(dense_stored, (np.repeat(np.arange(n), valid.sum(1)), cols[valid]), vals[valid])
    b = dense_stored @ np.random.default_rng(n).uniform(0.5, 1.5, n)
    return A, dense_stored, b


def solve(A_op, b, ndev, method, dtype):
    """The CLI's route for the chosen operator on ``ndev`` devices."""
    from hpccg_tpu.io import pad_problem_rows
    from hpccg_tpu.parallel import make_mesh
    from hpccg_tpu.parallel.cg import (
        dia_halo_plan,
        make_distributed_dia_cg,
        make_distributed_ell_cg,
        shard_problem,
    )
    from hpccg_tpu.solver import make_cg

    n = b.shape[0]
    bj = jnp.asarray(b, dtype)
    if ndev == 1:
        return make_cg(A_op, max_iter=MAX_ITER, method=method)(bj, jnp.zeros_like(bj))
    if isinstance(A_op, EllMatrix):
        A_op = EllMatrix(
            vals=jnp.asarray(A_op.vals), cols=jnp.asarray(A_op.cols),
            valid=jnp.asarray(A_op.valid), total_nrow=n,
        )
    prob = Problem(A=A_op, b=bj, x0=jnp.zeros_like(bj), xexact=jnp.ones_like(bj),
                   total_nrow=n, total_nnz_model=0, total_nnz_exact=0)
    prob = pad_problem_rows(prob, ndev)
    mesh = make_mesh(ndev)
    A = prob.A
    if isinstance(A, DiaMatrix) and dia_halo_plan(A, prob.total_nrow // ndev)[0]:
        return make_distributed_dia_cg(mesh, max_iter=MAX_ITER, method=method)(
            A, prob.b, prob.x0
        )
    if isinstance(A, DiaMatrix):
        prob = Problem(A=A.to_ell(), b=prob.b, x0=prob.x0, xexact=prob.xexact,
                       total_nrow=prob.total_nrow, total_nnz_model=0,
                       total_nnz_exact=0)
    prob = shard_problem(prob, mesh)
    return make_distributed_ell_cg(mesh, max_iter=MAX_ITER, method=method)(
        prob.A, prob.b, prob.x0
    )


# (rtol, floor): compare oracle trace entries above floor * trace[0]. f64
# agrees to rounding until the residual nears the f64 floor; the
# one-reduction recurrences drift a little more (pipecg most, cf.
# test_method_file_matrices); f32 keeps ~7 digits per operation and loses
# some per iteration.
TOL = {
    ("float64", "cg"): (1e-9, 1e-9),
    ("float64", "cg1"): (1e-7, 1e-9),
    ("float64", "pipecg"): (1e-5, 1e-8),
    ("float32", "cg"): (2e-3, 1e-3),
    ("float32", "cg1"): (2e-3, 1e-3),
    ("float32", "pipecg"): (5e-3, 1e-3),
}

CLASSES = ["banded", "permuted_banded", "scattered_narrow", "permuted_stencil", "stored_zeros"]
EXPECTED_FORMAT = {
    "banded": ("dia",),
    "permuted_banded": ("dia+rcm", "ell+rcm"),
    "scattered_narrow": ("ell", "ell+rcm"),
    "permuted_stencil": ("ell+rcm",),
    "stored_zeros": ("ell",),
}


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cls", CLASSES)
def test_class_matches_oracle(cls, dtype, method, ndev):
    from hpccg_tpu.reorder import auto_structure

    A, dense, b = load(cls, np.dtype(dtype))
    A_op, perm, report = auto_structure(A)
    assert report.format in EXPECTED_FORMAT[cls], report
    b_solve = b if perm is None else b[np.asarray(perm)]
    res = solve(A_op, b_solve, ndev, method, dtype)

    _, niters, _, otrace = oracle_cg(dense, b, np.zeros_like(b), MAX_ITER)
    trace = np.asarray(res.trace, np.float64)
    assert int(res.niters) == niters == MAX_ITER - 1
    rtol, floor = TOL[(dtype, method)]
    good = otrace > floor * otrace[0]
    assert good.sum() >= 4
    np.testing.assert_allclose(trace[good], otrace[good], rtol=rtol)
    assert np.isfinite(np.asarray(res.x, np.float64)).all()
