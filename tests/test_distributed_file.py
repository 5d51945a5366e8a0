"""Distributed file-mode, end-to-end: a loaded
explicit matrix partitioned row-wise over the mesh — banded-halo DIA path
and all-gather ELL path — wired through the CLI, matching the single-device
solve (ref main.cpp:161-179: read_HPC_row -> make_local_matrix -> MPI CG).
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from hpccg_tpu import ProblemConfig
from hpccg_tpu.io import pad_problem_rows, write_hpc_row
from hpccg_tpu.models.stencil import generate_ell
from hpccg_tpu.operators import DiaMatrix
from hpccg_tpu.parallel import make_distributed_dia_cg, make_mesh
from hpccg_tpu.solver import make_cg


def _banded(n, offsets, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n), dtype)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = (
            2.0 * len(offsets) if off == 0 else rng.uniform(-1, -0.1, hi - lo)
        )
    return DiaMatrix(
        data=jnp.asarray(data), offsets=tuple(offsets), total_nrow=n
    )


@pytest.mark.slow
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_distributed_dia_matches_single(ndev):
    n = 240
    A = _banded(n, (-13, -5, -1, 0, 1, 5, 13))
    xex = jnp.ones((n,), jnp.float64)
    b = A.matvec(xex)
    x0 = jnp.zeros_like(b)
    single = make_cg(A, max_iter=40, tolerance=0.0)(b, x0)
    mesh = make_mesh(ndev)
    dist = make_distributed_dia_cg(mesh, max_iter=40, tolerance=0.0)(A, b, x0)
    assert int(dist.niters) == int(single.niters)
    ts, td = np.asarray(single.trace), np.asarray(dist.trace)
    good = np.isfinite(ts) & (ts > 1e-12 * ts[0])
    np.testing.assert_allclose(td[good], ts[good], rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(dist.x), np.asarray(single.x), rtol=1e-9, atol=1e-12
    )


@pytest.mark.slow
def test_distributed_dia_with_remainder_padding():
    """n = 250 on 8 devices: pad_problem_rows pads to 256 with identity
    rows whose residual is zero from the start — trajectory identical."""
    from hpccg_tpu.models.stencil import Problem

    n = 250
    A = _banded(n, (-3, -1, 0, 1, 3), seed=2)
    xex = jnp.ones((n,), jnp.float64)
    b = A.matvec(xex)
    prob = Problem(
        A=A, b=b, x0=jnp.zeros_like(b), xexact=xex,
        total_nrow=n, total_nnz_model=int(A.nnz), total_nnz_exact=int(A.nnz),
    )
    single = make_cg(A, max_iter=40, tolerance=0.0)(prob.b, prob.x0)

    padded = pad_problem_rows(prob, 8)
    assert padded.total_nrow == 256
    mesh = make_mesh(8)
    dist = make_distributed_dia_cg(mesh, max_iter=40, tolerance=0.0)(
        padded.A, padded.b, padded.x0
    )
    assert int(dist.niters) == int(single.niters)
    ts, td = np.asarray(single.trace), np.asarray(dist.trace)
    good = np.isfinite(ts) & (ts > 1e-12 * ts[0])
    np.testing.assert_allclose(td[good], ts[good], rtol=1e-9)
    x = np.asarray(dist.x)
    np.testing.assert_allclose(x[:n], np.asarray(single.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(x[n:], 0.0)


def test_distributed_dia_rejects_wide_band():
    n = 64
    A = _banded(n, (-40, 0, 40))
    b = A.matvec(jnp.ones((n,), jnp.float64))
    mesh = make_mesh(8)  # L = 8 < bandwidth 40
    with pytest.raises(ValueError, match="bandwidth"):
        make_distributed_dia_cg(mesh, max_iter=5)(A, b, jnp.zeros_like(b))


def test_solver_memoization_reuses_jit_but_not_data():
    """The factory memoizes jitted solves on the static layout key (jax.jit
    caches per function object); a second matrix with the SAME layout but
    different values must still solve ITS system through the cached
    function (data flows as arguments, never closure captures): with
    A2 = 2*A1 and b1 = A1 @ 1, the second solve's answer is 0.5 — a stale
    capture of A1's data would return 1.0."""
    n = 1024
    A1 = _banded(n, (-97, -40, -3, 0, 3, 40, 97), seed=7)
    A2 = DiaMatrix(data=A1.data * 2.0, offsets=A1.offsets, total_nrow=n)
    b1 = A1.matvec(jnp.ones((n,), jnp.float64))
    x0 = jnp.zeros_like(b1)
    solve = make_distributed_dia_cg(make_mesh(2), max_iter=12)
    r1 = solve(A1, b1, x0)  # populates the (offsets, L) jit cache
    np.testing.assert_allclose(np.asarray(r1.x), 1.0, atol=0.05)
    r2 = solve(A2, b1, x0)  # same key, DIFFERENT data
    np.testing.assert_allclose(np.asarray(r2.x), 0.5, atol=0.05)


class TestCliFileMesh:
    def _write(self, tmp_path, cfg):
        prob = generate_ell(cfg)
        path = str(tmp_path / "prob.dat")
        write_hpc_row(path, prob)
        return path

    def _run(self, argv):
        import contextlib
        import io as _io

        from hpccg_tpu.cli import main

        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        assert rc == 0
        return json.loads(buf.getvalue()[buf.getvalue().index("{") :])

    @pytest.mark.slow
    def test_file_mesh_dia_halo(self, tmp_path):
        """Tall domain: band (nx*ny + nx + 1 = 26) fits a 40-row shard ->
        the ppermute banded-halo DIA path."""
        path = self._write(tmp_path, ProblemConfig(5, 4, 16))
        base = ["--max-iter", "20", "--skip-kernel-bench", "--json", "--quiet"]
        r1 = self._run([path] + base)
        r8 = self._run([path, "--mesh", "8"] + base)
        assert r8["Number of iterations"] == r1["Number of iterations"]
        np.testing.assert_allclose(
            r8["Final residual"], r1["Final residual"], rtol=1e-9, atol=1e-13
        )
        assert r8["Parallelism"]["Number of mesh devices"] == 8

    @pytest.mark.slow
    def test_file_mesh_wide_band_allgather(self, tmp_path):
        """Short domain: band 26 > 20-row shard -> all-gather ELL fallback,
        still distributed and still matching the single-device solve."""
        path = self._write(tmp_path, ProblemConfig(5, 4, 8))
        base = ["--max-iter", "20", "--skip-kernel-bench", "--json", "--quiet"]
        r1 = self._run([path] + base)
        r8 = self._run([path, "--mesh", "8"] + base)
        assert r8["Number of iterations"] == r1["Number of iterations"]
        # converged to the f64 roundoff floor on both paths (the absolute
        # floor differs with psum reduction order)
        assert r8["Final residual"] < 1e-12 and r1["Final residual"] < 1e-12
        assert r8["Parallelism"]["Number of mesh devices"] == 8

    @pytest.mark.slow
    def test_file_mesh_remainder_rows(self, tmp_path):
        # 5*4*7 = 140 rows on 8 devices -> padded to 144
        path = self._write(tmp_path, ProblemConfig(5, 4, 7))
        base = ["--max-iter", "20", "--skip-kernel-bench", "--json", "--quiet"]
        r1 = self._run([path] + base)
        r8 = self._run([path, "--mesh", "8"] + base)
        assert r8["Number of iterations"] == r1["Number of iterations"]
        assert r8["Final residual"] < 1e-12 and r1["Final residual"] < 1e-12

    @pytest.mark.slow
    def test_file_mesh_kernel_rows_finite(self, tmp_path):
        """Distributed file mode reports REAL (finite) DDOT/WAXPBY/SPARSEMV
        Time Summary rows: the reference prints full
        kernel breakdowns in file mode too (main.cpp:266-298). The SPARSEMV
        row benches the tier that solved (here the dia-halo per-shard
        kernel), named in the Time Summary note."""
        path = self._write(tmp_path, ProblemConfig(5, 4, 16))
        r8 = self._run(
            [path, "--mesh", "8", "--max-iter", "10", "--json", "--quiet"]
        )
        ts = r8["Time Summary"]
        for row in ("DDOT    ", "WAXPBY  ", "SPARSEMV"):
            assert np.isfinite(ts[row]), (row, ts)
        note = [k for k in ts if "SPARSEMV row benches" in k]
        assert note and "dia-" in note[0]
        mf = r8["MFLOPS Summary"]
        assert np.isfinite(mf["SPARSEMV"]) and mf["SPARSEMV"] > 0
        # the distributed-overheads block now also renders in file mode
        assert "DDOT Timing Variations" in r8
        assert "SPARSEMV OVERHEADS" in r8


@pytest.mark.slow
def test_file_mesh_scattered_band_goes_allgather(tmp_path):
    """An f64 scattered-narrow-band file under --mesh: too many diagonals
    for DIA, so the solve runs the all-gather ELL path."""
    import contextlib
    import io as _io

    rng = np.random.default_rng(3)
    n, width = 400, 5
    cols = np.zeros((n, width), np.int32)
    vals = np.zeros((n, width), np.float64)
    entries = {}
    for i in range(n):
        for j in i + rng.choice(np.arange(1, 40), size=2, replace=False):
            if j < n:
                entries[(i, int(j))] = entries[(int(j), i)] = float(
                    rng.uniform(-1, -0.1)
                )
    for i in range(n):
        entries[(i, i)] = 12.0
    rows_of = {}
    for (i, j), v in entries.items():
        rows_of.setdefault(i, []).append((j, v))
    width = max(len(v) for v in rows_of.values())
    vals = np.zeros((n, width)); cols = np.zeros((n, width), np.int32)
    valid = np.zeros((n, width), bool)
    for i, lst in rows_of.items():
        for s, (j, v) in enumerate(sorted(lst)):
            cols[i, s], vals[i, s], valid[i, s] = j, v, True
    from hpccg_tpu.operators import EllMatrix as _Ell
    from hpccg_tpu.models.stencil import Problem as _P

    ell = _Ell(vals=jnp.asarray(vals), cols=jnp.asarray(cols),
               valid=jnp.asarray(valid), total_nrow=n)
    b = ell.matvec(jnp.ones((n,)))
    prob = _P(A=ell, b=b, x0=jnp.zeros_like(b), xexact=jnp.ones_like(b),
              total_nrow=n, total_nnz_model=int(ell.nnz),
              total_nnz_exact=int(ell.nnz))
    path = str(tmp_path / "scat.dat")
    write_hpc_row(path, prob)

    from hpccg_tpu.cli import main

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([path, "--mesh", "8", "--max-iter", "20",
                   "--skip-kernel-bench", "--json", "--quiet"])
    assert rc == 0
    out = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
    assert out["Parallelism"]["Number of mesh devices"] == 8
    assert out["Final residual"] < 1e-10


@pytest.mark.slow
def test_file_mesh_dump_matlab_no_crash(tmp_path):
    """--dump-matlab in distributed file mode dumps the loaded matrix
    (regression: the per-shard stencil dump branch used an unbound cfg)."""
    import contextlib
    import io as _io

    from hpccg_tpu.cli import main

    prob = generate_ell(ProblemConfig(5, 4, 16))
    path = str(tmp_path / "p.dat")
    write_hpc_row(path, prob)
    prefix = str(tmp_path / "mat")
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([path, "--mesh", "4", "--max-iter", "5",
                   "--skip-kernel-bench", "--quiet", "--json",
                   "--dump-matlab", prefix])
    assert rc == 0
    import os
    assert os.path.exists(prefix + "0.dat")


@pytest.mark.slow
def test_distributed_dia_rejects_many_diagonals():
    n = 600
    offs = tuple(range(-150, 151))  # 301 diagonals
    rng = np.random.default_rng(1)
    data = np.zeros((len(offs), n))
    for d, off in enumerate(offs):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = 400.0 if off == 0 else rng.uniform(-1, -0.1, hi - lo)
    A = DiaMatrix(data=jnp.asarray(data), offsets=offs, total_nrow=n)
    b = A.matvec(jnp.ones((n,)))
    mesh = make_mesh(2)
    with pytest.raises(ValueError, match="unroll cap"):
        make_distributed_dia_cg(mesh, max_iter=5)(A, b, jnp.zeros_like(b))


@pytest.mark.slow
def test_file_mesh_many_diagonals(tmp_path, capsys):
    """A 301-diagonal banded file under --mesh: past the DIA unroll cap, so
    both dtypes run the all-gather ELL path — distributed and converging."""
    import contextlib
    import io as _io

    from hpccg_tpu.cli import main
    from hpccg_tpu.models.stencil import Problem as _P

    n = 600
    offs = tuple(range(-150, 151))
    rng = np.random.default_rng(2)
    data = np.zeros((len(offs), n))
    for d, off in enumerate(offs):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = 400.0 if off == 0 else rng.uniform(-1, -0.1, hi - lo)
    A = DiaMatrix(data=jnp.asarray(data), offsets=offs, total_nrow=n)
    b = A.matvec(jnp.ones((n,)))
    prob = _P(A=A, b=b, x0=jnp.zeros_like(b), xexact=jnp.ones_like(b),
              total_nrow=n, total_nnz_model=int(A.nnz), total_nnz_exact=int(A.nnz))
    path = str(tmp_path / "wide.dat")
    write_hpc_row(path, prob)

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([path, "--dtype", "float32", "--mesh", "4", "--max-iter",
                   "15", "--skip-kernel-bench", "--quiet", "--json"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "matrix structure: ell" in err
    out = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
    assert out["Parallelism"]["Number of mesh devices"] == 4
    assert out["Final residual"] < 1e-4 * 400.0
    assert "ell-allgather" in json.dumps(out)

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([path, "--no-reorder", "--mesh", "4", "--max-iter", "15",
                   "--skip-kernel-bench", "--quiet", "--json"])
    assert rc == 0
    capsys.readouterr()
    out = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
    assert out["Parallelism"]["Number of mesh devices"] == 4
    assert "ell-allgather" in json.dumps(out)  # Time Summary names the path


def test_file_mesh_degenerate_diagonal_matrix(tmp_path):
    """An identity-like file (offsets == (0,)) under --mesh must not crash
    the dia-halo viability check (regression: empty/min-max guards)."""
    import contextlib
    import io as _io

    from hpccg_tpu.cli import main
    from hpccg_tpu.models.stencil import Problem as _P

    n = 64
    A = _banded(n, (0,), seed=0)
    b = A.matvec(jnp.ones((n,)))
    prob = _P(A=A, b=b, x0=jnp.zeros_like(b), xexact=jnp.ones_like(b),
              total_nrow=n, total_nnz_model=int(A.nnz), total_nnz_exact=int(A.nnz))
    path = str(tmp_path / "diag.dat")
    write_hpc_row(path, prob)
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([path, "--mesh", "4", "--max-iter", "5",
                   "--skip-kernel-bench", "--quiet", "--json"])
    assert rc == 0
    out = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
    assert out["Parallelism"]["Number of mesh devices"] == 4


@pytest.mark.slow
def test_file_mesh_wide_scatter_rides_allgather(tmp_path):
    """An f32 wide-scatter file under --mesh: no band in any basis, so the
    solve runs the all-gather ELL path, with finite kernel rows naming it,
    and matches the single-device solve."""
    import contextlib
    import io as _io

    from hpccg_tpu.models.stencil import Problem
    from hpccg_tpu.operators import EllMatrix

    rng = np.random.default_rng(7)
    n, width = 6000, 5
    cols = np.stack(
        [np.arange(n)] + [rng.integers(0, n, n) for _ in range(width - 1)],
        axis=1,
    ).astype(np.int32)
    vals = np.concatenate(
        [np.full((n, 1), 8.0), rng.uniform(-1, -0.1, (n, width - 1))], axis=1
    ).astype(np.float32)
    A = EllMatrix(
        vals=jnp.asarray(vals), cols=jnp.asarray(cols),
        valid=jnp.ones((n, width), bool), start_row=0, total_nrow=n,
    )
    b = A.matvec(jnp.ones((n,), jnp.float32))
    prob = Problem(
        A=A, b=b, x0=jnp.zeros_like(b), xexact=jnp.ones_like(b),
        total_nrow=n, total_nnz_model=n * width, total_nnz_exact=n * width,
    )
    path = str(tmp_path / "wide.dat")
    write_hpc_row(path, prob)

    from hpccg_tpu.cli import main

    def run(argv):
        buf = _io.StringIO()
        err = _io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = main(argv)
        assert rc == 0, err.getvalue()
        out = buf.getvalue()
        return json.loads(out[out.index("{"):]), err.getvalue()

    base = [path, "--dtype", "float32", "--max-iter", "12", "--json", "--quiet"]
    r1, _ = run(base + ["--skip-kernel-bench"])
    r8, err8 = run(base + ["--mesh", "8"])
    assert "matrix structure: ell" in err8, err8
    note = [k for k in r8["Time Summary"] if "backend=" in k]
    assert note and "distributed:ell-allgather" in note[0], note
    ts = r8["Time Summary"]
    for row in ("DDOT    ", "WAXPBY  ", "SPARSEMV"):
        assert np.isfinite(ts[row]), (row, ts)
    # same solve as single-device (f32 reduction-order tolerance)
    np.testing.assert_allclose(
        r8["Final residual"], r1["Final residual"], rtol=5e-3, atol=1e-6
    )
