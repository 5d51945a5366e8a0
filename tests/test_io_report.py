"""IO (HPC-row round-trip, matlab dump, checkpoint) and report tests."""

import numpy as np
import pytest

from hpccg_tpu import ProblemConfig, generate_problem
from hpccg_tpu.io import (
    dump_matlab,
    load_problem,
    read_hpc_row,
    save_problem,
    write_hpc_row,
)
from hpccg_tpu.models.stencil import generate_ell
from hpccg_tpu.ops.vector import compute_residual
from hpccg_tpu.solver import make_cg
from hpccg_tpu.utils.report import Report


def test_hpc_row_roundtrip(tmp_path):
    cfg = ProblemConfig(4, 3, 5)
    prob = generate_ell(cfg)
    path = str(tmp_path / "mat.dat")
    write_hpc_row(path, prob)
    loaded, x0 = read_hpc_row(path)
    r0, c0, v0 = prob.A.to_coo()
    r1, c1, v1 = loaded.A.to_coo()
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_allclose(np.asarray(loaded.b), np.asarray(prob.b))
    np.testing.assert_allclose(np.asarray(loaded.xexact), np.asarray(prob.xexact))


@pytest.mark.slow
def test_hpc_row_solve_end_to_end(tmp_path):
    """File-loaded matrix solves like the generated problem (mode 2 of the
    reference CLI, main.cpp:141-154)."""
    cfg = ProblemConfig(5, 5, 5)
    path = str(tmp_path / "mat.dat")
    write_hpc_row(path, generate_ell(cfg))
    prob, x0 = read_hpc_row(path)
    res = make_cg(prob.A, max_iter=40)(prob.b, x0)
    assert float(compute_residual(res.x, prob.xexact)) < 1e-11


def test_hpc_row_truncated_file_errors(tmp_path):
    path = tmp_path / "bad.dat"
    path.write_text("100 2700\n1 2 3\n")
    with pytest.raises(ValueError):
        read_hpc_row(str(path))


def test_dump_matlab(tmp_path):
    cfg = ProblemConfig(3, 3, 3)
    prob = generate_ell(cfg)
    path = dump_matlab(str(tmp_path / "mat"), prob.A, rank=0)
    lines = open(path).read().strip().splitlines()
    assert len(lines) == prob.total_nnz_exact
    r, c, v = lines[0].split()
    assert int(r) == 1 and int(c) == 1  # 1-indexed (dump_matlab_matrix.cpp:70)
    assert dump_matlab(str(tmp_path / "mat"), prob.A, rank=4) is None


def test_checkpoint_roundtrip_stencil(tmp_path):
    cfg = ProblemConfig(4, 4, 4)
    prob = generate_problem(cfg)
    p = str(tmp_path / "ckpt.npz")
    save_problem(p, prob, state={"k": np.int32(7)})
    loaded, state = load_problem(p)
    assert loaded.A.nx == 4 and loaded.A.stencil == prob.A.stencil
    np.testing.assert_allclose(np.asarray(loaded.b), np.asarray(prob.b))
    assert state["k"] == 7


def test_checkpoint_roundtrip_ell(tmp_path):
    cfg = ProblemConfig(3, 4, 2)
    prob = generate_ell(cfg)
    p = str(tmp_path / "ckpt.npz")
    save_problem(p, prob)
    loaded, _ = load_problem(p)
    np.testing.assert_array_equal(np.asarray(loaded.A.cols), np.asarray(prob.A.cols))


def test_report_schema_and_formatting():
    doc = Report("hpccg-tpu", "1.0")
    doc.add("Dimensions")
    doc.get("Dimensions").add("nx", 10)
    doc.add("Final residual", 1.68304e-92)
    ts = doc.add("Time Summary")
    ts.add("Total   ", 0.123456789)
    y = doc.generate_yaml()
    assert "Mini-Application Name: hpccg-tpu" in y
    assert "Dimensions: " in y
    assert "  nx: 10" in y  # 2-space indent (YAML_Element.cpp:86-93)
    assert "Final residual: 1.68304e-92" in y  # 6 sig figs like C++ ostream
    assert "  Total   : 0.123457" in y
    obj_json = doc.to_json()
    assert '"nx": 10' in obj_json


def test_report_get_creates_on_miss():
    doc = Report()
    doc.get("Missing").add("child", 1)
    assert "Missing" in doc.generate_yaml()


@pytest.mark.slow
def test_dia_conversion_and_matvec():
    """DIA (the gather-free banded format) matches ELL exactly."""
    import jax.numpy as jnp
    import numpy as np

    from hpccg_tpu import ProblemConfig
    from hpccg_tpu.models.stencil import generate_ell
    from hpccg_tpu.operators import DiaMatrix

    prob = generate_ell(ProblemConfig(5, 4, 3))
    dia = prob.A.to_dia()
    assert isinstance(dia, DiaMatrix)
    assert dia.ndiag <= 27
    assert dia.nnz == prob.A.nnz
    np.testing.assert_allclose(
        np.asarray(dia.to_dense()), np.asarray(prob.A.to_dense()), rtol=0
    )
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(prob.total_nrow))
    np.testing.assert_allclose(
        np.asarray(dia.matvec(x)), np.asarray(prob.A.matvec(x)), rtol=1e-13
    )
    # coo round trip agrees with the ELL triplets
    r1, c1, v1 = dia.to_coo()
    r0, c0, v0 = prob.A.to_coo()
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_allclose(v1, v0)
    np.testing.assert_array_equal(
        np.asarray(dia.nnz_per_row()), np.asarray(prob.A.nnz_per_row())
    )


@pytest.mark.slow
def test_read_hpc_row_converts_to_dia(tmp_path):
    import numpy as np

    from hpccg_tpu import ProblemConfig
    from hpccg_tpu.io import read_hpc_row, write_hpc_row
    from hpccg_tpu.models.stencil import generate_ell
    from hpccg_tpu.operators import DiaMatrix, EllMatrix
    from hpccg_tpu.ops.vector import compute_residual
    from hpccg_tpu.solver import make_cg

    path = str(tmp_path / "m.dat")
    write_hpc_row(path, generate_ell(ProblemConfig(4, 4, 4)))
    prob, _ = read_hpc_row(path)
    assert isinstance(prob.A, DiaMatrix)
    res = make_cg(prob.A, max_iter=40)(prob.b, prob.x0)
    assert float(compute_residual(res.x, prob.xexact)) < 1e-10
    # opt-out keeps ELL
    prob_ell, _ = read_hpc_row(path, to_dia=False)
    assert isinstance(prob_ell.A, EllMatrix)
    # and a DIA problem round-trips back through the writer
    path2 = str(tmp_path / "m2.dat")
    write_hpc_row(path2, prob)
    prob2, _ = read_hpc_row(path2)
    np.testing.assert_allclose(
        np.asarray(prob2.A.to_dense()), np.asarray(prob.A.to_dense())
    )


def test_save_load_dia_problem(tmp_path):
    import numpy as np

    from hpccg_tpu import ProblemConfig
    from hpccg_tpu.io import load_problem, save_problem, write_hpc_row, read_hpc_row
    from hpccg_tpu.models.stencil import generate_ell
    from hpccg_tpu.operators import DiaMatrix

    path = str(tmp_path / "m.dat")
    write_hpc_row(path, generate_ell(ProblemConfig(3, 3, 3)))
    prob, _ = read_hpc_row(path)
    npz = str(tmp_path / "ck.npz")
    save_problem(npz, prob, state={"x": np.zeros(prob.total_nrow)})
    prob2, state = load_problem(npz)
    assert isinstance(prob2.A, DiaMatrix)
    assert prob2.A.offsets == prob.A.offsets
    assert "x" in state
    np.testing.assert_allclose(
        np.asarray(prob2.A.data), np.asarray(prob.A.data)
    )


@pytest.mark.slow
def test_random_banded_spd_matrix_cg():
    """General-path end-to-end on a NON-stencil matrix: random banded SPD,
    solved through both ELL and DIA against numpy.linalg.solve."""
    import jax.numpy as jnp
    import numpy as np

    from hpccg_tpu.operators import EllMatrix
    from hpccg_tpu.solver import make_cg

    rng = np.random.default_rng(7)
    n, offs = 96, [-9, -3, -1, 0, 1, 3, 9]
    dense = np.zeros((n, n))
    for off in offs:
        if off < 0:
            continue
        vals = rng.standard_normal(n - off) * 0.3
        idx = np.arange(n - off)
        dense[idx, idx + off] = vals
        dense[idx + off, idx] = vals  # symmetric
    dense[np.arange(n), np.arange(n)] = np.abs(dense).sum(axis=1) + 1.0  # SPD

    # pack to ELL
    width = max((np.abs(dense[i]) > 0).sum() for i in range(n))
    vals = np.zeros((n, width))
    cols = np.zeros((n, width), dtype=np.int32)
    valid = np.zeros((n, width), dtype=bool)
    for i in range(n):
        nz = np.nonzero(dense[i])[0]
        vals[i, : len(nz)] = dense[i, nz]
        cols[i, : len(nz)] = nz
        valid[i, : len(nz)] = True
    A = EllMatrix(
        vals=jnp.asarray(vals), cols=jnp.asarray(cols), valid=jnp.asarray(valid),
        start_row=0, total_nrow=n,
    )
    b = rng.standard_normal(n)
    x_ref = np.linalg.solve(dense, b)

    for op in (A, A.to_dia()):
        assert op is not None
        np.testing.assert_allclose(
            np.asarray(op.to_dense()), dense, atol=1e-14
        )
        res = make_cg(op, max_iter=200, tolerance=1e-12)(
            jnp.asarray(b), jnp.zeros(n)
        )
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-8, atol=1e-9)


def test_report_write_to_disk(tmp_path, monkeypatch):
    """Report.write emits the timestamped file like YAML_Doc::generateYAML
    (YAML_Doc.cpp:40-71), in both formats."""
    import json
    import os

    from hpccg_tpu.utils.report import Report

    monkeypatch.chdir(tmp_path)
    doc = Report("hpccg-tpu", "1.0")
    doc.add("Number of iterations", 42)
    sec = doc.add("Dimensions")
    sec.add("nx", 8)

    ypath = doc.write()
    assert os.path.exists(ypath) and ypath.endswith(".yaml")
    text = open(ypath).read()
    assert "Number of iterations: 42" in text and "nx: 8" in text

    jpath = doc.write(fmt="json")
    obj = json.loads(open(jpath).read())
    assert obj["Number of iterations"] == 42
    assert obj["Dimensions"]["nx"] == 8
