"""Native C++ host library tests (builds csrc/hpccg_host.cpp on demand)."""

import numpy as np
import pytest

from hpccg_tpu import ProblemConfig, native
from hpccg_tpu.models.stencil import generate_ell

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no g++?)"
)


def test_native_tokenize(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("3 7\n1.5 -2 1e-3\n  42\t0.0\n")
    toks = native.tokenize_file(str(p))
    np.testing.assert_allclose(toks, [3, 7, 1.5, -2, 1e-3, 42, 0.0])


@pytest.mark.parametrize("seven_pt", [False, True])
@pytest.mark.parametrize("rank,size", [(0, 1), (1, 3)])
def test_native_generate_matches_jax(seven_pt, rank, size):
    cfg = ProblemConfig(4, 3, 5, stencil=7 if seven_pt else 27)
    prob = generate_ell(cfg, rank=rank, size=size)
    out = native.generate_ell_host(4, 3, 5, rank=rank, size=size, seven_pt=seven_pt)
    vals, cols, valid, b, nnz = out
    np.testing.assert_array_equal(vals, np.asarray(prob.A.vals))
    np.testing.assert_array_equal(cols, np.asarray(prob.A.cols))
    np.testing.assert_array_equal(valid, np.asarray(prob.A.valid))
    np.testing.assert_allclose(b, np.asarray(prob.b))
    assert nnz == int(np.asarray(prob.A.valid).sum())


def test_native_writer_roundtrips(tmp_path):
    from hpccg_tpu.io import read_hpc_row, write_hpc_row

    cfg = ProblemConfig(3, 4, 5)
    prob = generate_ell(cfg)
    path = str(tmp_path / "native.dat")
    write_hpc_row(path, prob)  # uses the native writer when available
    loaded, _ = read_hpc_row(path)  # uses the native tokenizer when available
    # the reader compacts valid slots left; compare canonical COO triplets
    for got, want in zip(loaded.A.to_coo(), prob.A.to_coo()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.asarray(loaded.b), np.asarray(prob.b))


def test_native_rcm_matches_quality():
    """Native RCM produces a valid permutation that recovers a hidden band
    about as well as scipy's (exact orders may differ — any proper RCM
    qualifies; the chooser only needs the bandwidth reduction)."""
    import numpy as np
    import jax.numpy as jnp

    from hpccg_tpu import native
    from hpccg_tpu.operators import DiaMatrix, EllMatrix
    from hpccg_tpu.reorder import bandwidth, permute_ell

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")

    n = 300
    rng = np.random.default_rng(0)
    data = np.zeros((5, n))
    for d, off in enumerate((-7, -2, 0, 2, 7)):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = 10.0 if off == 0 else -1.0
    dia = DiaMatrix(data=jnp.asarray(data), offsets=(-7, -2, 0, 2, 7), total_nrow=n)
    dense = np.asarray(dia.to_dense())
    scramble = rng.permutation(n)
    sc = dense[np.ix_(scramble, scramble)]
    width = int((sc != 0).sum(axis=1).max())
    vals = np.zeros((n, width), np.float32)
    cols = np.zeros((n, width), np.int32)
    valid = np.zeros((n, width), bool)
    for i in range(n):
        js = np.nonzero(sc[i])[0]
        vals[i, : js.size] = sc[i, js]
        cols[i, : js.size] = js
        valid[i, : js.size] = True
    ell = EllMatrix(vals=jnp.asarray(vals), cols=jnp.asarray(cols),
                    valid=jnp.asarray(valid), total_nrow=n)
    rows_c, cols_c, _ = ell.to_coo()
    perm = native.rcm(n, rows_c, cols_c)
    assert sorted(perm) == list(range(n))  # a permutation
    B = permute_ell(ell, perm)
    assert bandwidth(B) <= 4 * 7  # recovered a narrow band (orig bw 7)


def test_native_build_is_portable(monkeypatch, tmp_path):
    """The host library is built without -march=native: a checkout (and a
    .so built in it) may move to a machine with another CPU."""
    import subprocess

    calls = []
    monkeypatch.setattr(native, "_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(
        subprocess, "run", lambda cmd, **kw: calls.append(cmd)
    )
    native._compile("src.cpp")
    assert calls and calls[0][0] == "g++"
    assert not any("march" in part for part in calls[0])
    assert str(tmp_path / "lib.so") in calls[0]
