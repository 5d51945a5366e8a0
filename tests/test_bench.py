"""bench.py is the benchmark's contract (ONE JSON line, on the card only):
its peak table knows the H200 and refuses any other device."""

import io
import json
import sys
from contextlib import redirect_stdout

import pytest

import bench


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


def test_peak_table_knows_the_h200():
    # NVIDIA H200 data sheet: 4.8 TB/s HBM3e
    assert bench.hbm_bandwidth_gbps(_Dev("NVIDIA H200")) == 4800.0


@pytest.mark.parametrize(
    "kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100 80GB HBM3", "NVIDIA H200 NVL", ""]
)
def test_peak_table_raises_on_unknown_device(kind):
    with pytest.raises(KeyError, match="no peak bandwidth"):
        bench.hbm_bandwidth_gbps(_Dev(kind))


def test_bench_refuses_the_cpu(monkeypatch):
    """A measurement path that finds no card fails before any work."""
    monkeypatch.setattr(sys, "argv", ["bench.py", "--nx", "8", "--ny", "8", "--nz", "8"])
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(KeyError):
        bench.main()
    assert buf.getvalue() == ""


@pytest.mark.gpu
def test_bench_emits_one_json_line(gpu, monkeypatch):
    monkeypatch.setattr(
        sys, "argv",
        ["bench.py", "--nx", "32", "--ny", "32", "--nz", "32", "--dtype",
         "float64", "--max-iter", "20", "--reps", "3"],
    )
    buf = io.StringIO()
    with redirect_stdout(buf):
        bench.main()
    lines = [l for l in buf.getvalue().strip().splitlines() if l.strip()]
    assert len(lines) == 1
    d = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in d
    assert d["unit"] == "Gnnz/s"
    assert d["extras"]["niters"] == 19
    assert d["extras"]["platform"] == "gpu"
