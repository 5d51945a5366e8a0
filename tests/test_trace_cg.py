"""tools/trace_cg.py's reduction of profiler traces: device window, busy
time, kernels and per-kernel totals read from the GPU's stream tracks only,
per-iteration figures from the difference of two solves, and its refusal
to run without a GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from trace_cg import per_iteration, reduce_trace  # noqa: E402


def _meta(pid, pname, threads):
    out = [{"ph": "M", "pid": pid, "name": "process_name", "args": {"name": pname}}]
    for tid, tname in threads.items():
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": tname}})
    return out


def _x(pid, tid, ts, dur, name):
    return {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur, "name": name}


def _events():
    ev = _meta(1, "/host:CPU", {10: "python"})
    ev += _meta(2, "/device:GPU:0", {20: "Stream #13(Compute)", 21: "Stream #14(MemcpyD2H)",
                                      22: "XLA Ops"})
    ev += [
        _x(1, 10, 0, 500, "PjitFunction(solve)"),  # host: ignored
        _x(2, 20, 100, 30, "fusion_1"),
        _x(2, 20, 140, 50, "cg_fused_direction"),
        _x(2, 21, 180, 20, "MemcpyD2H"),  # overlaps the kernel above
        _x(2, 22, 100, 100, "while"),  # derived op line: ignored
        _x(2, 20, 260, 40, "fusion_1"),
    ]
    return ev


def test_reduce_trace_totals():
    t = reduce_trace(_events())
    # window 100..300 = 200 us; busy 30 + (140..200) 60 + 40 = 130 us
    assert t["window_us"] == pytest.approx(200.0)
    assert t["busy_us"] == pytest.approx(130.0)
    assert t["kernels"] == 4  # stream events only: host and derived lines drop
    assert t["by_name"]["fusion_1"] == (2, pytest.approx(70.0))
    assert set(t["by_name"]) == {"fusion_1", "cg_fused_direction", "MemcpyD2H"}


def test_per_iteration_cancels_set_up():
    """Two solves of 2 and 6 iterations with the same 50 us set-up and a
    100 us (60 busy) iteration of two kernels: the difference reads the
    iteration alone."""
    def totals(k):
        return {"window_us": 50 + 100 * k, "busy_us": 50 + 60 * k, "kernels": 1 + 2 * k,
                "by_name": {"setup": (1, 50.0), "fusion_1": (k, 40.0 * k),
                            "cg_fused_direction": (k, 20.0 * k)}}

    rec = per_iteration(totals(2), totals(6), 2, 6)
    assert rec["device_us_per_iter"] == pytest.approx(100.0)
    assert rec["busy_us_per_iter"] == pytest.approx(60.0)
    assert rec["idle_share"] == pytest.approx(0.4)
    assert rec["kernels_per_iter"] == pytest.approx(2.0)
    assert [k["name"] for k in rec["largest"]] == ["fusion_1", "cg_fused_direction"]
    assert rec["largest"][0]["us_per_call"] == pytest.approx(40.0)
    assert rec["largest"][0]["calls_per_iter"] == pytest.approx(1.0)
    assert len(per_iteration(totals(2), totals(6), 2, 6, top=1)["largest"]) == 1


def test_reduce_trace_without_gpu_streams_names_the_tracks():
    ev = _meta(1, "/host:CPU", {10: "python"}) + [_x(1, 10, 0, 5, "op")]
    with pytest.raises(ValueError, match="/host:CPU / python"):
        reduce_trace(ev)


def test_trace_tool_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_cg.py"), "--cells", "8:float32"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
