"""chip_smoke.py's contract off the card: it refuses to run without a GPU
(no CPU fallback, no result line), fails when the repo is not beside it, and
sizes the deployment grid by the reference's 25%-of-memory rule."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _run(args, cwd, tmp_path, **extra_env):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"), **extra_env)
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _no_result(stdout):
    lines = [line for line in stdout.splitlines() if line.strip()]
    if not lines:
        return True
    try:
        return not json.loads(lines[-1]).get("ok")
    except ValueError:
        return True


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_chip_smoke_refuses_cpu(args, tmp_path):
    proc = _run([SMOKE] + args, ROOT, tmp_path)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)
    assert "no GPU" in proc.stderr


@pytest.mark.parametrize("package_on_path", [False, True])
def test_chip_smoke_alone_fails(package_on_path, tmp_path):
    """Copied away from its checkout it fails — also when the package is
    importable from elsewhere (it checks its own checkout, nothing else)."""
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(SMOKE, lone / "chip_smoke.py")
    extra = {"PYTHONPATH": ROOT} if package_on_path else {}
    proc = _run(["chip_smoke.py"], str(lone), tmp_path, **extra)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)


@pytest.mark.parametrize("total_gib", [141, 80, 1])
def test_deployment_grid_fills_a_quarter(total_gib):
    sys.path.insert(0, ROOT)
    from chip_smoke import deployment_grid

    total = total_gib * 2**30
    n = deployment_grid(total)
    assert n % 8 == 0
    assert 6 * 8 * n**3 >= 0.25 * total  # 6 f64 CG vectors
    assert 6 * 8 * (n - 8) ** 3 < 0.25 * total  # the smallest such cube


def test_printed_trace_parses_cli_lines():
    sys.path.insert(0, ROOT)
    from chip_smoke import printed_trace

    out = "Initial Residual = 258.24\nIteration = 15   Residual = 2.15402e-06\n{}"
    assert printed_trace(out) == {0: 258.24, 15: 2.15402e-06}
