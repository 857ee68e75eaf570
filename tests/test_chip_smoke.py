"""chip_smoke.py refuses to report a result without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )
    return out.returncode, out.stdout.strip().splitlines()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """On the CPU, and from a directory holding nothing of the repo but
    the script, it exits non-zero with ``"ok": false`` as its last line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    rc, lines = run_smoke(cwd, str(script))
    assert rc != 0
    last = json.loads(lines[-1])
    assert last["ok"] is False
