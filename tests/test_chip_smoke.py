"""chip_smoke.py refuses to run without a GPU or without the package."""

import json
import os
import shutil
import subprocess
import sys

from conftest import REPO_ROOT


def _run(script, cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _assert_refused(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            assert "ok" not in json.loads(line)
        except ValueError:
            pass


def test_smoke_exits_nonzero_without_gpu():
    proc = _run(REPO_ROOT / "chip_smoke.py", REPO_ROOT,
                {"JAX_PLATFORMS": "cpu"})
    _assert_refused(proc)
    assert "no GPU found" in proc.stderr


def test_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(REPO_ROOT / "chip_smoke.py", tmp_path)
    proc = _run(tmp_path / "chip_smoke.py", tmp_path,
                {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""})
    _assert_refused(proc)
