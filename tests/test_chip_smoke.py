"""chip_smoke.py's contract, checked on the CPU: it refuses to run without a
GPU (and prints no result), its last-line formatter, and its phase choice."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run(script: Path, cwd: Path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=240,
    )


def test_exits_nonzero_without_gpu():
    r = _run(REPO / "chip_smoke.py", REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_contract():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }


def test_chips_4_selects_only_the_sharded_phase():
    assert chip_smoke.parse_args([]).chips == 1
    assert chip_smoke.parse_args(["--chips", "4"]).chips == 4
    assert chip_smoke.phases_for(4) == ["device", "sharded"]
    one = chip_smoke.phases_for(1)
    assert one[0] == "device" and "sharded" not in one
    assert {"flagship", "resume", "families", "agreement"} <= set(one)
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--chips", "2"])
