"""chip_smoke.py: its CPU-testable helpers, its refusal to run without a
GPU, and (marked ``gpu``, skipped here) the run on the card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def test_require_gpu_refuses_cpu(smoke):
    with pytest.raises(smoke.SmokeFailure, match="needs a GPU"):
        smoke.require_gpu("cpu", 8)
    with pytest.raises(smoke.SmokeFailure):
        smoke.require_gpu("gpu", 0)
    smoke.require_gpu("gpu", 1)


def test_result_line_is_the_contract(smoke):
    line = smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_parse_nvidia_smi(smoke):
    rows = smoke.parse_nvidia_smi(
        "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n")
    assert rows == [("NVIDIA H100 80GB HBM3", "700.00 W"),
                    ("NVIDIA H100 80GB HBM3", "500.00 W")]
    for bad in ("", "no comma here"):
        with pytest.raises(smoke.SmokeFailure):
            smoke.parse_nvidia_smi(bad)


def test_script_fails_without_gpu(tmp_path):
    """On the CPU backend the script exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
        text=True, cwd=tmp_path, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_only, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=1500)
    assert out.returncode == 0, out.stdout + out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
