"""Test configuration: force the local CPU with a virtual 8-device mesh.

Every in-process test runs on the CPU backend in float64 (deterministic,
and it never holds an accelerator another process needs). Tests that need
the card are marked ``gpu``: they request the ``gpu_only`` fixture, which
skips them unless a JAX process started without the CPU pin finds a GPU.
On the card itself the phases run through ``python chip_smoke.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.default_backend() == "cpu"

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (long end-to-end solves; the default "
             "tier must finish in <5 min on a 1-core host)")


def pytest_collection_modifyitems(config, items):
    mexpr = config.getoption("-m") or ""
    run_slow = config.getoption("--runslow") or "slow" in mexpr
    skip_slow = pytest.mark.skip(
        reason="slow tier: pass --runslow (or -m slow)")
    for item in items:
        if not run_slow and "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def gpu_only():
    """Skip unless a GPU is visible to a fresh, unpinned JAX process (this
    process is pinned to the CPU). Decided here, at run time, so every
    xdist worker collects the same tests."""
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.default_backend())"],
        capture_output=True, text=True, env=env, timeout=300)
    if probe.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("needs a GPU (run python chip_smoke.py on the card)")


@pytest.fixture(scope="session")
def repo_root() -> Path:
    return REPO_ROOT
