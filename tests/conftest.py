"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding paths
compile and execute without a GPU. Environment must be set before jax is
imported anywhere. Tests marked ``gpu`` need a card: on a GPU host run them
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
REFERENCE_DIR = Path("/root/reference")
TEST_DATA = REFERENCE_DIR / "test-dir"

sys.path.insert(0, str(REPO_ROOT))


def require_reference():
    if not TEST_DATA.exists():
        pytest.skip("reference test-dir not available")


@pytest.fixture(scope="session")
def ref_artifacts(tmp_path_factory):
    """GFA/JSON artifacts produced by the *reference* graph builder.

    Running the reference script (read-only mount) at test time gives a
    ground-truth target for byte-parity without copying its code or outputs
    into this repo.
    """
    require_reference()
    out = tmp_path_factory.mktemp("ref_artifacts")
    subprocess.run(
        [
            sys.executable,
            str(REFERENCE_DIR / "construct-graph.py"),
            "-v", str(TEST_DATA / "test.vcf"),
            "-r", str(TEST_DATA / "reference_genome.fasta"),
            "-o", str(out / "test.gfa"),
        ],
        check=True,
        cwd=out,
        capture_output=True,
    )
    return out
