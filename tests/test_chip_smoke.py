"""chip_smoke.py refuses to report without a GPU: it exits non-zero and
prints no result line, both in the repository on a CPU-only machine and
alone in a directory without the package."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_gpu_exits_nonzero():
    r = _run(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_alone_without_the_package_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
