"""chip_smoke.py and bench.py measure the GPU or nothing.

Each must refuse, with a non-zero exit and no result line, where jax finds
no GPU; chip_smoke.py must also fail when copied away from the repository.
The ``gpu``-marked test runs the whole smoke on a card.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd=REPO, **env):
    e = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    e.update(env)
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=e,
                          capture_output=True, text=True, timeout=300)


def _no_result(r) -> None:
    assert r.returncode != 0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    assert '"ok"' not in last


def test_chip_smoke_refuses_cpu_backend():
    r = _run(["chip_smoke.py"], JAX_PLATFORMS="cpu")
    _no_result(r)
    assert r.returncode == 2 and "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
             JAX_PLATFORMS="cpu", PYTHONPATH="")
    _no_result(r)


def test_bench_refuses_cpu_backend():
    r = _run(["bench.py", "--cells", "512"], JAX_PLATFORMS="cpu")
    _no_result(r)
    assert r.returncode == 2 and "needs a GPU" in r.stderr


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole one-card smoke, in its own process (this one is pinned
    to the CPU by conftest)."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    e = {k: v for k, v in os.environ.items()
         if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "TRPX_JAX_CACHE")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(REPO),
                       env=e, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
