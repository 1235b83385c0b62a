"""The driver entry points must work in a CLEAN environment.

``dryrun_multichip`` is a multi-device validation on virtual CPU devices:
it runs in a fresh process with no repo conftest, so it must pin the CPU
platform and the forced host device count itself — this test launches it
that way, with XLA_FLAGS/JAX_PLATFORMS scrubbed, so a dry run that saw
one device (or an accelerator) would fail here.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).parent.parent


def test_dryrun_multichip_clean_env():
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    # prepend-and-preserve (same pattern as test_multiprocess.py): jax or
    # other deps may themselves be supplied via an inherited PYTHONPATH
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    # the dry run must not depend on an accelerator being present
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=540,
    )
    assert r.returncode == 0, f"dryrun failed:\n{r.stdout}\n{r.stderr}"
    assert "OK" in r.stdout
