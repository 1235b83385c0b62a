"""Test env: force JAX onto a virtual 8-device CPU mesh before jax imports.

The tests run on the CPU and exercise the multi-device sharding logic on
virtual devices; the GPU path is checked by chip_smoke.py and timed by
bench.py (tests that need the card carry the ``gpu`` marker).
"""

import os

# Force (not setdefault: the shell may carry JAX_PLATFORMS=cuda) — the
# suite must see the virtual 8-device CPU mesh; pinned through jax.config
# as well, before any backend initializes.
os.environ["JAX_PLATFORMS"] = "cpu"
# In-process CLI tests call cli.main._configure_jax, which would otherwise
# enable the persistent compile cache for the REST of the suite (global,
# order-dependent state — and jaxlib 0.9's CPU executable.serialize() has
# segfaulted writing large cache entries mid-suite). Tests never need it.
os.environ.setdefault("TRPX_JAX_CACHE", "0")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
ORACLE_DIR = Path("/tmp/trpx_oracle")
REFERENCE = Path(os.environ.get("TRPX_REFERENCE", "/root/reference"))


def _build_oracle() -> dict[str, Path] | None:
    """Compile the reference encoder/decoder shims (oracle) on demand."""
    if not (REFERENCE / "include" / "Terse.hpp").exists():
        return None
    ORACLE_DIR.mkdir(exist_ok=True)
    out = {}
    for name in ("encode_shim", "decode_shim"):
        src = REPO / "tests" / "oracle" / f"{name}.cpp"
        binp = ORACLE_DIR / name
        if not binp.exists() or binp.stat().st_mtime < src.stat().st_mtime:
            cmd = [
                "g++", "-std=c++20", "-O2", "-include", "cmath", "-include", "bit",
                f"-I{REFERENCE}/include", str(src), "-o", str(binp),
            ]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError):
                return None
        out[name] = binp
    return out


@pytest.fixture(scope="session")
def oracle():
    """Paths to compiled reference-code oracle shims, or skip."""
    shims = _build_oracle()
    if shims is None:
        pytest.skip("reference oracle unavailable (no /root/reference or no g++)")
    return shims


@pytest.fixture(scope="session")
def reference_cli():
    """Paths to the reference terse/prolix CLI binaries, building if needed."""
    build = Path("/tmp/refbuild")
    terse, prolix = build / "src" / "terse", build / "src" / "prolix"
    if not (terse.exists() and prolix.exists()):
        if not (REFERENCE / "CMakeLists.txt").exists():
            pytest.skip("reference sources unavailable")
        try:
            subprocess.run(
                ["cmake", "-S", str(REFERENCE), "-B", str(build),
                 "-DCMAKE_BUILD_TYPE=Release"],
                check=True, capture_output=True)
            subprocess.run(["cmake", "--build", str(build), "-j4"],
                           check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            pytest.skip("could not build reference CLIs")
    return {"terse": terse, "prolix": prolix}
