"""Randomized differential soak of the codec engines.

Every trial draws a random (dtype, frame count, frame size, block,
value distribution) and asserts:

* the native C++ encoder, the spec-as-code Python encoder
  (format/pycodec.py — normative ground truth), and (optionally, when a
  jax backend is usable) the jnp merge tree produce BYTE-IDENTICAL
  archives;
* every decoder (native, pycodec, optionally device split tree) returns
  the original pixels exactly;
* inside the reference's verified-correct envelope (SURVEY.md §2.1 B5/
  B6), the archive is also byte-identical to the compiled reference
  encoder's output (oracle shim, built on demand like tests/conftest).

Usage:  python tools/differential_campaign.py [n_trials] [--device]
Prints progress every 250 trials; exits nonzero on the first mismatch
with a full repro (seed + parameters). The fixed device palette that
gates a GPU run is phase 4 of chip_smoke.py (SMOKE_TRIALS there).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from trpx_tpu.format import pycodec  # noqa: E402
from trpx_tpu import native  # noqa: E402

DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64,
          np.int8, np.int16, np.int32, np.int64]

ORACLE = Path("/tmp/trpx_oracle/encode_shim")


def _build_oracle() -> bool:
    if ORACLE.exists():
        return True
    src = Path(__file__).parent.parent / "tests" / "oracle" / "encode_shim.cpp"
    if not src.exists():
        return False
    ORACLE.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-include", "cmath",
         "-I/root/reference/include", str(src), "-o", str(ORACLE)],
        capture_output=True)
    return r.returncode == 0


def _in_reference_envelope(vals: np.ndarray, block: int) -> bool:
    """SURVEY §2.1: the envelope where the reference encoder is correct."""
    dt = vals.dtype
    # B7: the reference under-reserves for tiny frames (reserve formula
    # size*(sizeof(T)+12/(block*8)) ignores that header bits dominate
    # when n is small) — its own trailing bytes are UB there
    if vals.shape[1] < 4 * block:
        return False
    if dt == np.uint32:
        return bool(vals.max(initial=0) < 2**31)
    if dt == np.uint64:
        return bool(vals.max(initial=0) < 2**32)
    if dt.kind == "i":
        bits = 8 * dt.itemsize
        # blocks restart at every frame (pycodec.encode resets per frame,
        # matching Terse.hpp:505) — grouping across the flattened array
        # would misalign membership whenever n % block != 0 and misroute
        # trials into/out of the oracle comparison
        for frame in vals:
            nb = -(-frame.size // block)
            for b in range(nb):
                blk = frame[b * block:(b + 1) * block].astype(np.int64)
                if (blk < 0).any():
                    if np.abs(blk).max() > 2 ** (bits - 2):
                        return False
                elif dt == np.int64 and blk.max(initial=0) >= 2**31:
                    return False
        return True
    return True


#: --device mode draws (F, n, block) from this fixed palette: every unique
#: shape costs a full XLA trace+compile, so unbounded random shapes make a
#: device soak compile-bound and it never finishes. Random DATA still
#: covers the semantics; the 1M- and 3.2M-value frames exercise deep trees.
DEVICE_SHAPES = [(1, 144, 12), (3, 144, 12), (2, 1000, 12), (4, 1000, 16),
                 (2, 4096, 12), (1, 4095, 12),
                 # ~12 s of pycodec per hit, so one palette entry each
                 (1, 3_200_000, 12), (1, 1_048_576, 12)]


def _gen_values(dtype, F, n, kind, rng):
    info = np.iinfo(dtype)
    # generate in int64 then clip into an int64-SAFE window of the dtype
    # (uint64's full range overflows int64; 2^62 still exercises >32-bit
    # field widths)
    lo, hi = int(info.min), min(int(info.max), 2**62)
    if kind == 0:  # sparse poisson + hot pixels (diffraction-like)
        v = rng.poisson(2.0, (F, n)).astype(np.int64)
        v[rng.random((F, n)) < 0.01] = min(hi, 60000)
    elif kind == 1:  # full-range uniform (endpoint=True so the dtype's
        # exact max — the all-ones width-boundary pattern — is reachable)
        v = rng.integers(lo, hi, (F, n), dtype=np.int64, endpoint=True)
    elif kind == 2:  # constant / zero runs (repeat-header stress)
        v = np.zeros((F, n), np.int64)
        v[:, :: max(1, n // 7)] = int(rng.integers(0, 100))
    else:  # block-boundary ramps
        v = (np.arange(F * n).reshape(F, n) % 97).astype(np.int64)
    return np.clip(v, lo, hi).astype(dtype)


def _rand_frames(rng: np.random.Generator, fixed_shapes: bool = False):
    dtype = np.dtype(DTYPES[rng.integers(0, len(DTYPES))])
    if fixed_shapes:
        F, n, block = DEVICE_SHAPES[rng.integers(0, len(DEVICE_SHAPES))]
    else:
        F = int(rng.integers(1, 5))
        n = int(rng.integers(1, 2000))
        block = int(rng.choice([3, 7, 12, 12, 12, 16, 64]))
    kind = int(rng.integers(0, 4))
    return _gen_values(dtype, F, n, kind, rng), block


def main() -> int:
    use_device = "--device" in sys.argv
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_trials = int(pos[0]) if pos else 1000
    have_oracle = _build_oracle()
    have_native = native.available()
    if use_device:
        from trpx_tpu import ops
    rng_master = np.random.default_rng(int(os.environ.get("SEED", 2026)))
    oracle_checked = 0
    for t in range(n_trials):
        seed = int(rng_master.integers(0, 2**31))
        rng = np.random.default_rng(seed)
        vals, block = _rand_frames(rng, fixed_shapes=use_device)
        ctx = f"trial {t} seed {seed} dtype {vals.dtype} F,n={vals.shape} block {block}"
        try:
            ref = pycodec.encode(list(vals), block=block)
            blob = ref.to_bytes()
            if have_native:
                from trpx_tpu.native import codec as ncodec

                na = ncodec.encode(vals, block=block)
                assert na.to_bytes() == blob, "native encode != pycodec"
                back = ncodec.decode(ref, vals.dtype)
                assert np.array_equal(
                    np.asarray(back).reshape(vals.shape), vals), \
                    "native decode mismatch"
            back = pycodec.decode(ref, vals.dtype)
            assert np.array_equal(
                np.asarray(back).reshape(vals.shape), vals), \
                "pycodec decode mismatch"
            if use_device and vals.dtype.itemsize <= 4:
                dev = ops.encode(vals, block=block)
                assert dev.to_bytes() == blob, "device encode != pycodec"
                dback = ops.decode(ref, vals.dtype)
                assert np.array_equal(
                    np.asarray(dback).reshape(vals.shape), vals), \
                    "device decode mismatch"
            if have_oracle and _in_reference_envelope(vals, block):
                shim_dt = vals.dtype.kind + str(8 * vals.dtype.itemsize)
                r = subprocess.run(
                    [str(ORACLE), shim_dt, str(block),
                     str(vals.shape[0]), str(vals.shape[1])],
                    input=np.ascontiguousarray(vals).tobytes(),
                    capture_output=True)
                if r.returncode == 0 and r.stdout:
                    assert r.stdout == blob, "reference oracle mismatch"
                    oracle_checked += 1
        except AssertionError as e:
            print(f"MISMATCH: {e} @ {ctx}", file=sys.stderr)
            return 1
        except Exception as e:  # pragma: no cover - campaign harness
            print(f"ERROR: {type(e).__name__}: {e} @ {ctx}", file=sys.stderr)
            return 2
        if (t + 1) % 250 == 0:
            print(f"{t + 1}/{n_trials} ok ({oracle_checked} oracle-checked)",
                  flush=True)
    print(f"CAMPAIGN DONE: {n_trials} trials, 0 failures "
          f"({oracle_checked} inside the reference oracle envelope)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
