"""Independent format witness + BASELINE.json workload configs.

The witness decoder below re-implements the ImageJ plugin's algorithm
(TRPX_Reader.java:94-150) from its published structure: a 3-byte sliding
window bit reader, the same width state machine, zero-fill, and the
frame-advance rule ``bit_start = (1 + (bit_start >> 3)) << 3``. It shares
no code with trpx_tpu's codecs, giving a third implementation to
triangulate the format (SURVEY §2.8).
"""

import numpy as np
import pytest

from trpx_tpu import ops
from trpx_tpu.format import pycodec


def witness_decode(payload: bytes, nframes: int, nvalues: int,
                   block: int) -> np.ndarray:
    """Unsigned <=16-bit decoder in the style of TRPX_Reader.java."""
    out = np.zeros((nframes, nvalues), dtype=np.uint16)
    bit_start = 0

    def to_short(bitpos, nbits):
        # 3-byte little-endian window, LSB-first (TRPX_Reader.java:142-150)
        i = bitpos >> 3
        window = 0
        for k in range(3):
            if i + k < len(payload):
                window |= payload[i + k] << (8 * k)
        return (window >> (bitpos & 7)) & ((1 << nbits) - 1)

    for f in range(nframes):
        pos = bit_start
        width = 0
        v = 0
        b = 0
        while v < nvalues:
            if to_short(pos, 1) == 0:  # new width (TRPX_Reader.java:118-122)
                w3 = to_short(pos + 1, 3)
                pos += 4
                if w3 == 7:
                    w3 += to_short(pos, 2)
                    pos += 2
                    if w3 == 10:
                        w3 += to_short(pos, 6)
                        pos += 6
                width = w3
            else:
                pos += 1
            count = min(block, nvalues - v)
            if width == 0:
                v += count  # zero-fill (TRPX_Reader.java:124-125)
            else:
                for _ in range(count):
                    out[f, v] = to_short(pos, width)
                    pos += width
                    v += 1
            b += 1
        bit_start = (1 + (pos >> 3)) << 3  # TRPX_Reader.java:130
    return out


@pytest.mark.parametrize("F,n", [(1, 24), (3, 50), (2, 16)])
def test_witness_agrees_with_our_encoders(F, n):
    rng = np.random.default_rng(F * 100 + n)
    frames = rng.poisson(3.0, size=(F, n)).astype(np.uint16)
    frames[0, 0] = 40000
    arch = pycodec.encode(list(frames))
    wit = witness_decode(arch.payload, F, n, arch.meta.block)
    np.testing.assert_array_equal(wit, frames)
    # device archive bytes are identical, so the witness reads them too
    dev = ops.encode(frames)
    assert dev.payload == arch.payload


# ------------------------------------------- BASELINE workload configs ---


def test_config_2k_overflow_heavy():
    """2K×2K high-dynamic-range frame (BASELINE config 3): wide blocks."""
    rng = np.random.default_rng(10)
    img = rng.poisson(3.0, size=(2048, 2048)).astype(np.uint32)
    ys, xs = rng.integers(0, 2048, 5000), rng.integers(0, 2048, 5000)
    img[ys, xs] = rng.integers(2**17, 2**31 - 1, 5000).astype(np.uint32)
    flat = img.reshape(1, -1)
    arch = ops.encode(flat, dimensions=(2048, 2048))
    out = ops.decode(arch, np.uint32)
    np.testing.assert_array_equal(out.reshape(img.shape), img)
    assert arch.meta.prolix_bits == 31
    # spot-check byte-identity against the normative codec on a slice
    # (full 4M-value pycodec encode is minutes-slow; the slice pins format)
    sl = img.reshape(-1)[:600]
    a = ops.encode(sl[None].copy())
    b = pycodec.encode(sl)
    assert a.payload == b.payload


def test_config_4k_int32_signed():
    """4K×4K signed frame exercises the width-33 (sign-bit) path.

    Runs in a FRESH interpreter: this config's worst-case (ratio 1.0)
    jnp tree is the largest XLA-CPU compile in the suite, and jaxlib
    0.9's CPU compiler intermittently SIGABRTs on it late in a
    long-running process (same fragility as the serialize() note in
    conftest; reproduced 3x at suite position ~90%, never in a fresh
    process). Subprocess isolation keeps the coverage without tying the
    suite's fate to that compiler bug."""
    import os
    import subprocess
    import sys
    import textwrap

    body = textwrap.dedent("""
        import numpy as np
        import jax
        jax.config.update("jax_platforms", "cpu")
        from trpx_tpu import ops
        from trpx_tpu.format import pycodec

        rng = np.random.default_rng(11)
        img = rng.integers(-1000, 1000, size=(4096, 4096), dtype=np.int32)
        img[0, :100] = np.int32(-(2**31))  # widest possible signed field
        flat = img.reshape(1, -1)
        arch = ops.encode(flat, dimensions=(4096, 4096))
        assert arch.meta.prolix_bits == 33
        out = ops.decode(arch, np.int32)
        np.testing.assert_array_equal(out.reshape(img.shape), img)
        sl = img.reshape(-1)[:360]
        assert (ops.encode(sl[None].copy()).payload
                == pycodec.encode(sl).payload)
        print("4K-I32-OK")
    """)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", body], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0 and "4K-I32-OK" in r.stdout, (
        f"subprocess failed:\n{r.stdout}\n{r.stderr}")


def test_config_movie_stack_streamed(tmp_path):
    """Mini version of BASELINE config 4: movie stack through the
    streaming encoder + TIFF round trip."""
    from trpx_tpu.io import read_tiff, write_tiff
    from trpx_tpu.io.trpx import read_trpx
    from trpx_tpu.runtime import StreamingEncoder, iter_decode

    rng = np.random.default_rng(12)
    F, h, w = 60, 64, 64
    frames = rng.poisson(3.0, size=(F, h, w)).astype(np.uint16)
    p = tmp_path / "movie.trpx"
    enc = StreamingEncoder(p, nvalues=h * w, dtype=np.uint16,
                           dimensions=(w, h))
    for lo in range(0, F, 16):
        enc.add_frames(frames[lo : lo + 16].reshape(-1, h * w))
    enc.finalize(verify=True)
    arch = read_trpx(p)
    assert arch.meta.number_of_frames == F
    got = np.concatenate(list(iter_decode(arch, np.uint16, chunk_frames=17)))
    np.testing.assert_array_equal(got.reshape(F, h, w), frames)
    # and through the TIFF layer
    t = tmp_path / "movie.tif"
    write_tiff(frames, t)
    assert read_tiff(t).as_array().shape == (F, h, w)


def test_shipped_reader_tool():
    """tools/trpx_reader.py — the standalone stdlib-only reader artifact
    (Fiji/Jython-compatible witness) — decodes
    our archives exactly: unsigned, signed, multi-frame, partial blocks,
    zero runs."""
    import importlib.util
    import pathlib

    tool = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
        "trpx_reader.py"
    spec = importlib.util.spec_from_file_location("trpx_reader", tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    rng = np.random.default_rng(21)
    cases = [
        rng.poisson(3.0, size=(3, 515)).astype(np.uint16),
        rng.integers(-1000, 1000, size=(2, 100), dtype=np.int16),
        rng.integers(0, 2**20, size=(2, 60), dtype=np.uint32),
    ]
    for x in cases:
        x[0, :24] = 0  # zero-run blocks
        arch = pycodec.encode(list(x))
        meta, frames = mod.read(arch.to_bytes())
        assert meta["number_of_frames"] == x.shape[0]
        for i in range(x.shape[0]):
            np.testing.assert_array_equal(
                np.array(frames[i], dtype=x.dtype), x[i])
