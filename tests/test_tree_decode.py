"""The device decode route (the jnp split tree) vs the normative codec.

Archives come from ``format.pycodec`` (foreign, no frame index) or from
the device encoder; every decode must return the frames exactly. The
direct gather form (``decode_batch_direct``) is held to the same tables.
"""

import jax
import numpy as np
import pytest

from trpx_tpu import ops
from trpx_tpu.format import pycodec
from trpx_tpu.ops.coding import (
    FrameSpec,
    decode_batch_device,
    decode_batch_direct,
    narrow_values,
    walk_archive,
)

CASES = [
    (100, np.uint16),
    (5000, np.uint16),
    (50, np.uint8),
    (2000, np.int16),
    (64, np.int32),
    (777, np.uint32),
]


@pytest.mark.parametrize("n,dtype", CASES)
def test_decode_lossless(n, dtype):
    rng = np.random.default_rng(n)
    if np.dtype(dtype).kind == "i":
        frames = rng.integers(-300, 300, size=(3, n)).astype(dtype)
        frames[0, 0] = np.iinfo(dtype).min
    else:
        frames = rng.poisson(3.0, size=(3, n)).astype(dtype)
        frames[0, 0] = np.iinfo(dtype).max
    out = ops.decode(pycodec.encode(list(frames)), dtype)
    np.testing.assert_array_equal(out, frames)


def test_decode_zero_and_repeat_blocks():
    """All-zero frames exercise 1-bit repeat headers / zero-fill."""
    frames = np.zeros((2, 300), dtype=np.uint16)
    frames[1, 7] = 9
    out = ops.decode(pycodec.encode(list(frames)), np.uint16)
    np.testing.assert_array_equal(out, frames)


def _both_forms(arch, dtype):
    """(split tree, direct gather) decodes of ``arch`` into ``dtype``."""
    n = arch.meta.number_of_values
    spec = FrameSpec.for_dtype(n, np.dtype(dtype), arch.meta.block)
    widths, _p, words = walk_archive(arch, spec)
    return [narrow_values(np.asarray(jax.device_get(
        fn(spec, words, widths)))[:, :n], np.dtype(dtype))
        for fn in (decode_batch_device, decode_batch_direct)]


def test_decode_i8_sign_extension():
    """i8 (max_width 9): sign extension applies per value in both forms."""
    rng = np.random.default_rng(9)
    frames = rng.integers(-63, 64, size=(2, 500)).astype(np.int8)
    frames[0, :24] = 0
    for out in _both_forms(pycodec.encode(list(frames)), np.int8):
        np.testing.assert_array_equal(out, frames)


def test_decode_uint8_width_tables():
    """The streaming decoder ships uint8 width tables (1/4 the transfer);
    the tree must decode them exactly like the walk's int32 tables."""
    rng = np.random.default_rng(33)
    n = 3000
    frames = rng.poisson(3.0, size=(4, n)).astype(np.uint16)
    frames[0, 5] = 60000
    arch = pycodec.encode(list(frames))
    spec = FrameSpec.for_dtype(n, np.uint16)
    widths, _p, words = walk_archive(arch, spec)
    wide = np.asarray(decode_batch_device(spec, words, widths))
    narrow = np.asarray(decode_batch_device(spec, words,
                                            widths.astype(np.uint8)))
    np.testing.assert_array_equal(wide, narrow)
    np.testing.assert_array_equal(wide[:, :n].astype(np.uint16), frames)


TB = 64  # blocks per group in the multi-group shapes below


@pytest.mark.parametrize("n", [TB * 12 * 3 + 100, TB * 12 * 2, TB * 12 + 7])
def test_decode_multi_tile_roundtrip(n):
    rng = np.random.default_rng(n)
    frames = rng.poisson(3.0, size=(2, n)).astype(np.uint16)
    frames[0, 5] = 60000
    frames[1, n - 1] = 40000  # wide field at the very stream tail
    for out in _both_forms(pycodec.encode(list(frames)), np.uint16):
        np.testing.assert_array_equal(out, frames)


def test_decode_repeat_chain_constant_frame():
    """Constant frames: 1-bit repeat headers across every block."""
    frames = np.full((1, TB * 12 * 4), 5, dtype=np.uint16)
    for out in _both_forms(pycodec.encode(frames[0]), np.uint16):
        np.testing.assert_array_equal(out, frames)


def test_decode_signed_int32_wide_fields():
    n = TB * 12 * 3 + 50
    rng = np.random.default_rng(1)
    frames = rng.integers(-1000, 1000, size=(2, n)).astype(np.int32)
    frames[0, 0] = np.iinfo(np.int32).min  # width-33 field
    frames[1, TB * 12] = np.iinfo(np.int32).max
    for out in _both_forms(pycodec.encode(list(frames)), np.int32):
        np.testing.assert_array_equal(out, frames)


def test_decode_sparse_zero_regions():
    """Long all-zero runs (empty block streams) split cleanly."""
    n = TB * 12 * 4 + 30
    frames = np.zeros((2, n), np.uint16)
    frames[0, 3] = 900          # data only at the head
    frames[1, n - 2] = 1234     # data only in the partial tail block
    for out in _both_forms(pycodec.encode(list(frames)), np.uint16):
        np.testing.assert_array_equal(out, frames)


@pytest.mark.parametrize("dt,hot", [
    (np.uint16, 60000), (np.uint8, 250), (np.int16, -30000),
    (np.uint32, 3_000_000_000),
])
def test_measured_schedule_roundtrip(dt, hot):
    """Measured-schedule encode (the default) and split-tree decode are
    exact for every device dtype family at 256² values."""
    rng = np.random.default_rng(9)
    n = 256 * 256
    fr = rng.poisson(3.0, size=(2, n)).astype(dt)
    fr[rng.random((2, n)) < 0.001] = hot
    arch = ops.encode(fr, cap_ratio="measured")
    assert arch.to_bytes() == pycodec.encode(list(fr)).to_bytes()
    np.testing.assert_array_equal(ops.decode(arch, dt), fr)
