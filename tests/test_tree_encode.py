"""The device encode route (the jnp merge tree) vs the normative codec.

Partial blocks, narrow and signed dtypes, frames spanning many block
groups, repeat-header chains and overflowing optimistic capacities, driven
through ``ops.encode`` (the route the GPU runs) and compared byte for byte
with ``format.pycodec``.
"""

import numpy as np
import pytest

from trpx_tpu import ops
from trpx_tpu.format import pycodec

CASES = [
    (100, np.uint16),
    (5000, np.uint16),
    (50, np.uint8),
    (2000, np.int16),
    (64, np.int32),
    (777, np.uint32),
    (3000, np.int32),
    (4095, np.uint32),
]


@pytest.mark.parametrize("n,dtype", CASES)
def test_encode_bit_identical(n, dtype):
    rng = np.random.default_rng(n)
    if np.dtype(dtype).kind == "i":
        frames = rng.integers(-300, 300, size=(3, n)).astype(dtype)
        frames[0, 0] = np.iinfo(dtype).min  # widest field incl. sign
    else:
        frames = rng.poisson(3.0, size=(3, n)).astype(dtype)
        frames[0, 0] = np.iinfo(dtype).max
    assert ops.encode(frames).to_bytes() == \
        pycodec.encode(list(frames)).to_bytes()


def test_encode_overflow_fallback():
    """Incompressible data overflows optimistic capacities; the encode
    redoes the batch at worst-case capacities and stays exact."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 65536, size=(2, 480), dtype=np.uint16)
    arch = ops.encode(frames, cap_ratio=0.25)
    assert arch.to_bytes() == pycodec.encode(list(frames)).to_bytes()


def test_encode_hot_pixels_and_partial_block():
    rng = np.random.default_rng(1)
    frames = rng.poisson(3.0, size=(4, 1000)).astype(np.uint16)  # 1000%12!=0
    frames[rng.integers(0, 4, 10), rng.integers(0, 1000, 10)] = 65535
    assert ops.encode(frames).to_bytes() == \
        pycodec.encode(list(frames)).to_bytes()


@pytest.mark.parametrize("n,dtype", [
    (5000, np.uint16), (12 * 4096, np.uint16), (12 * 4096 + 7, np.uint16),
    (5000, np.uint8), (12 * 4096 + 5, np.uint8), (5000, np.int16),
])
def test_encode_narrow_dtypes_tail_and_hot(n, dtype):
    """u8/u16/i16 frames with hot values at the first block and in the
    partial tail block, at optimistic capacities (cap_ratio=0.5)."""
    rng = np.random.default_rng(21 + n)
    info = np.iinfo(dtype)
    fr = rng.poisson(2.0, size=(3, n)).astype(dtype)
    fr[0, 7] = info.max
    fr[-1, n - 1] = info.min if info.min < 0 else info.max // 2
    arch = ops.encode(fr, cap_ratio=0.5)
    assert arch.payload == pycodec.encode(list(fr)).payload


@pytest.mark.parametrize("n", [64 * 12 * 3 + 100, 64 * 12 * 2, 64 * 12 + 7,
                               128 * 12 * 3 + 100])
def test_encode_multi_tile_frames(n):
    """Frames spanning several 64- or 128-block groups, with a hot pixel
    and a partial tail: the repeat chain runs across every group."""
    rng = np.random.default_rng(n)
    frames = rng.poisson(3.0, size=(2, n)).astype(np.uint16)
    frames[0, 5] = 60000
    arch = ops.encode(frames, cap_ratio=0.5)
    ref = pycodec.encode(list(frames))
    assert arch.payload == ref.payload
    assert arch.meta.prolix_bits == ref.meta.prolix_bits


def test_encode_repeat_coding_constant_frame():
    """A constant frame keeps 1-bit repeat headers across all blocks."""
    frames = np.full((1, 64 * 12 * 4), 5, dtype=np.uint16)
    assert ops.encode(frames).payload == pycodec.encode(frames[0]).payload


def test_encode_signed_int32_width33():
    n = 64 * 12 * 3 + 50
    rng = np.random.default_rng(1)
    frames = rng.integers(-1000, 1000, size=(2, n)).astype(np.int32)
    frames[0, 0] = np.iinfo(np.int32).min  # width-33 field
    arch = ops.encode(frames, cap_ratio=0.5)
    assert arch.payload == pycodec.encode(list(frames)).payload
