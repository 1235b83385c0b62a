"""Adversarial capacity-boundary cases for the merge and split trees.

The trees' word shifts and bit funnels (ops/pack.py, ops/unpack.py) are
sized by static bounds: a level's left-child length la never exceeds its
row capacity, and a funnel shift of s == 0 must carry nothing. These
tests drive those bounds: maximally dense streams at cap_ratio=1.0 where
la presses against the level capacity at every merge level, asymmetric
dense/empty halves, word-aligned lengths, and the matching decode splits
through the split tree and the direct gather form.
"""

import jax
import numpy as np
import pytest

from trpx_tpu import ops
from trpx_tpu.format import pycodec

BLOCK = 12


@pytest.fixture(autouse=True, scope="module")
def _fresh_compile_state():
    """The dense worst-case (cap_ratio=1.0) trees are among the largest
    XLA:CPU compiles in the suite; clearing JAX's caches once at module
    start keeps the compiler's memory within what it handles reliably
    (jaxlib 0.9 has segfaulted compiling on top of a long suite's
    accumulated executables)."""
    jax.clear_caches()


def _alternating_dense(n: int, dtype, w_hi: int, w_lo: int) -> np.ndarray:
    """One frame whose blocks alternate widths w_hi/w_lo: every block
    emits a full (non-repeat) header and a max-magnitude payload — the
    densest stream the format can produce, so per-block bit lengths sit
    at the capacity bound on every merge level."""
    dtype = np.dtype(dtype)
    vals = np.empty(n, dtype=dtype)
    nb = -(-n // BLOCK)
    for b in range(nb):
        w = w_hi if b % 2 == 0 else w_lo
        if dtype.kind == "i":
            v = -(1 << (w - 1))  # width includes the sign bit
        else:
            v = (1 << w) - 1
        vals[b * BLOCK:(b + 1) * BLOCK] = v
    return vals


DENSE_CASES = [
    # (n, dtype, w_hi, w_lo)
    (12 * 1024, np.uint16, 16, 15),       # pow2 blocks, deep tree
    (12 * 1000 + 5, np.uint16, 16, 15),   # partial last block
    (12 * 700, np.uint32, 32, 31),        # widest unsigned fields
    (12 * 1024, np.int16, 16, 15),        # sign-extension at max width
    (12 * 300, np.uint8, 8, 7),
]


@pytest.mark.parametrize("n,dtype,w_hi,w_lo", DENSE_CASES)
def test_dense_alternating_encode_worst_case_caps(n, dtype, w_hi, w_lo):
    """cap_ratio=1.0 keeps the theoretical worst-case capacities, so la
    reaches the static shift bound at every level."""
    frames = np.stack([_alternating_dense(n, dtype, w_hi, w_lo),
                       _alternating_dense(n, dtype, w_lo, w_hi)])
    arch = ops.encode(frames, cap_ratio=1.0)
    assert arch.to_bytes() == pycodec.encode(list(frames)).to_bytes()


@pytest.mark.parametrize("n,dtype,w_hi,w_lo", DENSE_CASES)
def test_dense_alternating_decode_roundtrip(n, dtype, w_hi, w_lo):
    """Decode splits of the densest archives: the public path (split
    tree, node capacities clamped at the bucketed stream size) and the
    direct gather form, whose offsets reach the end of the stream."""
    from trpx_tpu.ops.coding import (
        FrameSpec,
        decode_batch_direct,
        narrow_values,
        walk_archive,
    )

    frames = np.stack([_alternating_dense(n, dtype, w_hi, w_lo),
                       _alternating_dense(n, dtype, w_lo, w_hi)])
    arch = pycodec.encode(list(frames))
    out = ops.decode(arch, dtype)
    np.testing.assert_array_equal(out, frames)

    spec = FrameSpec.for_dtype(n, np.dtype(dtype))
    widths, _p, words = walk_archive(arch, spec)
    raw = jax.device_get(decode_batch_direct(spec, words, widths))
    got = narrow_values(np.asarray(raw)[:, :n], np.dtype(dtype))
    np.testing.assert_array_equal(got, frames)


def test_dense_constant_repeat_headers():
    """All-max constant frames: width-16 payloads behind 1-bit repeat
    headers — dense rows with the minimal-header layout."""
    frames = np.full((3, 12 * 512), 0xFFFF, dtype=np.uint16)
    arch = ops.encode(frames, cap_ratio=1.0)
    assert arch.to_bytes() == pycodec.encode(list(frames)).to_bytes()
    out = ops.decode(arch, np.uint16)
    np.testing.assert_array_equal(out, frames)


@pytest.mark.parametrize("dense_left", [True, False])
def test_dense_half_asymmetric_merge(dense_left):
    """One half of the frame maximally dense, the other all zero: at
    some merge level every node pairs a full row (la at the bound) with
    an empty one, the asymmetry the funnel edge handles."""
    n = 12 * 1024
    dense = _alternating_dense(n // 2, np.uint16, 16, 15)
    zero = np.zeros(n // 2, dtype=np.uint16)
    frame = (np.concatenate([dense, zero]) if dense_left
             else np.concatenate([zero, dense]))
    frames = frame[None]
    arch = ops.encode(frames, cap_ratio=1.0)
    assert arch.to_bytes() == pycodec.encode(list(frames)).to_bytes()
    out = ops.decode(arch, np.uint16)
    np.testing.assert_array_equal(out, frames)


def test_word_aligned_lane_lengths():
    """Frames engineered so per-block bit counts are multiples of 32:
    the funnel shift s == 0 path (whose carry term must be zero) fires
    on real data words, not just padding."""
    # width-8 blocks: 12 header + 12*8 payload = 108 bits; 8 blocks sum
    # to 864 bits = 27 words exactly when headers alternate 8/7.
    n = 12 * 512
    frame = _alternating_dense(n, np.uint16, 8, 7)
    frames = np.stack([frame, frame[::-1].copy()])
    arch = ops.encode(frames, cap_ratio=1.0)
    assert arch.to_bytes() == pycodec.encode(list(frames)).to_bytes()
    out = ops.decode(arch, np.uint16)
    np.testing.assert_array_equal(out, frames)
