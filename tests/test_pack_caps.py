"""Optimistic soft-capacity merge tree: overflow detection + fallback."""

import jax
import numpy as np
import pytest

from trpx_tpu import ops
from trpx_tpu.format import pycodec
from trpx_tpu.ops.coding import FrameSpec, encode_batch_device
from trpx_tpu.ops.pack import capacity_schedule, row_capacity


def test_capacity_schedule_shapes():
    caps = capacity_schedule(32768, 8, 204, 0.5)
    assert len(caps) == 16
    assert caps[0] == 8
    # small nodes keep generous slack (clustered hot pixels must fit);
    # large nodes converge to the ratio
    assert caps[3] <= 8 * 8
    assert caps[8] < 8 * 256 * 0.7
    assert caps[-1] < 8 * 32768 * 0.6
    full = capacity_schedule(32768, 8, 204, 1.0)
    assert full[-1] == 8 * 32768


def test_incompressible_overflows_and_fallback_matches():
    """Random full-range uint16 data does not compress: the ratio-0.25
    kernel must flag overflow, and ops.encode must still produce the
    bit-identical archive via the full-capacity fallback."""
    rng = np.random.default_rng(0)
    n = 480
    frames = rng.integers(0, 65536, size=(3, n), dtype=np.uint16)
    spec = FrameSpec.for_dtype(n, np.uint16, cap_ratio=0.25)
    padded = np.zeros((3, spec.n_padded), dtype=np.uint16)
    padded[:, :n] = frames
    _, _, _, over = jax.device_get(encode_batch_device(spec, padded))
    assert bool(np.any(over)), "expected overflow on incompressible data"

    arch = ops.encode(frames, cap_ratio=0.25)  # exercises the fallback
    ref = pycodec.encode(list(frames))
    assert arch.to_bytes() == ref.to_bytes()


def test_compressible_stays_fast_path():
    rng = np.random.default_rng(1)
    n = 480
    frames = rng.poisson(3.0, size=(3, n)).astype(np.uint16)
    spec = FrameSpec.for_dtype(n, np.uint16, cap_ratio=0.5)
    padded = np.zeros((3, spec.n_padded), dtype=np.uint16)
    padded[:, :n] = frames
    words, bits, maxw, over = jax.device_get(
        encode_batch_device(spec, padded)
    )
    assert not bool(np.any(over))
    arch = ops.encode(frames)
    assert arch.to_bytes() == pycodec.encode(list(frames)).to_bytes()


@pytest.mark.parametrize("ratio", [0.25, 0.5, 1.0])
def test_ratio_invariance_when_no_overflow(ratio):
    rng = np.random.default_rng(2)
    frames = rng.poisson(1.0, size=(2, 100)).astype(np.uint16)
    arch = ops.encode(frames, cap_ratio=ratio)
    assert arch.to_bytes() == pycodec.encode(list(frames)).to_bytes()


def test_out_words_smaller_with_ratio():
    spec_full = FrameSpec.for_dtype(512 * 512, np.uint16)
    spec_half = FrameSpec.for_dtype(512 * 512, np.uint16, cap_ratio=0.5)
    assert spec_half.out_words < spec_full.out_words
    assert row_capacity(spec_full.max_block_bits) == 8


# ---- measured per-level capacity schedules --------------------------------

def test_quant_words_grid():
    from trpx_tpu.ops.pack import _quant_words

    assert _quant_words(1) == 8 and _quant_words(8) == 8
    for w in (9, 14, 27, 100, 195, 4097):
        q = _quant_words(w)
        assert q >= w
        assert q < 1.26 * w or q == 10  # <=25% overshoot (min step at 8->10)
    # monotone
    prev = 0
    for w in range(1, 3000, 7):
        q = _quant_words(w)
        assert q >= prev
        prev = q


def test_measured_schedule_proven_bounds():
    from trpx_tpu.ops.pack import measured_schedule

    P, cap0, mbb = 1024, 8, 204
    rng = np.random.default_rng(2)
    bits = rng.integers(1, 200, size=(4, P)).astype(np.int64)
    # per-level maxima like the prepass computes them
    maxima, node, cb = [], bits, 1
    while cb < P:
        cb *= 2
        node = node.reshape(4, P // cb, 2).sum(axis=2)
        maxima.append(int(node.max()))
    sched = measured_schedule(P, cap0, mbb, maxima)
    assert len(sched) == 11 and sched[0] == cap0
    cb = 1
    for lev, mb in enumerate(maxima, start=1):
        cb *= 2
        worst = min(cap0 * cb, -(-(cb * mbb + 31) // 32))
        assert mb <= sched[lev] * 32 - 31      # the kernels' funnel margin
        assert sched[lev] <= worst
        assert sched[lev] >= sched[lev - 1] or sched[lev] == worst


def test_measured_encode_bit_identical():
    """cap_ratio='measured' (the default) builds a proven per-level
    schedule from the batch and must stay bit-identical to the
    spec-as-code golden encoder — including on worst-case data, where
    the schedule clamps to full capacities."""
    rng = np.random.default_rng(5)
    n = 512 * 24
    # F must exceed the F<=8 small-batch carve-out in encode() or the
    # measured prepass never runs (verified: F=8 silently rewrites to
    # the optimistic bucket)
    from trpx_tpu.ops import coding as C

    calls = []
    orig = C.measured_spec
    C.measured_spec = lambda s, p: calls.append(1) or orig(s, p)
    try:
        fr = rng.poisson(3.0, size=(9, n)).astype(np.uint16)
        fr[rng.random((9, n)) < 0.002] = 60000
        arch = ops.encode(fr, cap_ratio="measured")
        assert calls, "measured prepass did not run (F<=8 carve-out?)"
        assert arch.to_bytes() == pycodec.encode(list(fr)).to_bytes()

        bad = np.full((9, n), 65535, np.uint16)
        arch2 = ops.encode(bad, cap_ratio="measured")
        assert arch2.to_bytes() == pycodec.encode(list(bad)).to_bytes()
    finally:
        C.measured_spec = orig


def test_measured_schedule_clustered_hot_pixels():
    """Bragg-like CLUSTERED hot pixels concentrate worst-case blocks in
    one subtree — the fixed ratio buckets' weak spot; measured schedules
    absorb them by construction (caps from the actual maxima)."""
    rng = np.random.default_rng(10)
    n = 512 * 48
    fr = rng.poisson(3.0, size=(10, n)).astype(np.uint16)
    for f in range(10):
        c = rng.integers(0, n - 400)
        fr[f, c : c + 400] = 65535        # a dense saturated peak
    arch = ops.encode(fr, cap_ratio="measured")
    assert arch.to_bytes() == pycodec.encode(list(fr)).to_bytes()
