"""Native C++ host runtime vs the normative pure-Python codec.

The native codec must be bit-identical to pycodec (and hence to the
reference encoder) everywhere, including the 64-bit envelope the reference
itself gets wrong (SURVEY B5/B6) where pycodec defines the correct stream.
"""

import numpy as np
import pytest

from trpx_tpu.format import pycodec
from trpx_tpu import native
from trpx_tpu.native import codec as ncodec

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain for the native runtime"
)

DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64,
          np.int8, np.int16, np.int32, np.int64]


def _rand_frames(dtype, F, n, rng, span=None):
    dtype = np.dtype(dtype)
    info = np.iinfo(dtype)
    lo, hi = info.min, info.max
    if span is not None:
        lo, hi = span
    return rng.integers(lo, hi, size=(F, n), dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [12, 50, 100])
def test_encode_matches_pycodec(dtype, n):
    rng = np.random.default_rng(hash((str(dtype), n)) % 2**32)
    frames = _rand_frames(dtype, 3, n, rng)
    a = ncodec.encode(frames)
    b = pycodec.encode(list(frames))
    assert a.meta == b.meta
    assert a.payload == b.payload


@pytest.mark.parametrize("dtype", DTYPES)
def test_roundtrip(dtype):
    rng = np.random.default_rng(1)
    frames = _rand_frames(dtype, 5, 77, rng)
    arch = ncodec.encode(frames)
    out = ncodec.decode(arch, dtype)
    np.testing.assert_array_equal(out, frames)


def test_int64_extremes():
    """int64 min needs a 65-bit field; the reference corrupts here (B6),
    pycodec defines the correct stream, native must match it."""
    vals = np.array([[np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]],
                    dtype=np.int64)
    a = ncodec.encode(vals)
    b = pycodec.encode(list(vals))
    assert a.payload == b.payload
    assert a.meta.prolix_bits == 65
    np.testing.assert_array_equal(ncodec.decode(a, np.int64), vals)
    np.testing.assert_array_equal(pycodec.decode(b, np.int64), vals)


def test_uint64_full_width():
    vals = np.array([[np.iinfo(np.uint64).max, 0, 1, 2**63]],
                    dtype=np.uint64)
    a = ncodec.encode(vals)
    b = pycodec.encode(list(vals))
    assert a.payload == b.payload
    assert a.meta.prolix_bits == 64
    np.testing.assert_array_equal(ncodec.decode(a, np.uint64), vals)


def test_sparse_diffraction_like():
    rng = np.random.default_rng(2)
    frames = rng.poisson(3.0, size=(7, 512)).astype(np.uint16)
    frames[rng.integers(0, 7, 30), rng.integers(0, 512, 30)] = 65535
    a = ncodec.encode(frames, dimensions=(512, 1))
    b = pycodec.encode(list(frames), dimensions=(512, 1))
    assert a.to_bytes() == b.to_bytes()
    np.testing.assert_array_equal(ncodec.decode(a, np.uint16), frames)


def test_walk_matches_pycodec():
    rng = np.random.default_rng(3)
    frames = rng.poisson(2.0, size=(4, 100)).astype(np.uint16)
    arch = pycodec.encode(list(frames))
    widths, poffs, fstarts = native.walk(
        arch.payload, 4, 100, arch.meta.block
    )
    pos = 0
    for f in range(4):
        w, o, nxt = pycodec.walk_frame(arch.payload, pos, 100, arch.meta.block)
        np.testing.assert_array_equal(widths[f], w)
        np.testing.assert_array_equal(poffs[f], o)
        assert fstarts[f] == pos
        pos = nxt
    assert fstarts[4] == pos == arch.meta.memory_size


@pytest.mark.parametrize("dtype,hot", [(np.uint32, 2_000_000_000),
                                       (np.uint16, 60000),
                                       (np.int32, -1_000_000_000),
                                       (np.uint64, 2**31)])
def test_wide_walk_matches_branchy(dtype, hot):
    """The branchless wide-stream walk (selected via max_width > 16) must
    produce identical tables to the branchy loop on every stream —
    overflow-heavy, zero runs, partial tail blocks."""
    rng = np.random.default_rng(9)
    n = 1000  # 1000 % 12 != 0: partial tail block
    frames = rng.poisson(3.0, size=(5, n)).astype(dtype)
    frames[:, 100:300] = 0                      # zero runs
    frames[rng.random((5, n)) < 0.02] = hot     # scattered wide blocks
    arch = pycodec.encode(list(frames))
    F, blk = 5, arch.meta.block
    # max(…, 17) forces the wide loop even for narrow streams (the u16
    # case): _check_width only rejects widths ABOVE the bound, so a
    # raised bound stays valid while exercising the branchless walker
    mw = max(arch.meta.prolix_bits, 17)
    w0, p0, f0 = native.walk(arch.payload, F, n, blk)  # branchy (no hint)
    w1, p1, f1 = native.walk(arch.payload, F, n, blk, max_width=mw)
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(f0, f1)
    # indexed variant too
    w2, p2 = native.walk_indexed(arch.payload, f0[:-1], n, blk,
                                 max_width=mw)
    np.testing.assert_array_equal(w0, w2)
    np.testing.assert_array_equal(p0, p2)


def test_clamp_and_sign_extension_semantics():
    """B4 semantics: decoding unsigned streams into signed targets
    sign-extends top-bit-set fields; narrow targets clamp."""
    vals = np.array([[5, 70000, 3]], dtype=np.uint32)  # width 17 block
    arch = ncodec.encode(vals)
    # into int16: mathematical values clamped to int16 range
    out16 = ncodec.decode(arch, np.int16)
    py16 = pycodec.decode(arch, np.int16)
    np.testing.assert_array_equal(out16, py16)
    # into int32 (wide enough): raw reinterpretation
    np.testing.assert_array_equal(
        ncodec.decode(arch, np.int32), pycodec.decode(arch, np.int32)
    )
    # into uint16: clamped at 65535
    np.testing.assert_array_equal(
        ncodec.decode(arch, np.uint16), pycodec.decode(arch, np.uint16)
    )


def test_float_targets():
    uns = ncodec.encode(np.array([[1, 2, 70000]], dtype=np.uint32))
    np.testing.assert_array_equal(
        ncodec.decode(uns, np.float32), pycodec.decode(uns, np.float32)
    )
    sgn = ncodec.encode(np.array([[-5, 2, 7]], dtype=np.int32))
    np.testing.assert_array_equal(
        ncodec.decode(sgn, np.float64), pycodec.decode(sgn, np.float64)
    )


def test_signed_into_unsigned_refused():
    arch = ncodec.encode(np.array([[-1, 2]], dtype=np.int16))
    with pytest.raises(TypeError):
        ncodec.decode(arch, np.uint16)


def test_malformed_payload_raises():
    arch = ncodec.encode(np.array([[1000, 2000, 3000]], dtype=np.uint16))
    with pytest.raises(ValueError):
        native.walk(arch.payload[:1], arch.meta.number_of_frames,
                    arch.meta.number_of_values, arch.meta.block)


def test_partial_blocks_multiframe():
    rng = np.random.default_rng(4)
    for n in (1, 11, 12, 13, 25, 50):
        frames = rng.poisson(1.0, size=(3, n)).astype(np.uint16)
        a = ncodec.encode(frames)
        b = pycodec.encode(list(frames))
        assert a.payload == b.payload, f"n={n}"
        np.testing.assert_array_equal(ncodec.decode(a, np.uint16), frames)


def test_tile_tables_matches_numpy():
    """Native prepass tables == the numpy block_bits/level-maxima path
    (bit lengths per Terse.hpp:517-535's header chain + width*count)."""
    from trpx_tpu.ops import coding as pu
    from trpx_tpu.ops.coding import FrameSpec

    rng = np.random.default_rng(11)
    for n, Tb, F in ((5000, 64, 3), (12 * 4096, 1024, 2), (999, 32, 1)):
        spec = FrameSpec.for_dtype(n, np.dtype(np.uint16))
        nb = spec.nb
        widths = rng.integers(0, 14, size=(F, nb)).astype(np.int32)
        # repeat runs so the ==prev header-bit branch is exercised
        widths[:, 1::3] = widths[:, 0:-1:3]
        T = -(-nb // Tb)
        bits = pu.block_bits_host(spec, widths)
        bits_p = np.zeros((F, T * Tb), np.int64)
        bits_p[:, :nb] = bits
        tb_ref = bits_p.reshape(F, T, Tb).sum(axis=2)
        lm_ref = pu._level_maxima(bits_p.reshape(F * T, Tb), Tb)
        tb, lm = native.tile_tables(widths, n, spec.block, Tb)
        np.testing.assert_array_equal(tb, tb_ref)
        assert lm == lm_ref


def test_tile_tables_rejects_bad_args():
    w = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError):
        native.tile_tables(w, 96, 12, 48)  # Tb not a power of two


def test_build_falls_back_to_system_compiler(tmp_path, monkeypatch):
    """A $CXX that cannot build OpenMP code (no libgomp in its
    toolchain) must not cost the native runtime: g++ is tried next."""
    monkeypatch.setenv("TRPX_NATIVE_CACHE", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    so = native._build()
    assert so is not None and so.exists() and so.parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [so.name]


def test_build_failure_warns_and_cleans_up(tmp_path, monkeypatch):
    from trpx_tpu import _fallback

    monkeypatch.setenv("TRPX_NATIVE_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ either
    monkeypatch.setattr(_fallback, "_seen", set())
    with pytest.warns(RuntimeWarning, match="native.build"):
        assert native._build() is None
    assert list((tmp_path / "cache").iterdir()) == []
