"""Hostile-input fuzzing of the decode surfaces.

A production decoder ingests untrusted bytes. These tests mutate valid
archives — payload byte flips, truncations, header-attribute tampering,
random garbage — and drive every decode backend (host pycodec, native
walk+codec, the device split tree). Acceptable outcomes per mutation:
a clean Python exception (ValueError/TypeError/OverflowError) or a
successful decode (possibly to garbage pixels — corruption can still be
a well-formed stream). Never a crash, hang, or native memory fault
(ASAN-class faults would abort the interpreter and fail the test run).
"""

import numpy as np
import pytest

from trpx_tpu import api
from trpx_tpu.format import pycodec
from trpx_tpu.io.trpx import TrpxArchive

OK_ERRORS = (ValueError, TypeError, OverflowError, KeyError, IndexError)


def _base_archive(seed: int = 7, frames: int = 3, n: int = 1000) -> bytes:
    rng = np.random.default_rng(seed)
    stack = rng.poisson(3.0, size=(frames, n)).astype(np.uint16)
    stack[:, rng.integers(0, n, 20)] = 65535  # hot pixels: wide blocks
    return pycodec.encode(list(stack)).to_bytes()


def _try_decode_all(blob: bytes) -> None:
    """Every backend must either decode or raise a clean error."""
    # host path (pycodec via api)
    try:
        api.decompress(blob, device=False)
    except OK_ERRORS:
        pass
    # device path (the jnp split tree); forced so the small-workload
    # auto-routing doesn't hide it
    try:
        api.decompress(blob, device=True)
    except OK_ERRORS:
        pass
    # native walk (the C code parses the untrusted payload directly)
    try:
        from trpx_tpu.native import codec as native

        arch = TrpxArchive.from_bytes(blob)
        native.decode(arch, np.uint16)
    except OK_ERRORS:
        pass


def test_payload_byte_flips():
    base = bytearray(_base_archive())
    hdr_end = base.index(b"/>") + 2
    rng = np.random.default_rng(0)
    for _ in range(120):
        blob = bytearray(base)
        i = int(rng.integers(hdr_end, len(blob)))
        blob[i] ^= int(rng.integers(1, 256))
        _try_decode_all(bytes(blob))


def test_payload_truncations():
    base = _base_archive()
    hdr_end = base.index(b"/>") + 2
    rng = np.random.default_rng(1)
    cuts = set(int(rng.integers(0, len(base))) for _ in range(40))
    cuts |= {0, 1, hdr_end - 1, hdr_end, hdr_end + 1, len(base) - 1}
    for cut in sorted(cuts):
        _try_decode_all(base[:cut])


def test_header_attribute_tampering():
    base = _base_archive()
    hdr_end = base.index(b"/>") + 2
    hdr, payload = base[:hdr_end].decode("latin1"), base[hdr_end:]
    meta = pycodec.decode_header(base)[0] if hasattr(
        pycodec, "decode_header") else None
    tampered = [
        hdr.replace('number_of_values="1000"', 'number_of_values="100000"'),
        hdr.replace('number_of_values="1000"', 'number_of_values="0"'),
        hdr.replace('number_of_values="1000"', 'number_of_values="-5"'),
        hdr.replace('number_of_frames="3"', 'number_of_frames="1000000"'),
        hdr.replace('number_of_frames="3"', 'number_of_frames="0"'),
        hdr.replace('block="12"', 'block="0"'),
        hdr.replace('block="12"', 'block="-1"'),
        hdr.replace('block="12"', 'block="1000000000"'),
        hdr.replace('prolix_bits="16"', 'prolix_bits="200"'),
        hdr.replace('prolix_bits="16"', 'prolix_bits="-3"'),
        hdr.replace('signed="0"', 'signed="1"'),
        # memory_size lies (larger and smaller than the real payload)
        *(
            hdr.replace(f'memory_size="{len(payload)}"',
                        f'memory_size="{v}"')
            for v in (0, 1, len(payload) * 100, -1)
        ),
    ]
    del meta
    for h in tampered:
        _try_decode_all(h.encode("latin1") + payload)


def test_random_garbage_blobs():
    rng = np.random.default_rng(2)
    for size in (0, 1, 7, 100, 4096):
        blob = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        try:
            api.decompress(blob)
        except OK_ERRORS:
            pass
    # a plausible-looking header followed by random bytes
    junk = (b'<Terse prolix_bits="16" signed="0" block="12" '
            b'memory_size="512" number_of_values="1000" '
            b'number_of_frames="2"/>'
            + rng.integers(0, 256, size=512, dtype=np.uint8).tobytes())
    _try_decode_all(junk)


def test_signed_flip_into_unsigned_refused():
    """Flipping signed=1 onto an unsigned stream must hit the type gate,
    not crash in sign extension."""
    base = _base_archive()
    blob = base.replace(b'signed="0"', b'signed="1"')
    with pytest.raises(TypeError):
        api.decompress(blob, dtype=np.uint16)


def test_width_over_prolix_bits_detected():
    """An archive whose payload holds blocks wider than the header's
    prolix_bits claim is corrupt by the encoder invariant
    (Terse.hpp:516); the walk must reject it, not garbage-decode."""
    from trpx_tpu.ops.coding import FrameSpec, walk_archive

    rng = np.random.default_rng(3)
    stack = rng.poisson(3.0, size=(2, 1000)).astype(np.uint16)
    stack[0, 5] = 65535  # width-16 block
    blob = pycodec.encode(list(stack)).to_bytes()
    tampered = blob.replace(b'prolix_bits="16"', b'prolix_bits="3"')
    assert tampered != blob
    arch = TrpxArchive.from_bytes(tampered)
    spec = FrameSpec.for_dtype(1000, np.uint8)
    with pytest.raises(ValueError, match="prolix_bits"):
        walk_archive(arch, spec)


def test_native_walk_max_width_kwarg():
    from trpx_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(4)
    stack = rng.poisson(3.0, size=(2, 500)).astype(np.uint16)
    stack[1, 3] = 4095  # width 12
    arch = pycodec.encode(list(stack))
    # passes at the true bound, raises below it
    native.walk(arch.payload, 2, 500, 12, max_width=12)
    with pytest.raises(ValueError, match="exceeds"):
        native.walk(arch.payload, 2, 500, 12, max_width=11)
    fs = native.walk(arch.payload, 2, 500, 12)[2]
    native.walk_indexed(arch.payload, fs[:-1], 500, 12, max_width=12)
    with pytest.raises(ValueError, match="exceeds"):
        native.walk_indexed(arch.payload, fs[:-1], 500, 12, max_width=11)


@pytest.mark.parametrize("seed", range(4))
def test_multi_byte_corruption_bursts(seed):
    """Bursts of corruption (8-64 consecutive bytes) — the walk must
    terminate (runaway widths are caught within one refill window)."""
    base = bytearray(_base_archive(seed=seed + 100, frames=2, n=3000))
    hdr_end = base.index(b"/>") + 2
    rng = np.random.default_rng(seed)
    for _ in range(16):
        blob = bytearray(base)
        start = int(rng.integers(hdr_end, len(blob) - 64))
        ln = int(rng.integers(8, 64))
        blob[start:start + ln] = rng.integers(
            0, 256, size=ln, dtype=np.uint8).tobytes()
        _try_decode_all(bytes(blob))


def test_sidecar_fuzz(tmp_path):
    """Random mutations of the .trpx.idx sidecar: the trailing CRC32
    must reject EVERY corrupted sidecar at load (decode falls back to
    the validating walk), so decode either raises cleanly or produces
    exact pixels — on the host path AND on the device (walk-free v2)
    path, the one that feeds sidecar offsets straight into the gather."""
    from trpx_tpu import ops
    from trpx_tpu.io.trpx import read_trpx, write_trpx

    rng = np.random.default_rng(77)
    stack = rng.poisson(3.0, size=(6, 500)).astype(np.uint16)
    arch = pycodec.encode(list(stack))
    p = tmp_path / "f.trpx"
    write_trpx(arch, p, index=True)
    idx = (tmp_path / "f.trpx.idx").read_bytes()
    for trial in range(60):
        blob = bytearray(idx)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(blob)))
            blob[i] ^= int(rng.integers(1, 256))
        (tmp_path / "f.trpx.idx").write_bytes(bytes(blob))
        loaded = read_trpx(p)
        assert loaded.frame_index is None, (
            "CRC32 must reject any corrupted sidecar")
        try:
            out = api.decompress(loaded, device=False)
        except OK_ERRORS:
            continue
        np.testing.assert_array_equal(
            np.asarray(out).reshape(6, -1)[:, :500], stack)
        if trial % 10 == 0:
            # device path: walk_archive's v2 branch would consume the
            # sidecar tables with no validating walk — must see none
            dev = ops.decode(read_trpx(p), np.uint16)
            np.testing.assert_array_equal(
                np.asarray(dev).reshape(6, -1)[:, :500], stack)


# ------------------------------------------- device tables, untrusted ---


def _table_base(seed=21, frames=3, n=3000):
    rng = np.random.default_rng(seed)
    stack = rng.poisson(3.0, size=(frames, n)).astype(np.uint16)
    stack[:, rng.integers(0, n, 30)] = 65535
    return stack, pycodec.encode(list(stack))


@pytest.mark.parametrize("form", ["decode_batch_device",
                                  "decode_batch_direct"])
def test_device_route_hostile_tables(form):
    """The device decoders take untrusted width tables (a sidecar's, or a
    corrupt walk's): width over-claims, negative widths, zeroed tables and
    byte-flipped word streams must decode to garbage or raise cleanly —
    never crash, hang, or read out of bounds."""
    from trpx_tpu.ops import coding
    from trpx_tpu.ops.coding import FrameSpec, walk_archive

    decode = getattr(coding, form)
    stack, arch = _table_base()
    spec = FrameSpec.for_dtype(3000, np.uint16)
    widths, _p, words = walk_archive(arch, spec)

    # sane baseline first: the route must be exact
    out = np.asarray(decode(spec, words, widths))[:, :3000]
    np.testing.assert_array_equal(out.astype(np.uint16), stack)

    rng = np.random.default_rng(5)
    F, nb = widths.shape
    for trial in range(24):
        wd = widths.copy()
        wbuf = words
        kind = trial % 4
        if kind == 0:     # width over-claims (past prolix_bits, up to 255)
            idx = rng.integers(0, nb, 5)
            wd[rng.integers(0, F), idx] = rng.integers(17, 256, 5)
        elif kind == 1:   # negative widths
            wd[rng.integers(0, F), rng.integers(0, nb, 3)] = -int(
                rng.integers(1, 100))
        elif kind == 2:   # zeroed tail (offsets collapse)
            wd[:, int(rng.integers(0, nb)):] = 0
        else:             # word-stream byte flips
            wbuf = words.copy()
            wv = wbuf.view(np.uint8)
            for _ in range(8):
                wv[rng.integers(0, wv.shape[0]),
                   rng.integers(0, wv.shape[1])] ^= int(
                       rng.integers(1, 256))
        try:
            np.asarray(decode(spec, wbuf, wd))  # force materialization
        except OK_ERRORS:
            pass


def test_stale_sidecar_rejected(tmp_path):
    """A CRC-valid but STALE sidecar (archive re-encoded in place with
    the same shape) must not walk-free-decode to garbage: the table
    cross-check (ops.coding.validate_tables) falls back to a real walk
    and the decode is exact."""
    from trpx_tpu.io.trpx import read_trpx, write_trpx

    rng = np.random.default_rng(31)
    old = rng.poisson(3.0, size=(5, 1200)).astype(np.uint16)
    new = rng.poisson(3.0, size=(5, 1200)).astype(np.uint16)
    new[0, 0] = 60001  # ensure different widths/sizes somewhere
    p = tmp_path / "s.trpx"
    write_trpx(pycodec.encode(list(old)), p, index=True)   # sidecar of OLD
    # re-encode NEW data in place, keeping the stale sidecar
    p.write_bytes(pycodec.encode(list(new)).to_bytes())
    loaded = read_trpx(p)
    with np.testing.suppress_warnings() as sup:
        sup.filter(RuntimeWarning)
        out = api.decompress(loaded, dtype=np.uint16, device=True)
    np.testing.assert_array_equal(np.asarray(out).reshape(5, 1200), new)
    out2 = api.decompress(read_trpx(p), dtype=np.uint16, device=False)
    np.testing.assert_array_equal(np.asarray(out2).reshape(5, 1200), new)


def test_crafted_sidecar_inconsistent_tables(tmp_path):
    """A crafted sidecar with IN-RANGE widths (every load-time gate
    passes: CRC, shape, widths <= prolix_bits) that are inconsistent
    with the stream must still be distrusted — the byte-length
    cross-check (ops.coding.validate_tables) re-walks instead of
    garbage-decoding through the walk-free v2 path."""
    from trpx_tpu.io.trpx import read_trpx, write_index, write_trpx
    from trpx_tpu.runtime.stream import iter_decode

    rng = np.random.default_rng(32)
    stack = rng.poisson(3.0, size=(5, 1200)).astype(np.uint16)
    stack[:, rng.integers(0, 1200, 20)] = 65535   # prolix_bits = 16
    arch = pycodec.encode(list(stack))
    assert arch.meta.prolix_bits == 16
    p = tmp_path / "c.trpx"
    write_trpx(arch, p, index=True)
    good = read_trpx(p)
    assert good.frame_index is not None and good.width_table is not None
    bad_w = np.asarray(good.width_table).copy()
    bad_w[2, 3] = 6 if bad_w[2, 3] != 6 else 5   # <= prolix_bits, wrong
    write_index(p, np.asarray(good.frame_index), arch.meta.memory_size,
                widths=bad_w)
    loaded = read_trpx(p)
    assert loaded.width_table is not None  # every load-time gate passed
    with np.testing.suppress_warnings() as sup:
        sup.filter(RuntimeWarning)
        out = api.decompress(loaded, dtype=np.uint16, device=True)
        np.testing.assert_array_equal(np.asarray(out).reshape(5, 1200), stack)
        # chunked pipeline must also re-walk, not trust the tables
        got = np.concatenate(list(iter_decode(read_trpx(p), np.uint16,
                                              chunk_frames=2, device=True)))
    np.testing.assert_array_equal(got, stack)
