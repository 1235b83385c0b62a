"""Regressions pinned from the round-2 code review.

Each test encodes one confirmed finding: hostile/corrupt sidecars must
never reach the native gather unvalidated, the header validator must
accept everything our own encoder emits, and the Terse adapter must
reject dimension drift the reference class errors on.
"""

import numpy as np
import pytest

import trpx_tpu
from trpx_tpu import api
from trpx_tpu.format import pycodec
from trpx_tpu.io.trpx import (
    read_trpx,
    write_index,
    write_trpx,
)


@pytest.fixture()
def archive_file(tmp_path):
    rng = np.random.default_rng(5)
    stack = rng.poisson(3.0, size=(4, 40, 40)).astype(np.uint16)
    arch = api.compress(stack)
    p = tmp_path / "m.trpx"
    write_trpx(arch, p, index=True)
    return p, stack, arch


def test_sidecar_oob_offsets_rejected(archive_file):
    """Offsets pointing outside the payload (or non-monotonic) must be
    discarded — the v2 fast path feeds them into the native memcpy
    gather with no validating walk."""
    p, stack, arch = archive_file
    F = arch.meta.number_of_frames
    for offs in (
        np.array([0, 2**60, 2**61, 2**62], np.int64),          # way out
        np.array([0, 10, 5, 20], np.int64),                    # non-monotonic
        np.array([1, 5, 9, 13], np.int64),                     # frame0 != 0
        np.array([0, 5, 9, arch.meta.memory_size], np.int64),  # last == end
    ):
        write_index(p, offs.astype(np.uint64), arch.meta.memory_size)
        loaded = read_trpx(p)
        assert loaded.frame_index is None, offs
        # decode falls back to the validating walk and stays correct
        np.testing.assert_array_equal(api.decompress(loaded), stack)


def test_sidecar_corrupt_width_table_rejected(archive_file):
    """v2 width tables exceeding the archive's prolix_bits claim are
    corrupt (the walk paths reject such widths); the sidecar must be
    dropped, not fed to the kernels."""
    p, stack, arch = archive_file
    good = read_trpx(p)
    assert good.width_table is not None  # sanity: v2 sidecar present
    wt = np.asarray(good.width_table).copy()
    wt[0, 0] = arch.meta.prolix_bits + 5
    write_index(p, np.asarray(good.frame_index, np.uint64),
                arch.meta.memory_size, widths=wt)
    loaded = read_trpx(p)
    assert getattr(loaded, "width_table", None) is None
    np.testing.assert_array_equal(api.decompress(loaded), stack)


def test_prolix_bits_65_roundtrips():
    """INT64_MIN blocks have signed width 65 (1 + bitlength(2^63)); the
    header validator must accept what our encoder emits (bound is 73,
    the 12-bit header form's maximum, not 64)."""
    frame = np.array([np.iinfo(np.int64).min, -3, 0, 7], dtype=np.int64)
    arch = api.compress(frame[None])
    assert arch.meta.prolix_bits == 65
    blob = arch.to_bytes()
    out = np.asarray(api.decompress(blob, dtype=np.int64)).reshape(-1)
    np.testing.assert_array_equal(out, frame)


def test_push_back_dim_mismatch_rejected():
    """Same flat size, different (h, w): Terse.hpp:314-319 errors; a
    silent accept would scramble prolix()'s reshape."""
    t = trpx_tpu.Terse(np.zeros((4, 8), np.int32))
    with pytest.raises(ValueError, match="dimensions"):
        t.push_back(np.zeros((8, 4), np.int32))
    # matching dims still append
    t.push_back(np.zeros((4, 8), np.int32))
    assert t.number_of_frames == 2


def test_iter_decode_passes_schedule_as_ratio(monkeypatch, tmp_path):
    """Every chunk of the device pipeline reaches the split tree with the
    chunk's full (C, W) word buffer and (C, nb) uint8 width table, and no
    payload-offset table (the tree derives offsets from the widths)."""
    from trpx_tpu.runtime import stream as stream_mod

    rng = np.random.default_rng(8)
    stack = rng.poisson(3.0, size=(6, 1000)).astype(np.uint16)
    arch = pycodec.encode(list(stack))
    p = tmp_path / "s.trpx"
    write_trpx(arch, p)

    seen = []
    from trpx_tpu.ops import coding

    real = coding.decode_batch_device

    def spy(spec, words, widths, *rest):
        seen.append((words.shape, widths.shape, widths.dtype, rest))
        return real(spec, words, widths, *rest)

    monkeypatch.setattr(coding, "decode_batch_device", spy)
    # this pins DEVICE-pipeline plumbing: force iter_decode past the
    # auto-route's host shortcut (which never calls the device decoder)
    out = np.concatenate(
        [np.asarray(c) for c in stream_mod.iter_decode(
            p, np.uint16, chunk_frames=3, device=True)])
    np.testing.assert_array_equal(out[:, :1000], stack)
    assert len(seen) == 2, "one device call per chunk"
    for wshape, dshape, ddtype, rest in seen:
        assert wshape[0] == dshape[0] == 3
        assert dshape[1] == -(-1000 // 12) and ddtype == np.uint8
        assert rest == ()


def test_hostile_sidecar_overclaiming_widths_rejected(tmp_path):
    """A hostile archive whose lone header claims a huge width walks
    'successfully' from a sidecar offset unless the indexed walk checks
    the end-of-payload bound like the serial walk does; without it the
    native decode reads megabytes past the buffer."""
    from trpx_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    from trpx_tpu.format.bitstream import BitWriter as PyWriter

    n = 1_000_000
    # header: 0 + 111 + 11 + (57-10=47 as 6 bits) -> width 57, then no
    # payload bytes at all
    w = PyWriter()
    w.write(0, 1); w.write(7, 3); w.write(3, 2); w.write(47, 6)
    payload = w.getvalue() + b"\x00" * 14
    hdr = (f'<Terse prolix_bits="57" signed="0" block="{n}" '
           f'memory_size="{len(payload)}" number_of_values="{n}" '
           f'number_of_frames="1"/>').encode()
    blob = hdr + payload
    from trpx_tpu.io.trpx import TrpxArchive, write_index

    p = tmp_path / "h.trpx"
    p.write_bytes(blob)
    write_index(p, np.array([0], np.uint64), len(payload))
    from trpx_tpu.io.trpx import read_trpx
    from trpx_tpu.native import codec as ncodec

    arch = read_trpx(p)
    with pytest.raises(ValueError):
        ncodec.decode(arch, np.uint64)


def test_nonnative_endian_encode_normalized():
    """Big-endian input must encode identically to its native-endian
    values (the encoder invariant is bit-identity on VALUES)."""
    from trpx_tpu.native import codec as ncodec

    vals = np.arange(16, dtype=np.uint16)
    a_native = ncodec.encode(vals[None])
    a_be = ncodec.encode(vals.astype(">u2")[None])
    assert a_be.to_bytes() == a_native.to_bytes()
    out = ncodec.decode(a_native, ">u2")
    np.testing.assert_array_equal(out.astype(np.uint16).reshape(-1), vals)


def test_subset_frames_does_not_bypass_width_check(tmp_path):
    """frames=... decode of a corrupt archive must reject like the full
    decode (the cached-offsets walk validates width-over-claim too)."""
    rng = np.random.default_rng(14)
    stack = rng.poisson(3.0, size=(3, 600)).astype(np.uint16)
    stack[1, 0] = 65535
    from trpx_tpu.io.trpx import TrpxArchive

    blob = pycodec.encode(list(stack)).to_bytes()
    tampered = blob.replace(b'prolix_bits="16"', b'prolix_bits="11"')
    assert tampered != blob
    arch = TrpxArchive.from_bytes(tampered)
    with pytest.raises(ValueError, match="prolix_bits"):
        api.decompress(arch, frames=[0], device=True)


def test_host_chunk_empty_frames_noop(tmp_path):
    from trpx_tpu.io.trpx import read_trpx
    from trpx_tpu.runtime.stream import StreamingEncoder

    rng = np.random.default_rng(15)
    stack = rng.poisson(3.0, size=(4, 200)).astype(np.uint16)
    dst = tmp_path / "e.trpx"
    enc = StreamingEncoder(dst, nvalues=200, dtype=np.uint16,
                           backend="host")
    enc.add_frames(stack[:2])
    enc.add_frames(stack[:0])  # empty chunk: must be a no-op
    enc.add_frames(stack[2:])
    enc.finalize(verify=True, index=True)
    arch = read_trpx(dst)
    assert arch.frame_index is not None  # sidecar consistent, not stale
    assert arch.to_bytes() == pycodec.encode(list(stack)).to_bytes()


def test_cli_bad_frames_spec_clean_error(tmp_path, capsys):
    from trpx_tpu.cli.main import prolix_main

    rng = np.random.default_rng(16)
    from trpx_tpu.io.trpx import write_trpx

    arch = pycodec.encode([rng.poisson(3.0, 100).astype(np.uint16)])
    p = tmp_path / "c.trpx"
    write_trpx(arch, p)
    assert prolix_main([str(p), "--frames", "1:2:3:4", "--host"]) == 2
    assert prolix_main([str(p), "--frames", "abc", "--host"]) == 2
