"""Device-path (jnp) codec vs the normative format layer.

Runs on the virtual CPU backend (conftest); the same code compiles for
the GPU.
"""

import numpy as np
import pytest

from trpx_tpu import format as fmt
from trpx_tpu import ops

RNG = np.random.default_rng(42)

DEVICE_DTYPES = [
    ("u8", np.uint8, 0, 2**8),
    ("u16", np.uint16, 0, 2**16),
    ("u32", np.uint32, 0, 2**32),
    ("i8", np.int8, -(2**7), 2**7),
    ("i16", np.int16, -(2**15), 2**15),
    ("i32", np.int32, -(2**31), 2**31),
]


def random_frames(dtype, lo, hi, F, n, zero_frac=0.3):
    arr = RNG.integers(lo, hi, size=(F, n)).astype(dtype)
    mask = RNG.random((F, n)) < zero_frac
    arr[mask] = 0
    return arr


@pytest.mark.parametrize("tag,dtype,lo,hi", DEVICE_DTYPES,
                         ids=[d[0] for d in DEVICE_DTYPES])
@pytest.mark.parametrize("n", [1, 12, 16, 500])
def test_device_encode_matches_pycodec(tag, dtype, lo, hi, n):
    arr = random_frames(dtype, lo, hi, 2, n)
    dev = ops.encode(arr).to_bytes()
    ref = fmt.encode(list(arr)).to_bytes()
    assert dev == ref


@pytest.mark.parametrize("tag,dtype,lo,hi", DEVICE_DTYPES,
                         ids=[d[0] for d in DEVICE_DTYPES])
def test_device_roundtrip(tag, dtype, lo, hi):
    arr = random_frames(dtype, lo, hi, 3, 321)
    arc = ops.encode(arr)
    out = ops.decode(arc, dtype)
    np.testing.assert_array_equal(out, arr)


def test_device_decode_of_pycodec_stream():
    arr = random_frames(np.uint16, 0, 3000, 2, 100)
    arc = fmt.encode(list(arr))
    out = ops.decode(arc, np.uint16)
    np.testing.assert_array_equal(out, arr)


def test_device_extreme_values_i32():
    """int32 min produces the width-33 sign-bit path."""
    arr = np.array([[np.iinfo(np.int32).min, -1, 0, 5, np.iinfo(np.int32).max] * 4],
                   dtype=np.int32)
    arc = ops.encode(arr)
    assert arc.meta.prolix_bits == 33
    out = ops.decode(arc, np.int32)
    np.testing.assert_array_equal(out, arr)
    # normative layer agrees byte-for-byte
    assert arc.to_bytes() == fmt.encode(list(arr)).to_bytes()


def test_device_u32_full_range():
    arr = np.array([[0xFFFFFFFF, 0, 1, 2**31, 77] * 5], dtype=np.uint32)
    arc = ops.encode(arr)
    assert arc.to_bytes() == fmt.encode(list(arr)).to_bytes()
    np.testing.assert_array_equal(ops.decode(arc, np.uint32), arr)


def test_device_all_zero_and_constant():
    z = np.zeros((2, 50), dtype=np.uint16)
    assert ops.encode(z).to_bytes() == fmt.encode(list(z)).to_bytes()
    c = np.full((1, 50), 5, dtype=np.uint16)
    assert ops.encode(c).to_bytes() == fmt.encode(list(c)).to_bytes()


@pytest.mark.parametrize("block", [1, 3, 12, 64])
def test_device_block_sizes(block):
    arr = random_frames(np.uint16, 0, 65536, 1, 200)
    dev = ops.encode(arr, block=block).to_bytes()
    ref = fmt.encode(list(arr), block=block).to_bytes()
    assert dev == ref


def test_device_poisson_diffraction_512():
    frame = RNG.poisson(3.0, size=(1, 512 * 512)).astype(np.uint16)
    hot = RNG.integers(0, frame.size, 200)
    frame.reshape(-1)[hot] = RNG.integers(1000, 65536, 200).astype(np.uint16)
    arc = ops.encode(frame, dimensions=(512, 512))
    out = ops.decode(arc, np.uint16)
    np.testing.assert_array_equal(out, frame)
    assert arc.meta.memory_size < frame.nbytes * 0.35


def test_device_rejects_64bit():
    with pytest.raises(TypeError):
        ops.encode(np.zeros((1, 4), dtype=np.uint64))


def test_device_decode_narrowing_clamps_like_host():
    """Fields wider than the target dtype must CLAMP, not wrap
    (Bit_pointer.hpp:747-762; a device astype would wrap)."""
    vals = np.array([[40000, -40000, 123, -1, 32767, -32768]], np.int32)
    arc = ops.encode(vals)
    host = fmt.decode(arc, np.int16)
    dev = ops.decode(arc, np.int16)
    np.testing.assert_array_equal(dev, host)
    assert dev[0, 0] == 32767 and dev[0, 1] == -32768

    uvals = np.array([[70000, 65535, 5, 0, 2**31]], np.uint32)
    uarc = ops.encode(uvals)
    uhost = fmt.decode(uarc, np.uint16)
    udev = ops.decode(uarc, np.uint16)
    np.testing.assert_array_equal(udev, uhost)
    assert udev[0, 0] == 65535


def test_pallas_routing_has_lower_bound():
    """Every frame size takes the one device route, down to a frame of
    fewer blocks than one tree level pairs (a 2x2 int16 image crashed a
    layout-bound kernel once); the device batch is padded to the block
    grid and nothing else."""
    from trpx_tpu.ops.coding import FrameSpec, _pad_batch

    tiny = FrameSpec.for_dtype(4, np.int16)
    assert (tiny.nb, tiny.n_padded, tiny.tree_rows) == (1, 12, 1)
    padded = _pad_batch(np.ones((3, 4), np.int16), tiny)
    assert padded.shape == (4, 12) and not padded[3].any()
    assert not padded[:3, 4:].any()
    # the full device api path round-trips a tiny frame
    x = np.array([[-3, 4], [2, 1]], dtype=np.int16)
    arc = ops.encode(x.reshape(1, -1))
    np.testing.assert_array_equal(ops.decode(arc, np.int16), x.reshape(1, -1))
