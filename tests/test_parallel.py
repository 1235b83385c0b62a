"""Sharded codec tests on the virtual 8-device CPU mesh (conftest forces
``--xla_force_host_platform_device_count=8``).

Invariant under test: the mesh-parallel archive is byte-identical to the
single-device archive (and hence to the reference encoder) for any frame
count, including counts not divisible by the device count.
"""

import jax
import numpy as np
import pytest

from trpx_tpu import ops
from trpx_tpu.format import pycodec
from trpx_tpu.parallel import (
    ShardedCodec,
    decode_sharded,
    default_mesh,
    encode_sharded,
)
from trpx_tpu.ops.coding import FrameSpec


def test_virtual_mesh_present():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("F", [1, 3, 8, 13])
def test_sharded_encode_matches_single_device(F):
    rng = np.random.default_rng(F)
    frames = rng.poisson(3.0, size=(F, 16, 16)).astype(np.uint16)
    flat = frames.reshape(F, -1)
    sharded = encode_sharded(frames)
    single = ops.encode(flat, dimensions=(16, 16))
    assert sharded.meta == single.meta
    assert sharded.payload == single.payload
    # and equals the normative host codec
    host = pycodec.encode(list(flat), dimensions=(16, 16))
    assert sharded.to_bytes() == host.to_bytes()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.int32])
def test_sharded_roundtrip_dtypes(dtype):
    rng = np.random.default_rng(42)
    info = np.iinfo(dtype)
    lo = max(info.min, -1000) if np.dtype(dtype).kind == "i" else 0
    hi = min(info.max, 4000)
    frames = rng.integers(lo, hi, size=(11, 100), dtype=dtype)
    arch = encode_sharded(frames)
    out = decode_sharded(arch, dtype)
    np.testing.assert_array_equal(out, frames)


def test_sharded_partial_blocks_and_hot_pixels():
    rng = np.random.default_rng(7)
    frames = rng.poisson(3.0, size=(9, 50)).astype(np.uint16)  # 50 % 12 != 0
    frames[rng.integers(0, 9, 15), rng.integers(0, 50, 15)] = 65535
    arch = encode_sharded(frames)
    host = pycodec.encode(list(frames))
    assert arch.to_bytes() == host.to_bytes()
    np.testing.assert_array_equal(decode_sharded(arch, np.uint16), frames)


def test_measured_schedule_path_taken(recwarn):
    """The measured-capacity prepass must actually engage: a silent
    fallback to worst-case capacities would only show up as an
    unexplained perf drop, so ShardedCodec._measured has no fallback —
    assert the happy path produces a real schedule and no warning."""
    import warnings

    rng = np.random.default_rng(3)
    spec = FrameSpec.for_dtype(256, np.uint16)
    codec = ShardedCodec(spec, default_mesh())
    frames, _ = codec.pad_frames(
        rng.poisson(3.0, size=(8, 256)).astype(np.uint16))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        measured = codec._measured(
            codec._shard(frames, __import__("jax").sharding.PartitionSpec(
                "frames", None)))
    assert measured.cap_sched is not None, "measured schedule not engaged"
    # the schedule must be proven-tight: no level above worst case, at
    # least one strictly below it (Poisson-3 data compresses ~5x)
    worst = FrameSpec(n=spec.n, block=spec.block, signed=spec.signed,
                      max_width=spec.max_width).pack_caps
    assert all(m <= w for m, w in zip(measured.cap_sched, worst))
    assert any(m < w for m, w in zip(measured.cap_sched, worst))


@pytest.mark.slow
def test_sharded_flagship_shape_byte_identity():
    """512x512 u16 (the flagship shape) sharded over the 8-device CPU
    mesh: archive byte-identical to the single-device encoder and decode
    pixel-exact."""
    rng = np.random.default_rng(11)
    n = 512 * 512
    frames = rng.poisson(3.0, size=(8, n)).astype(np.uint16)
    hot = rng.random(frames.shape) < 200.0 / n
    frames[hot] = 60000
    spec = FrameSpec.for_dtype(n, np.uint16)
    codec = ShardedCodec(spec, default_mesh())
    arch = codec.encode(frames, dimensions=(512, 512))
    single = ops.encode(frames, dimensions=(512, 512))
    assert arch.meta == single.meta
    assert arch.payload == single.payload
    np.testing.assert_array_equal(codec.decode(arch, np.uint16), frames)


def test_sharded_codec_reuse_and_offsets():
    """Offsets from the all-gathered size table match a serial scan."""
    rng = np.random.default_rng(8)
    spec = FrameSpec.for_dtype(64, np.uint16)
    codec = ShardedCodec(spec, default_mesh())
    frames = rng.poisson(2.0, size=(10, 64)).astype(np.uint16)
    arch = codec.encode(frames)
    # offsets from the collective must agree with a serial host walk
    offs = pycodec.frame_offsets(arch)
    assert offs[0] == 0
    last_end = pycodec.walk_frame(arch.payload, offs[-1], 64, 12)[2]
    assert last_end == arch.meta.memory_size
    out = codec.decode(arch, np.uint16)
    np.testing.assert_array_equal(out, frames)


# ------------------------------------------------ launcher environment ---


@pytest.fixture
def init_calls(monkeypatch):
    """Record jax.distributed.initialize's arguments (no real runtime)."""
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "JAX_LOCAL_DEVICE_IDS"):
        monkeypatch.delenv(k, raising=False)
    return calls


def _launcher_env(monkeypatch, pid=2):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:12345")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", str(pid))


@pytest.mark.parametrize("ids,want", [("2", [2]), ("0,1", [0, 1])])
def test_init_from_env_pins_local_devices(init_calls, monkeypatch, ids, want):
    """One process per card: JAX_LOCAL_DEVICE_IDS reaches
    jax.distributed.initialize, so the process opens only its card."""
    from trpx_tpu.parallel.distributed import init_from_env

    _launcher_env(monkeypatch)
    monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", ids)
    assert init_from_env() is True
    assert init_calls == [dict(coordinator_address="localhost:12345",
                               num_processes=4, process_id=2,
                               local_device_ids=want)]


def test_init_from_env_unpinned_and_absent(init_calls, monkeypatch):
    """No pin: the process keeps every local device (one process per
    host); no launcher environment: no runtime at all."""
    from trpx_tpu.parallel.distributed import init_from_env

    assert init_from_env() is False and init_calls == []
    _launcher_env(monkeypatch, pid=0)
    assert init_from_env() is True
    assert init_calls[-1]["local_device_ids"] is None
