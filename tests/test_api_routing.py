"""Engine routing (``api.route``): device=None must mean 'a real
accelerator and a workload big enough for it', decided in-process."""

import subprocess

import jax
import numpy as np
import pytest

import trpx_tpu.api as api_mod
from trpx_tpu import api

MIN = api_mod._DEVICE_MIN_BYTES
DEVICE_DTYPES = [np.uint8, np.uint16, np.uint32, np.int8, np.int16, np.int32]
HOST_DTYPES = [np.uint64, np.int64]


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("raw_bytes", [MIN - 1, MIN])
@pytest.mark.parametrize("dtype", DEVICE_DTYPES + HOST_DTYPES,
                         ids=lambda d: np.dtype(d).name)
def test_route_table(monkeypatch, dtype, raw_bytes, backend):
    """dtype x size x backend -> engine: the device only for a device
    dtype of at least _DEVICE_MIN_BYTES on an accelerator backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    want = ("device" if dtype in DEVICE_DTYPES and raw_bytes >= MIN
            and backend == "gpu" else "host")
    assert api.route(dtype, raw_bytes) == want
    # the decode question adds the stream's widest field: it must fit
    bits = 8 * np.dtype(dtype).itemsize
    assert api.route(dtype, raw_bytes, prolix_bits=bits) == want
    assert api.route(dtype, raw_bytes, prolix_bits=bits + 2) == "host"


def test_route_forced(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert api.route(np.uint16, 1 << 30, device=False) == "host"
    assert api.route(np.uint16, 1, device=True) == "device"
    # signed streams carry one sign bit beyond the dtype's width
    assert api.route(np.int16, MIN, prolix_bits=17) == "device"
    with pytest.raises(ValueError):
        api.route(np.uint16, MIN, device=True, prolix_bits=17)


def test_route_starts_no_process(monkeypatch):
    """The backend is asked in-process: a second JAX process would find
    the card's memory already reserved."""
    def boom(*a, **k):
        raise AssertionError("route must not start a process")

    monkeypatch.setattr(subprocess, "run", boom)
    monkeypatch.setattr(subprocess, "Popen", boom)
    assert api.route(np.uint16, 1 << 30) == "host"  # conftest: cpu backend


def test_auto_routes_host_on_cpu_backend():
    """Big (>4 MiB) auto workloads use the native host codec on CPU-only
    jax — XLA's CPU build of the trees is far slower there."""
    frames = np.random.default_rng(0).poisson(
        3.0, (24, 512, 512)).astype(np.uint16)
    assert api.route(frames.dtype, frames.nbytes) == "host"
    arch = api.compress(frames)  # device=None
    out = api.decompress(arch)
    np.testing.assert_array_equal(np.asarray(out).reshape(frames.shape),
                                  frames)


def test_big_device_decode_streams_in_chunks(monkeypatch):
    """decompress(device=True) on a >_DEVICE_CHUNK_FRAMES archive routes
    through the chunked walk||unpack pipeline (O(chunk) host buffers)
    and stays pixel-exact across the chunk boundaries."""
    import trpx_tpu.runtime.stream as stream_mod

    rng = np.random.default_rng(1)
    F, h, w = 2 * api_mod._DEVICE_CHUNK_FRAMES + 37, 64, 64
    frames = rng.poisson(3.0, (F, h, w)).astype(np.uint16)
    frames[rng.random((F, h, w)) < 0.01] = 60000
    arch = api.compress(frames, device=False)

    calls = []
    real = stream_mod.iter_decode

    def spy(archive, dtype, chunk_frames=256, device=None):
        calls.append((chunk_frames, device))
        return real(archive, dtype, chunk_frames, device)

    monkeypatch.setattr(stream_mod, "iter_decode", spy)
    out = api.decompress(arch, device=True)
    np.testing.assert_array_equal(np.asarray(out), frames)
    assert calls == [(api_mod._DEVICE_CHUNK_FRAMES, True)]
