"""Determinism: identical bytes across runs, paths, and device counts.

The replacement for race detection (SURVEY §5): XLA owns the scheduling,
so the property to enforce is that every execution of the encoder over
any device layout yields the same archive bytes.
"""

import jax
import numpy as np
from jax.sharding import Mesh

from trpx_tpu import ops
from trpx_tpu.format import pycodec
from trpx_tpu.native import codec as ncodec
from trpx_tpu.ops.coding import FrameSpec
from trpx_tpu.parallel import ShardedCodec
from trpx_tpu.parallel.codec import AXIS


def test_repeated_runs_identical():
    rng = np.random.default_rng(0)
    frames = rng.poisson(3.0, size=(6, 300)).astype(np.uint16)
    a = ops.encode(frames)
    b = ops.encode(frames.copy())
    assert a.to_bytes() == b.to_bytes()


def test_all_paths_agree():
    rng = np.random.default_rng(1)
    frames = rng.poisson(3.0, size=(5, 200)).astype(np.uint16)
    frames[0, 0] = 65535
    ref = pycodec.encode(list(frames))
    assert ops.encode(frames).to_bytes() == ref.to_bytes()
    if ncodec.available():
        assert ncodec.encode(frames).to_bytes() == ref.to_bytes()
    from trpx_tpu.runtime.stream import StreamingEncoder

    # the streaming encoder's optimistic-capacity tree, same bytes
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as td:
        enc = StreamingEncoder(Path(td) / "s.trpx", nvalues=200,
                               dtype=np.uint16, backend="device")
        enc.add_frames(frames)
        assert enc.finalize().read_bytes() == ref.to_bytes()


def test_device_count_invariance():
    """1-, 2-, 4- and 8-device meshes produce byte-identical archives."""
    rng = np.random.default_rng(2)
    frames = rng.poisson(3.0, size=(8, 100)).astype(np.uint16)
    spec = FrameSpec.for_dtype(100, np.uint16, cap_ratio=0.5)
    blobs = set()
    for ndev in (1, 2, 4, 8):
        mesh = Mesh(np.asarray(jax.devices()[:ndev]), (AXIS,))
        blobs.add(ShardedCodec(spec, mesh).encode(frames).to_bytes())
    assert len(blobs) == 1
