"""Real multi-process distributed encode (SURVEY §4(3)).

Spawns 2 actual Python processes, each a jax.distributed participant
with 4 virtual CPU devices (8 global), encoding disjoint frame shards
into ONE shared .trpx file via the replicated size-table/offset path
(parallel/codec.encode_shards + parallel/distributed.write_shard_file).
The gathered archive must be byte-identical to the single-process
(normative pycodec) archive.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from trpx_tpu.format import pycodec

WORKER = Path(__file__).with_name("multiproc_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_shard_encode(tmp_path):
    # guarded by the workers' communicate(timeout=540) below
    nproc = 2
    port = _free_port()
    out = tmp_path / "multi.trpx"
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    # the worker script lives in tests/, so sys.path[0] is tests/ — make
    # the repo root importable regardless of how pytest was launched
    env["PYTHONPATH"] = os.pathsep.join(
        [str(WORKER.parent.parent)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(port), str(nproc), str(pid),
             str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o}\n{e}"

    # byte-identity against the normative single-process archive
    assert out.read_bytes() == _reference_bytes()


def _worker_frames():
    F_global, n = 24, 600
    rng = np.random.default_rng(123)
    frames = rng.poisson(3.0, size=(F_global, n)).astype(np.uint16)
    frames[rng.random((F_global, n)) < 0.002] = 60000
    return frames


def _reference_bytes() -> bytes:
    return pycodec.encode(list(_worker_frames())).to_bytes()


def test_shard_crash_recovery(tmp_path):
    """Elastic recovery (SURVEY §5): one host dies before writing its
    shard; recover_shard re-encodes that frame range from the run
    manifest alone — no live collective — and completes the file."""
    from trpx_tpu.parallel.distributed import recover_shard

    nproc = 2
    port = _free_port()
    out = tmp_path / "crash.trpx"
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    # the worker script lives in tests/, so sys.path[0] is tests/ — make
    # the repo root importable regardless of how pytest was launched
    env["PYTHONPATH"] = os.pathsep.join(
        [str(WORKER.parent.parent)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    env["TRPX_TEST_CRASH_PID"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(port), str(nproc), str(pid),
             str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o}\n{e}"
    ref = _reference_bytes()
    assert out.read_bytes() != ref  # shard 1's bytes are missing

    frames = _worker_frames()
    recover_shard(out, frames[12:24], frame_lo=12)
    assert out.read_bytes() == ref

    # determinism guard: wrong input frames must be rejected
    bad = frames[12:24].copy()
    bad[0, 0] ^= 1023
    with pytest.raises(ValueError):
        recover_shard(out, bad, frame_lo=12)


def test_recover_shard_staged_shape(tmp_path):
    """recover_shard shares the main path's padding contract — frames
    padded to the block grid (n_padded) + manifest-stored dtype — proven
    at the flagship 512² shape, whose last block is partial (262,144
    values in 262,152 block slots), single-process."""
    from trpx_tpu.ops.coding import FrameSpec
    from trpx_tpu.parallel import ShardedCodec, default_mesh
    from trpx_tpu.parallel.distributed import (
        recover_shard,
        write_run_manifest,
        write_shard_file,
    )

    n = 512 * 512
    F = 8
    rng = np.random.default_rng(77)
    frames = rng.poisson(3.0, size=(F, n)).astype(np.uint16)
    frames[rng.random((F, n)) < 1e-4] = 60000
    spec = FrameSpec.for_dtype(n, np.uint16, cap_ratio=0.5)
    codec = ShardedCodec(spec, default_mesh())
    res = codec.encode_shards(frames, F)
    out = tmp_path / "big.trpx"
    write_shard_file(out, res, spec, F)
    write_run_manifest(out, res, spec, F, dtype=frames.dtype)
    ref = out.read_bytes()

    # manifest carries the dtype verbatim (no max_width arithmetic)
    import json

    m = json.loads((tmp_path / "big.trpx.runmanifest").read_text())
    assert np.dtype(m["dtype"]) == np.dtype(np.uint16)

    # lose the back half: zero those frames' payload bytes
    hdr = len(ref) - res.total_bytes
    blob = bytearray(ref)
    lo_f = F // 2
    start = hdr + int(res.offsets[lo_f])
    blob[start:] = bytes(len(blob) - start)
    out.write_bytes(blob)
    assert out.read_bytes() != ref

    recover_shard(out, frames[lo_f:], frame_lo=lo_f)
    assert out.read_bytes() == ref

    # and the recovered archive decodes to the original pixels
    from trpx_tpu import api

    got = np.asarray(api.decompress(str(out), dtype=np.uint16))
    np.testing.assert_array_equal(got.reshape(F, n), frames)


def test_streaming_shard_resume(tmp_path):
    """Streaming x distributed composition: two
    processes x 4 devices stream 32x512^2 frames in 8-frame chunks into
    ONE shared file via StreamingShardEncoder; a mid-stream kill (hard
    os._exit right after the chunk-2 checkpoint) loses nothing past the
    manifest; the relaunched cluster resumes from frames_done, overwrites
    an injected torn tail idempotently, finalizes, and the result is
    byte-identical to the single-host native encoder."""
    import json

    from trpx_tpu.native import codec as ncodec

    nproc = 2
    port = _free_port()
    out = tmp_path / "movie.trpx"
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["PYTHONPATH"] = os.pathsep.join(
        [str(WORKER.parent.parent)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    env["TRPX_TEST_STREAM_CHUNK"] = "8"

    def launch(extra):
        e = dict(env)
        e.update(extra)
        p = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, str(WORKER), str(p), str(nproc), str(pid),
                 str(out)],
                env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
            for pid in range(nproc)
        ]
        return procs, [pr.communicate(timeout=540) for pr in procs]

    # run 1: preempted after 2 chunks; pid 1 dies hard (os._exit(3))
    procs, outs = launch({"TRPX_TEST_STOP_AFTER_CHUNKS": "2",
                          "TRPX_TEST_CRASH_PID": "1"})
    assert procs[0].returncode == 0, f"coordinator:\n{outs[0][1]}"
    assert procs[1].returncode == 3, f"crash pid:\n{outs[1][1]}"
    man = json.loads((tmp_path / "movie.trpx.manifest").read_text())
    assert man["frames_done"] == 16
    assert not out.exists()

    # torn tail: garbage bytes exactly where chunk 3 will land
    with open(tmp_path / "movie.trpx.part", "r+b") as f:
        f.seek(man["payload_bytes"])
        f.write(b"\xde\xad" * 50_000)

    # run 2: resume (no stop/crash) -> completes and finalizes
    procs, outs = launch({})
    for pr, (o, e) in zip(procs, outs):
        assert pr.returncode == 0, f"resume failed:\n{o}\n{e}"
    assert out.exists()
    assert not (tmp_path / "movie.trpx.part").exists()
    assert not (tmp_path / "movie.trpx.manifest").exists()

    rng = np.random.default_rng(321)
    F, n = 32, 512 * 512
    frames = rng.poisson(3.0, size=(F, n)).astype(np.uint16)
    frames[rng.random((F, n)) < 1e-4] = 60000
    ref = ncodec.encode(frames).to_bytes()
    assert out.read_bytes() == ref

    got = ncodec.decode(pycodec.TrpxArchive.from_bytes(out.read_bytes()),
                        np.uint16)
    np.testing.assert_array_equal(np.asarray(got), frames)
