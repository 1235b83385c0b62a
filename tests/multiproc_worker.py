"""Worker for the real multi-process distributed test (SURVEY §4(3)).

Launched by tests/test_multiprocess.py as ``python multiproc_worker.py
<port> <nproc> <pid> <outfile>``: each process initializes
``jax.distributed`` against a local coordinator with 4 virtual CPU
devices (global mesh = nproc × 4), encodes ITS OWN frame shard through
``ShardedCodec.encode_shards`` (the one all_gather crosses processes),
and pwrites its frames into the one shared output file at the absolute
offsets derived from the replicated size table.
"""

import os
import sys


def main() -> int:
    port, nproc, pid = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outfile = sys.argv[4]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc
    assert len(jax.devices()) == 4 * nproc

    import numpy as np

    from trpx_tpu.ops.coding import FrameSpec
    from trpx_tpu.parallel import ShardedCodec, default_mesh
    from trpx_tpu.parallel.distributed import write_shard_file

    stream_chunk = os.environ.get("TRPX_TEST_STREAM_CHUNK")
    if stream_chunk is not None:
        # streaming x distributed composition:
        # chunked collective encode into ONE shared file via
        # StreamingShardEncoder, resumable mid-stream from the manifest
        C = int(stream_chunk)               # global frames per chunk
        F_global, n = 32, 512 * 512
        rng = np.random.default_rng(321)
        frames = rng.poisson(3.0, size=(F_global, n)).astype(np.uint16)
        frames[rng.random((F_global, n)) < 1e-4] = 60000
        spec = FrameSpec.for_dtype(n, np.uint16, cap_ratio=0.5)
        codec = ShardedCodec(spec, default_mesh())
        from trpx_tpu.parallel.distributed import StreamingShardEncoder

        enc = StreamingShardEncoder(outfile, codec, np.uint16)
        stop_after = os.environ.get("TRPX_TEST_STOP_AFTER_CHUNKS")
        crash_pid = os.environ.get("TRPX_TEST_CRASH_PID")
        done = 0
        lo = enc.frames_done                 # resume point
        done = lo // C
        while lo < F_global:
            hi = min(F_global, lo + C)
            Fl = (hi - lo) // nproc
            enc.add_chunk(frames[lo + pid * Fl : lo + (pid + 1) * Fl],
                          hi - lo)
            lo = hi
            done += 1
            if stop_after is not None and done >= int(stop_after):
                # mid-stream preemption: the designated pid dies HARD
                # right after the checkpoint barrier; the rest also exit
                # without any teardown (a preempted cluster never runs
                # the shutdown barrier — os._exit skips atexit, whose
                # distributed shutdown would otherwise fail on the dead
                # peer and pollute the exit code)
                if crash_pid is not None and int(crash_pid) == pid:
                    os._exit(3)
                sys.stdout.flush()
                os._exit(0)
        enc.finalize()
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("trpx-stream-final")
        jax.distributed.shutdown()
        return 0

    # every process derives the SAME global input deterministically and
    # feeds only its own slice (a real ingest pipeline would read its
    # slice of the stack from shared storage)
    F_global, n = 24, 600
    rng = np.random.default_rng(123)
    frames = rng.poisson(3.0, size=(F_global, n)).astype(np.uint16)
    frames[rng.random((F_global, n)) < 0.002] = 60000

    F_local = F_global // nproc
    local = frames[pid * F_local : (pid + 1) * F_local]
    spec = FrameSpec.for_dtype(n, np.uint16, cap_ratio=0.5)
    codec = ShardedCodec(spec, default_mesh())
    res = codec.encode_shards(local, F_global)
    assert res.frame_lo == pid * F_local and res.frame_hi == (pid + 1) * F_local
    crash = os.environ.get("TRPX_TEST_CRASH_PID")
    if crash is not None and int(crash) == pid:
        # fault injection: this host "dies" after the collective but
        # BEFORE writing its shard (tests recover_shard)
        from trpx_tpu.parallel.distributed import write_run_manifest

        if pid == 0:
            write_run_manifest(outfile, res, spec, F_global,
                               dtype=frames.dtype)
    else:
        write_shard_file(outfile, res, spec, F_global, dimensions=())
        from trpx_tpu.parallel.distributed import write_run_manifest

        if pid == 0:
            write_run_manifest(outfile, res, spec, F_global,
                               dtype=frames.dtype)

    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("trpx-shard-written")
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
