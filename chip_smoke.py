"""Proof that the TRPX codec runs on an NVIDIA GPU, end to end.

Drives the main path once through the entry points a user calls, at the
full widths the codec supports, and compares every archive byte for byte
with the native host codec (``native.codec``) or the spec-as-code codec
(``format.pycodec``), and every decode pixel for pixel with the frames:

1. ``api.compress`` / ``api.decompress``: 1,024 frames of 512² uint16
   (own archive and a foreign, index-free copy);
2. 2048² (8 frames) and 4096² (4 frames) overflow-heavy uint32 frames;
3. 16 frames of 512² int16 (the signed routes);
4. a fixed palette of shapes through ``ops.encode`` / ``ops.decode``;
5. the CLI in-process: ``terse``, ``prolix``, ``trpx verify``;
6. ``StreamingEncoder`` over four chunks of 256 frames.

``--four-gpus`` runs only the multi-card path and what it is compared with:
four processes, one per card, write one archive with
``StreamingShardEncoder``; then one process encodes and decodes over a
1-D mesh of the four cards with ``ShardedCodec``.

Usage, from the root of a checkout::

    python chip_smoke.py [--seed N]
    python chip_smoke.py --four-gpus [--seed N]

Frames are synthesized from ``--seed``. It exits non-zero, printing no
result, when jax finds no GPU. Its last line is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from bench import card, diffraction_frames

#: (dtype, F, n, block, value kind, seed) — a fixed palette of shapes:
#: partial blocks, block 16, u8/i8, multi-frame 512², the 1M-value and
#: 3.2M-value frames; value kinds as in tools/differential_campaign.py
SMOKE_TRIALS = [
    (np.uint32, 1, 4095, 12, 1, 101),
    (np.int32, 1, 4095, 12, 0, 102),
    (np.uint16, 4, 512 * 512, 12, 0, 103),
    (np.int16, 2, 512 * 512, 12, 1, 104),
    (np.uint32, 1, 3_200_000, 12, 1, 105),
    (np.int32, 1, 3_200_000, 12, 0, 106),
    (np.uint32, 1, 1_048_576, 12, 0, 107),
    (np.uint32, 1, 1_048_576, 12, 2, 108),
    (np.uint8, 3, 144, 12, 3, 109),
    (np.uint16, 2, 1000, 12, 2, 110),
    (np.int16, 2, 1000, 12, 1, 111),
    (np.uint16, 4, 1000, 16, 0, 112),
    (np.int8, 2, 4096, 12, 1, 113),
    (np.uint32, 2, 4096, 12, 1, 114),
    (np.uint32, 1, 3_200_000, 12, 2, 115),
    (np.uint16, 4, 512 * 512, 12, 2, 116),
    (np.uint32, 2, 4096, 12, 3, 117),
    (np.uint16, 2, 512 * 512, 12, 3, 118),
]

#: frames written by each StreamingShardEncoder chunk in --four-gpus mode
SHARD_CHUNK = 256


def _timed(label: str, fn, frames: int, card_name: str, cold: bool = True):
    """Run ``fn`` (twice when ``cold``: the first call compiles) and
    print its wall time, compile time and frames/s. Returns its result."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    if cold:
        t0 = time.perf_counter()
        out = fn()
        warm = time.perf_counter() - t0
        print(f"  {label}: cold {first:.3f} s (compile ~{first - warm:.3f} s)"
              f", warm {warm:.3f} s = {frames / warm:,.1f} frames/s"
              f" [{card_name}]", flush=True)
    else:
        print(f"  {label}: {first:.3f} s = {frames / first:,.1f} frames/s"
              f" [{card_name}]", flush=True)
    return out


def _same_bytes(got: bytes, want: bytes, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: archive bytes differ")


def _same_pixels(got, want, what: str) -> None:
    got = np.asarray(got).reshape(want.shape)
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError(f"{what}: decoded pixels differ")


def phase_api(frames: np.ndarray, card_name: str):
    """Phase 1: api.compress / api.decompress of a 512² uint16 stack."""
    from trpx_tpu import api
    from trpx_tpu.format import pycodec
    from trpx_tpu.native import codec as ncodec

    F = frames.shape[0]
    raw = frames.nbytes
    assert api.route(frames.dtype, raw) == "device", "encode took the host"
    arch = _timed("compress", lambda: api.compress(frames), F, card_name)
    want = ncodec.encode(frames.reshape(F, -1),
                         dimensions=(frames.shape[2], frames.shape[1]))
    _same_bytes(arch.to_bytes(), want.to_bytes(), "api.compress vs native")
    head = pycodec.encode(list(frames[:2].reshape(2, -1))).payload
    _same_bytes(arch.payload[: len(head)], head, "first 2 frames vs pycodec")
    assert api.route(frames.dtype, raw, prolix_bits=arch.meta.prolix_bits) \
        == "device", "decode took the host"
    out = _timed("decompress own", lambda: api.decompress(arch), F, card_name)
    _same_pixels(out, frames, "decompress own")
    blob = arch.to_bytes()
    out = _timed("decompress foreign",
                 lambda: api.decompress(pycodec.TrpxArchive.from_bytes(blob)),
                 F, card_name)
    _same_pixels(out, frames, "decompress foreign")
    return arch


def phase_big(edge: int, F: int, seed: int, card_name: str) -> None:
    """Phase 2: overflow-heavy uint32 frames through the api."""
    from trpx_tpu import api
    from trpx_tpu.native import codec as ncodec

    frames = diffraction_frames(seed, F, edge, np.uint32, 2_000_000_000)
    assert api.route(frames.dtype, frames.nbytes) == "device"
    arch = _timed(f"compress {edge}² u32", lambda: api.compress(frames), F,
                  card_name)
    _same_bytes(arch.to_bytes(),
                ncodec.encode(frames.reshape(F, -1),
                              dimensions=(edge, edge)).to_bytes(),
                f"{edge}² u32 vs native")
    out = _timed(f"decompress {edge}² u32", lambda: api.decompress(arch), F,
                 card_name)
    _same_pixels(out, frames, f"{edge}² u32 decode")


def phase_signed(F: int, seed: int, card_name: str) -> None:
    """Phase 3: pedestal-subtracted int16 512² frames."""
    from trpx_tpu import api
    from trpx_tpu.format import pycodec

    rng = np.random.default_rng(seed)
    frames = (rng.poisson(3.0, (F, 512, 512)) - 3).astype(np.int16)
    frames.reshape(F, -1)[np.repeat(np.arange(F), 200),
                          rng.integers(0, 512 * 512, 200 * F)] = -30000
    assert api.route(frames.dtype, frames.nbytes) == "device"
    arch = _timed("compress 512² i16", lambda: api.compress(frames), F,
                  card_name)
    _same_bytes(arch.to_bytes(),
                pycodec.encode(list(frames.reshape(F, -1)),
                               dimensions=(512, 512)).to_bytes(),
                "512² i16 vs pycodec")
    out = _timed("decompress 512² i16", lambda: api.decompress(arch), F,
                 card_name)
    _same_pixels(out, frames, "512² i16 decode")


def phase_palette(card_name: str) -> None:
    """Phase 4: the fixed shape palette through ops.encode / ops.decode."""
    from tools.differential_campaign import _gen_values
    from trpx_tpu import ops
    from trpx_tpu.format import pycodec

    t0 = time.perf_counter()
    for dt, F, n, block, kind, seed in SMOKE_TRIALS:
        vals = _gen_values(np.dtype(dt), F, n, kind,
                           np.random.default_rng(seed))
        what = f"palette {np.dtype(dt).name} F={F} n={n} block={block}"
        ref = pycodec.encode(list(vals), block=block)
        _same_bytes(ops.encode(vals, block=block).to_bytes(), ref.to_bytes(),
                    what)
        _same_pixels(ops.decode(ref, vals.dtype), vals, what)
    print(f"  palette: {len(SMOKE_TRIALS)} shapes in "
          f"{time.perf_counter() - t0:.3f} s [{card_name}]", flush=True)


def phase_cli(frames: np.ndarray, arch, work: Path, card_name: str) -> None:
    """Phase 5: terse -> prolix -> trpx verify, in this process."""
    from trpx_tpu.cli.main import main, prolix_main, terse_main
    from trpx_tpu.io import read_tiff, write_tiff
    from trpx_tpu.io.trpx import subset_frames

    F = frames.shape[0]
    tif = work / "stack.tif"
    with open(tif, "wb") as f:
        write_tiff(frames, f)
    out = work / "out"
    t0 = time.perf_counter()
    if terse_main([str(tif), "--out-dir", str(out)]) != 0:
        raise AssertionError("terse failed")
    trpx = out / "stack.trpx"
    _same_bytes(trpx.read_bytes(),
                subset_frames(arch, slice(0, F)).to_bytes(),
                "terse vs phase 1")
    back = work / "back"
    if prolix_main([str(trpx), "--out-dir", str(back)]) != 0:
        raise AssertionError("prolix failed")
    _same_pixels(read_tiff(back / "stack.tif").as_array(), frames, "prolix")
    if main(["verify", str(trpx)]) != 0:
        raise AssertionError("trpx verify failed")
    dt = time.perf_counter() - t0
    print(f"  cli terse+prolix+verify: {dt:.3f} s = {F / dt:,.1f} frames/s"
          f" [{card_name}]", flush=True)


def phase_stream(frames: np.ndarray, arch, work: Path, card_name: str):
    """Phase 6: StreamingEncoder over chunks of 256 frames."""
    from trpx_tpu.runtime.stream import StreamingEncoder

    F, h, w = frames.shape
    dst = work / "stream.trpx"

    def run():
        enc = StreamingEncoder(dst, nvalues=h * w, dtype=frames.dtype,
                               dimensions=(w, h), backend="device")
        for lo in range(0, F, 256):
            enc.add_frames(frames[lo : lo + 256].reshape(-1, h * w))
        return enc.finalize(verify=True)

    _timed("StreamingEncoder", run, F, card_name, cold=False)
    _same_bytes(dst.read_bytes(), arch.to_bytes(), "StreamingEncoder")


def one_gpu(seed: int, card_name: str) -> None:
    frames = diffraction_frames(seed, 1024, 512, np.uint16, 60000)
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        print("phase 1: api 1024 x 512² u16", flush=True)
        arch = phase_api(frames, card_name)
        print("phase 2: big u32 frames", flush=True)
        phase_big(2048, 8, seed + 1, card_name)
        phase_big(4096, 4, seed + 2, card_name)
        print("phase 3: signed int16", flush=True)
        phase_signed(16, seed + 3, card_name)
        print("phase 4: shape palette", flush=True)
        phase_palette(card_name)
        print("phase 5: cli", flush=True)
        phase_cli(frames[:16], arch, work, card_name)
        print("phase 6: StreamingEncoder", flush=True)
        phase_stream(frames, arch, work, card_name)


# ------------------------------------------------------------ four GPUs ---


def shard_worker(seed: int, frames_total: int, dst: str) -> None:
    """One of the --four-gpus processes: pinned to its card by
    JAX_LOCAL_DEVICE_IDS, it feeds its slice of each chunk to the shared
    StreamingShardEncoder."""
    import jax

    from trpx_tpu.ops.coding import FrameSpec
    from trpx_tpu.parallel import ShardedCodec, default_mesh
    from trpx_tpu.parallel.distributed import (
        StreamingShardEncoder,
        init_from_env,
    )

    if not init_from_env():
        raise RuntimeError("no distributed launcher environment")
    pid, nproc = jax.process_index(), jax.process_count()
    assert len(jax.local_devices()) == 1, jax.local_devices()
    frames = diffraction_frames(seed, frames_total, 512, np.uint16, 60000)
    frames = frames.reshape(frames_total, -1)
    spec = FrameSpec.for_dtype(frames.shape[1], np.uint16, cap_ratio=0.5)
    enc = StreamingShardEncoder(dst, ShardedCodec(spec, default_mesh()),
                                np.uint16, dimensions=(512, 512))
    per = SHARD_CHUNK // nproc
    for lo in range(0, frames_total, SHARD_CHUNK):
        enc.add_chunk(frames[lo + pid * per : lo + (pid + 1) * per],
                      SHARD_CHUNK)
    enc.finalize()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def four_gpus_streaming(seed: int, frames_total: int, work: Path,
                        nproc: int = 4) -> float:
    """Part (a): ``nproc`` worker processes, one per card, write one
    archive; this process initializes no jax backend until they exit.
    Returns the wall time."""
    from trpx_tpu.native import codec as ncodec

    dst = work / "sharded_stream.trpx"
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for pid in range(nproc):
        env = dict(os.environ,
                   JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES=str(nproc), JAX_PROCESS_ID=str(pid),
                   JAX_LOCAL_DEVICE_IDS=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--shard-worker", "--seed", str(seed),
             "--frames", str(frames_total), "--dst", str(dst)], env=env))
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(rcs):
        raise AssertionError(f"shard workers failed: exit codes {rcs}")
    frames = diffraction_frames(seed, frames_total, 512, np.uint16, 60000)
    want = ncodec.encode(frames.reshape(frames_total, -1),
                         dimensions=(512, 512))
    _same_bytes(dst.read_bytes(), want.to_bytes(),
                "StreamingShardEncoder vs native")
    return wall


def four_gpus_mesh(seed: int, frames_total: int, card_name: str) -> None:
    """Part (b): one process, ShardedCodec over a 1-D mesh of the cards."""
    from trpx_tpu.format import pycodec
    from trpx_tpu.native import codec as ncodec
    from trpx_tpu.ops.coding import FrameSpec
    from trpx_tpu.parallel import ShardedCodec, default_mesh

    frames = diffraction_frames(seed, frames_total, 512, np.uint16, 60000)
    flat = frames.reshape(frames_total, -1)
    codec = ShardedCodec(FrameSpec.for_dtype(flat.shape[1], np.uint16),
                         default_mesh())
    arch = _timed(f"ShardedCodec.encode on {codec.ndev} devices",
                  lambda: codec.encode(flat, dimensions=(512, 512)),
                  frames_total, card_name)
    _same_bytes(arch.to_bytes(),
                ncodec.encode(flat, dimensions=(512, 512)).to_bytes(),
                "ShardedCodec vs native")
    out = _timed("ShardedCodec.decode own", lambda: codec.decode(
        arch, np.uint16), frames_total, card_name)
    _same_pixels(out, flat, "ShardedCodec decode own")
    blob = arch.to_bytes()
    out = _timed("ShardedCodec.decode foreign", lambda: codec.decode(
        pycodec.TrpxArchive.from_bytes(blob), np.uint16), frames_total,
        card_name)
    _same_pixels(out, flat, "ShardedCodec decode foreign")
    print(f"  collectives in the sharded encode: {collectives(codec, flat)}",
          flush=True)
    print("  NCCL kernels in a trace of the sharded encode: "
          f"{nccl_kernels(lambda: codec.encode(flat))}", flush=True)


def nccl_kernels(fn) -> list[str]:
    """Names of the GPU kernels mentioning NCCL in a profiler trace of
    one call of ``fn`` (all device planes' names when there are none)."""
    import glob

    import jax
    from jax.profiler import ProfileData

    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            fn()
        (path,) = glob.glob(f"{td}/**/*.xplane.pb", recursive=True)
        planes = ProfileData.from_file(path).planes
        names = sorted({ev.name.split("(")[0][:80] for pl in planes
                        if pl.name.startswith("/device:")
                        for line in pl.lines for ev in line.events
                        if "nccl" in ev.name.lower()})
        return names or sorted({pl.name for pl in planes})


def collectives(codec, flat: np.ndarray) -> list[str]:
    """Names of the collective operations in the compiled sharded encode
    step (on a GPU, XLA runs these through NCCL)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from trpx_tpu.parallel.codec import AXIS, _encode_sharded_jit

    padded, _ = codec.pad_frames(flat)
    x = jax.device_put(padded,
                       NamedSharding(codec.mesh, PartitionSpec(AXIS, None)))
    spec = codec._measured(x)
    hlo = _encode_sharded_jit.lower(spec, codec.mesh, x).compile().as_text()
    return sorted({tok.split("(")[0] for line in hlo.splitlines()
                   for tok in line.split()
                   if tok.startswith(("all-gather", "all-reduce"))})


def _require_gpu() -> None:
    """Exit with code 2, printing no result, unless jax runs on a GPU."""
    import jax

    from trpx_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py: needs a GPU, jax found {jax.default_backend()}",
              file=sys.stderr)
        sys.exit(2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Run the codec's main path on the GPU and check it.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-card path (needs 4 GPUs)")
    p.add_argument("--shard-worker", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--frames", type=int, default=1024, help=argparse.SUPPRESS)
    p.add_argument("--dst", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.shard_worker:
        shard_worker(args.seed, args.frames, args.dst)
        return 0

    if not args.four_gpus:
        _require_gpu()
    card_name = card()
    if args.four_gpus:
        # four processes take the four cards: this one stays off jax
        # until they have exited
        with tempfile.TemporaryDirectory() as td:
            print("part (a): StreamingShardEncoder, 4 processes x 1 card",
                  flush=True)
            wall = four_gpus_streaming(args.seed, args.frames, Path(td))
            print(f"  4-process stream encode: {wall:.3f} s wall incl. start"
                  f" and compile [{card_name}]", flush=True)
        _require_gpu()
    import jax

    dev = jax.devices()[0]
    print(card_name, flush=True)  # nvidia-smi's name, power.limit
    print(f"device_kind: {dev.device_kind}", flush=True)
    if args.four_gpus:
        if len(jax.devices()) != 4:
            raise AssertionError(f"--four-gpus needs 4 GPUs, jax found "
                                 f"{len(jax.devices())}")
        print("part (b): ShardedCodec over a 1-D mesh of 4 cards", flush=True)
        four_gpus_mesh(args.seed, args.frames, card_name)
    else:
        one_gpu(args.seed, card_name)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
