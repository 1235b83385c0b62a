"""CLI layer: ``terse`` / ``prolix`` (reference-compatible) and ``trpx``.

Flag and file semantics mirror the reference CLIs (terse.cpp:20-104,
prolix.cpp:18-128): positional file arguments, ``-help``, ``-verbose``,
non-matching extensions silently skipped, per-file error recovery, and the
same verbose report (files / user time / IO time / compression rate).

Deliberate divergences (documented in SURVEY §5):

* input files are only deleted when ``--delete-inputs`` is passed — the
  reference deletes unconditionally (terse.cpp:82, prolix.cpp:110) with no
  fsync/rename safety;
* output files are written to a temp name and atomically renamed;
* the 32-bit decode paths are correct (reference bug B3) and 64-bit streams
  are supported rather than refused;
* ``--block``, ``--out-dir``, ``--host`` extensions.

The ``trpx`` umbrella command adds ``info`` and explicit ``encode``/
``decode`` subcommands.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import api
from ..format.pycodec import TrpxArchive
from ..format.spec import DEFAULT_BLOCK
from ..io import read_tiff, write_tiff
from ..io.trpx import read_trpx, write_trpx

_TIF_EXTS = {".tif", ".tiff", ".TIF", ".TIFF"}


def _configure_jax() -> None:
    """Turn on the persistent compilation cache so repeated invocations
    skip XLA compiles (runtime/compile_cache.py)."""
    from ..runtime.compile_cache import enable_compile_cache

    enable_compile_cache()


# The process umask, read ONCE at import (the import lock serializes
# module bodies). os.umask is process-wide state: the read-by-set idiom
# (umask(0) then restore) racing across the --jobs thread pool could
# observe 0 and chmod an output world-writable.
#
# Library-embedding caveat: the import lock only serializes module
# bodies — a non-importing thread of an embedding process that creates
# files during this import window still races the momentary umask(0),
# and umask changes made AFTER import are not picked up by
# _atomic_write. Acceptable for the CLI (imported before the --jobs
# pool exists); embedders who chdir through umasks should not.
_UMASK = os.umask(0)
os.umask(_UMASK)


def _atomic_write(path: Path, writer, durable: bool = True) -> None:
    """Write-to-temp + rename. ``durable=True`` fsyncs before the rename
    — REQUIRED whenever the caller goes on to delete the input (the
    reference deletes with no fsync at all, so a crash can lose data,
    SURVEY §5). Without deletion the input still exists, so callers pass
    durable=False and skip the ~2 ms/file fsync (it dominated the
    many-small-files CLI loop).

    The temp name must be unique per call, not per destination: under
    --jobs two inputs with the same basename and a shared --out-dir
    would otherwise interleave writes into one shared ``.tmp`` and
    os.replace corrupted bytes over the destination."""
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        # mkstemp creates 0600; restore umask-honoring permissions so
        # outputs stay group/world-readable like a plain open() would be
        os.fchmod(fd, 0o666 & ~_UMASK)
        with os.fdopen(fd, "wb") as f:
            writer(f)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("files", nargs="*", help="input files")
    p.add_argument("-verbose", "--verbose", action="store_true",
                   help="print file names, compute times and compression rate")
    p.add_argument("--delete-inputs", action="store_true",
                   help="delete input files after successful conversion "
                        "(the reference always deletes; we require opt-in)")
    p.add_argument("--out-dir", type=Path, default=None,
                   help="write outputs here instead of next to inputs")
    p.add_argument("--block", type=int, default=DEFAULT_BLOCK,
                   help=f"values per block (default {DEFAULT_BLOCK})")
    p.add_argument("--host", action="store_true",
                   help="force the host codec (no device/JAX path)")
    p.add_argument("--stream", action="store_true",
                   help="stream movie stacks through the chunked encoder "
                        "(bounded memory, resumable)")
    p.add_argument("--chunk-frames", type=int, default=256,
                   help="frames per device batch in --stream mode")
    p.add_argument("--index", action="store_true",
                   help="also write a .trpx.idx v2 sidecar (frame offsets"
                        " + width tables: later decodes skip the serial "
                        "header walk entirely). On decode of a foreign "
                        "archive this is the DEFAULT (the sidecar is "
                        "written from the walk the decode already did); "
                        "--no-index opts out")
    p.add_argument("--no-index", action="store_true",
                   help="decode: do not cache a foreign archive's walk "
                        "as a .trpx.idx sidecar")
    p.add_argument("--jobs", type=int, default=1, metavar="N",
                   help="process N files concurrently (thread pool; the "
                        "native codec releases the GIL, so parse/IO of "
                        "one file overlaps the encode of another — for "
                        "the one-.tif-per-frame acquisition pattern)")


def _decode_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--frames", type=str, default=None, metavar="SPEC",
                   help="decode only these frames: '7', 'a:b[:c]' "
                        "(python slice), or '1,3,9' — O(selected), not "
                        "O(archive)")


def _out_path(src: Path, ext: str, out_dir: Path | None) -> Path:
    dst = src.with_suffix(ext)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        dst = out_dir / dst.name
    return dst


def _encode_streaming(src: Path, args) -> tuple[int, int]:
    """--stream path: memory-mapped TIFF -> chunked resumable encoder.
    Returns (raw_bytes, compressed_bytes)."""
    from ..io.tiff import TiffStream
    from ..runtime.stream import StreamingEncoder

    ts = TiffStream(src)
    if not ts.uniform():
        raise ValueError(
            "TIFF file contains a stack of images with varying sizes."
        )
    w, h = ts.dims
    dst = _out_path(src, ".trpx", args.out_dir)
    dtype = ts.infos[0].dtype.newbyteorder("=")
    enc = StreamingEncoder(
        dst, nvalues=w * h, dtype=dtype, block=args.block, dimensions=(w, h),
        backend=api.route(dtype, sum(i.nbytes for i in ts.infos),
                          device=False if args.host else None))
    start = enc.frames_done  # resume point if a manifest exists
    for lo in range(start, len(ts), args.chunk_frames):
        chunk = ts.read(lo, min(len(ts), lo + args.chunk_frames))
        enc.add_frames(chunk.reshape(chunk.shape[0], -1))
    # --index previously vanished on the --stream path (finalize was
    # called without it); verify and index now share one walk
    enc.finalize(verify=True, index=bool(getattr(args, "index", False)))
    raw = sum(i.nbytes for i in ts.infos)
    comp = dst.stat().st_size
    ts.close()
    return raw, comp


def _encode_one(src: Path, args, device) -> tuple[int, int, float, float]:
    """Encode ONE .tif -> .trpx; returns (raw, comp, user_s, io_s).
    Thread-safe: pure function of the file + args (the native codec
    releases the GIL, so a --jobs pool overlaps parse and encode)."""
    t0 = time.perf_counter()
    stack = read_tiff(src)
    t1 = time.perf_counter()
    if not stack.uniform():
        if len({im.shape for im in stack}) == 1:
            # mixed-dtype stack: regularize to a lossless common
            # type (Grey_tif<T>::f_regularize parity,
            # Grey_tif.hpp:627-673; see COMPONENTS.md ledger)
            stack.regularize()
        else:
            raise ValueError(
                "TIFF file contains a stack of images with varying sizes."
            )
    frames = stack.as_array()
    archive = api.compress(
        frames, block=args.block,
        dimensions=stack.dims, device=device,
    )
    t2 = time.perf_counter()
    dst = _out_path(src, ".trpx", args.out_dir)
    _atomic_write(dst, lambda f: write_trpx(archive, f),
                  durable=args.delete_inputs)
    if args.index:
        from ..io.trpx import _compute_offsets, write_index

        # one walk serves offsets AND the v2 width tables, so
        # decodes of this file skip the header walk entirely
        offs, wt = _compute_offsets(archive)
        write_index(dst, offs, archive.meta.memory_size, widths=wt)
    t3 = time.perf_counter()
    if args.delete_inputs:
        print(f"Deleting original TIFF file: {src}")
        src.unlink()
    return (frames.nbytes, archive.meta.memory_size,
            t2 - t1, (t1 - t0) + (t3 - t2))


def _warn_jobs_stream(args) -> None:
    """--jobs applies to the per-file pool only; --stream pipelines one
    file's frames (read/encode/write already overlap) and runs files
    serially. Say so rather than silently dropping the flag."""
    if int(getattr(args, "jobs", 1) or 1) > 1:
        print("note: --jobs has no effect with --stream "
              "(files are pipelined one at a time)", file=sys.stderr)


def _run_per_file(names, args, one):
    """Run ``one(src)`` per eligible file — serially, or on a --jobs
    thread pool (per-file error recovery either way, terse.cpp:88-90).
    Returns (done_names, totals list)."""
    done, results = [], []
    jobs = max(1, int(getattr(args, "jobs", 1) or 1))

    def guarded(name):
        try:
            return name, one(Path(name)), None
        except Exception as e:
            return name, None, e

    if jobs == 1:
        outs = map(guarded, names)
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=jobs) as pool:
            outs = list(pool.map(guarded, names))
    for name, res, err in outs:
        if err is not None:
            print(f"Error processing {name}: {err}", file=sys.stderr)
        else:
            done.append(name)
            results.append(res)
    return done, results


def _encode_files(args) -> int:
    user_time = io_time = 0.0
    total_tif = total_trpx = 0
    n_done = 0
    done_names: list[str] = []
    device = False if args.host else None
    if not args.host:
        _configure_jax()
    names = [n for n in args.files
             if Path(n).is_file() and Path(n).suffix in _TIF_EXTS]
    # (non-matching args silently skipped — terse.cpp:45-48)
    if args.stream:
        _warn_jobs_stream(args)
        for name in names:
            src = Path(name)
            try:
                t0 = time.perf_counter()
                raw, comp = _encode_streaming(src, args)
                total_tif += raw
                total_trpx += comp
                user_time += time.perf_counter() - t0
                if args.delete_inputs:
                    print(f"Deleting original TIFF file: {src}")
                    src.unlink()
                n_done += 1
                done_names.append(name)
            except Exception as e:  # per-file recovery (terse.cpp:88-90)
                print(f"Error processing {src}: {e}", file=sys.stderr)
    else:
        done_names, results = _run_per_file(
            names, args, lambda src: _encode_one(src, args, device))
        n_done = len(done_names)
        for raw, comp, user_s, io_s in results:
            total_tif += raw
            total_trpx += comp
            user_time += user_s
            io_time += io_s
    if args.verbose:
        # only files actually processed, matching the reference's verbose
        # report (terse.cpp:94-102 prints per successfully converted file)
        for name in done_names:
            print(f"Compressed: {name}")
        print(f"Terse compressed: {n_done} files")
        print(f"User time       : {user_time:g} seconds")
        print(f"IO time         : {io_time:g} seconds")
        if total_tif > 0:
            rate = round(1000 * (1 - total_trpx / total_tif)) / 10
            print(f"Compression rate: {rate}%")
    return 0


def _parse_frames(spec: str):
    """CLI frame selection: '7' | 'a:b[:c]' (python slice) | '1,3,9'."""
    if ":" in spec:
        parts = [int(t) if t else None for t in spec.split(":")]
        if len(parts) > 3:
            raise ValueError(f"bad --frames spec {spec!r}")
        return slice(*parts)
    if "," in spec:
        return [int(t) for t in spec.split(",") if t]
    return int(spec)


def _decode_streaming(src: Path, args, sel) -> None:
    """--stream decode: chunked frame-range decode -> incremental TIFF
    writer; memory stays O(chunk) on the pixel side (the compressed
    payload is held in memory — ~5x smaller than the output)."""
    from ..io.tiff import TiffWriter, needs_bigtiff
    from ..io.trpx import subset_frames

    archive = read_trpx(src)
    if sel is not None:
        archive = subset_frames(archive, sel)
    meta = archive.meta
    if len(meta.dimensions) >= 2:
        w, h = meta.dimensions[0], meta.dimensions[1]
    else:
        w = h = int(math.isqrt(meta.number_of_values))
    device = False if args.host else None
    F = meta.number_of_frames
    dst = _out_path(src, ".tif", args.out_dir)
    # decoded size is known up front from the archive metadata; switch to
    # BigTIFF (64-bit offsets) when classic TIFF's 4 GiB cap would trip
    itemsize = api.output_dtype(meta).itemsize
    pixel_bytes = F * meta.number_of_values * itemsize

    def _write_chunks(f) -> None:
        wtr = TiffWriter(f, bigtiff=needs_bigtiff(pixel_bytes, F))
        for lo in range(0, F, args.chunk_frames):
            hi = min(F, lo + args.chunk_frames)
            pix = api.decompress(archive, device=device,
                                 frames=slice(lo, hi))
            wtr.append(np.asarray(pix).reshape(hi - lo, h, w))

    _atomic_write(dst, _write_chunks, durable=True)


def _decode_files(args) -> int:
    user_time = io_time = 0.0
    n_done = 0
    try:
        sel = (_parse_frames(args.frames)
               if getattr(args, "frames", None) else None)
    except ValueError as e:
        print(f"error: bad --frames spec: {e}", file=sys.stderr)
        return 2
    device = False if args.host else None
    if not args.host:
        _configure_jax()
    names = [n for n in args.files
             if Path(n).is_file() and Path(n).suffix == ".trpx"]
    if args.stream:
        _warn_jobs_stream(args)
        for name in names:
            src = Path(name)
            try:
                t0 = time.perf_counter()
                _decode_streaming(src, args, sel)
                user_time += time.perf_counter() - t0
                if args.delete_inputs:
                    print(f"Deleting trpx file: {src}")
                    src.unlink()
                n_done += 1
            except Exception as e:
                print(f"Error processing {src}: {e}", file=sys.stderr)
    else:
        def one(src: Path):
            t0 = time.perf_counter()
            archive = read_trpx(src)
            t1 = time.perf_counter()
            meta = archive.meta
            if len(meta.dimensions) >= 2:
                w, h = meta.dimensions[0], meta.dimensions[1]
            else:
                # square fallback (prolix.cpp:62-63)
                w = h = int(math.isqrt(meta.number_of_values))
            had_sidecar = getattr(archive, "width_table", None) is not None
            pixels = api.decompress(archive, device=device, frames=sel)
            pixels = pixels.reshape(-1, h, w)
            t2 = time.perf_counter()
            want_index = args.index or (
                not getattr(args, "no_index", False)
                and sel is None          # subset decodes don't walk it all
                and not args.delete_inputs   # file is about to vanish
            )
            if want_index and not had_sidecar:
                # cache the walk of a foreign archive as a v2 sidecar —
                # BY DEFAULT: every later decode of this file is then
                # walk-free. The decode's own walk is reused when the
                # device path cached it on the archive (walk_archive);
                # otherwise one native walk builds the tables.
                from ..io.trpx import _compute_offsets, write_index

                offs = getattr(archive, "frame_index", None)
                wt = getattr(archive, "width_table", None)
                if offs is None or wt is None:
                    offs, wt = _compute_offsets(archive)
                try:
                    write_index(src, offs, meta.memory_size, widths=wt)
                except OSError as e:  # read-only dir: sidecar is optional
                    print(f"note: could not write sidecar for {src}: {e}",
                          file=sys.stderr)
            _atomic_write(_out_path(src, ".tif", args.out_dir),
                          lambda f: write_tiff(pixels, f),
                          durable=args.delete_inputs)
            t3 = time.perf_counter()
            if args.delete_inputs:
                print(f"Deleting trpx file: {src}")
                src.unlink()
            return t2 - t1, (t1 - t0) + (t3 - t2)

        done_names, results = _run_per_file(names, args, one)
        n_done = len(done_names)
        for user_s, io_s in results:
            user_time += user_s
            io_time += io_s
    if args.verbose:
        print(f"Prolix expanded: {n_done} files")
        print(f"User time      : {user_time:g} seconds")
        print(f"IO time        : {io_time:g} seconds")
    return 0


def _info_files(args) -> int:
    for name in args.files:
        meta = read_trpx(Path(name)).meta
        raw = meta.number_of_values * meta.number_of_frames * (
            2 if meta.prolix_bits <= 16 else (4 if meta.prolix_bits <= 32 else 8)
        )
        print(f"{name}:")
        print(f"  frames           {meta.number_of_frames}")
        print(f"  values/frame     {meta.number_of_values}")
        print(f"  dimensions       {' '.join(map(str, meta.dimensions)) or '-'}")
        print(f"  signed           {int(meta.signed)}")
        print(f"  prolix_bits      {meta.prolix_bits}")
        print(f"  block            {meta.block}")
        print(f"  payload bytes    {meta.memory_size}")
        print(f"  compression      {meta.memory_size / raw:.4f} of raw")
    return 0


def _verify_files(args) -> int:
    """``trpx verify``: archive integrity check, entirely host-side (no
    JAX initialization) — header validation, a full validating header
    walk (structural bounds + width-over-claim), cross-check of any
    sidecar against that walk, and a chunked complete decode with O(chunk)
    pixel memory. Exits nonzero if any file fails."""
    from ..io.trpx import _compute_offsets, _idx_path, read_index_full

    bad = 0
    for name in args.files:
        src = Path(name)
        try:
            archive = read_trpx(src)
            meta = archive.meta
            # force a validating walk even when a v2 sidecar would skip
            # it: verification is exactly the time to distrust caches
            plain = type(archive)(meta=meta, payload=archive.payload)
            offs, widths = _compute_offsets(plain)
            wmax = int(widths.max()) if widths.size else 0
            # sidecar three-state: absent / matches the walk / FAILED
            # (corrupt, stale, or disagreeing tables all fail — an
            # integrity checker must not silently shrug off a bad .idx)
            sidecar = "none"
            idx_p = _idx_path(src)
            if idx_p.exists():
                s_offs, s_wt = read_index_full(
                    src, meta.number_of_frames, meta.memory_size)
                if s_offs is None:
                    raise ValueError(
                        f"sidecar {idx_p.name} is corrupt or stale "
                        f"(decode ignores it; regenerate with "
                        f"'trpx decode --index' or delete it)")
                if not np.array_equal(np.asarray(s_offs), offs):
                    raise ValueError(f"sidecar {idx_p.name} frame offsets "
                                     f"disagree with the walked archive")
                sidecar = "v1, matches walk"
                if s_wt is not None:
                    if not np.array_equal(s_wt, widths):
                        raise ValueError(
                            f"sidecar {idx_p.name} width tables disagree "
                            f"with the walked archive")
                    sidecar = "v2, matches walk"
            # chunked full decode (host codec): bounded memory even for
            # multi-GB archives; the walk above is trusted, so attach it
            plain.frame_index = offs
            plain.width_table = widths
            F = meta.number_of_frames
            itemsize = api.output_dtype(meta).itemsize
            chunk = max(1, min(F, (1 << 28)
                               // max(1, meta.number_of_values * itemsize)))
            nbytes = 0
            for lo in range(0, F, chunk):
                px = api.decompress(plain, device=False,
                                    frames=slice(lo, min(F, lo + chunk)))
                nbytes += np.asarray(px).nbytes
            print(f"{name}: OK — {meta.number_of_frames} frames x "
                  f"{meta.number_of_values} values, widths <= {wmax} "
                  f"(prolix_bits={meta.prolix_bits}), sidecar {sidecar}, "
                  f"decoded {nbytes / 1e6:.1f} MB")
        except Exception as e:
            print(f"{name}: FAILED — {e}", file=sys.stderr)
            bad += 1
    return 1 if bad else 0


def terse_main(argv=None) -> int:
    """``terse`` — compress .tif/.tiff files to .trpx (terse.cpp:20)."""
    p = argparse.ArgumentParser(
        prog="terse", add_help=False,
        description="compresses all files with .tiff or .tif extensions to "
                    "terse files with .trpx extensions.",
    )
    p.add_argument("-help", "--help", action="help", help="print help")
    _common_flags(p)
    return _encode_files(p.parse_args(argv))


def prolix_main(argv=None) -> int:
    """``prolix`` — expand .trpx files to .tif (prolix.cpp:18)."""
    p = argparse.ArgumentParser(
        prog="prolix", add_help=False,
        description="expands trpx files to tiff files.",
    )
    p.add_argument("-help", "--help", action="help", help="print help")
    _common_flags(p)
    _decode_flags(p)
    return _decode_files(p.parse_args(argv))



def _concat_files(args) -> int:
    """``trpx concat``: merge archives frame-wise into one, without
    re-encoding — frame streams are independent and byte-aligned, so the
    output is bit-identical to a whole-stack encode
    (format/pycodec.concat_archives; Terse.hpp:505,547 semantics)."""
    from ..format.pycodec import concat_archives

    try:
        parts = [read_trpx(Path(name)) for name in args.files]
        merged = concat_archives(*parts)
    except (ValueError, OSError) as e:
        print(f"trpx concat: {e}", file=sys.stderr)
        return 1
    dst = Path(args.output)
    _atomic_write(dst, lambda f: write_trpx(merged, f), durable=False)
    if args.index:
        from ..io.trpx import _compute_offsets, write_index

        offs, wt = _compute_offsets(merged)  # one validating walk
        write_index(dst, offs, merged.meta.memory_size, widths=wt)
    if args.verbose:
        print(f"Concatenated {len(parts)} archives -> {dst} "
              f"({merged.meta.number_of_frames} frames, "
              f"{merged.meta.memory_size} payload bytes)")
    return 0


def main(argv=None) -> int:
    """``trpx`` — umbrella command: encode / decode / info."""
    p = argparse.ArgumentParser(prog="trpx",
                                description="TRPX codec")
    sub = p.add_subparsers(dest="cmd", required=True)
    enc = sub.add_parser("encode", help="compress TIFF files to .trpx")
    _common_flags(enc)
    enc.set_defaults(fn=_encode_files)
    dec = sub.add_parser("decode", help="expand .trpx files to TIFF")
    _common_flags(dec)
    _decode_flags(dec)
    dec.set_defaults(fn=_decode_files)
    info = sub.add_parser("info", help="print .trpx header metadata")
    info.add_argument("files", nargs="+")
    info.set_defaults(fn=_info_files)
    ver = sub.add_parser(
        "verify", help="check archive integrity (walk + full decode)"
    )
    ver.add_argument("files", nargs="+")
    ver.set_defaults(fn=_verify_files)
    cat = sub.add_parser(
        "concat", help="merge .trpx archives frame-wise (no re-encode)"
    )
    cat.add_argument("output", help="destination .trpx")
    cat.add_argument("files", nargs="+", help="input .trpx archives, in order")
    cat.add_argument("--index", action="store_true",
                     help="also write the .trpx.idx sidecar")
    cat.add_argument("-verbose", "--verbose", action="store_true")
    cat.set_defaults(fn=_concat_files)
    bench = sub.add_parser(
        "bench", help="measure codec throughput on this machine's devices"
    )
    bench.add_argument("--frames", type=int, default=64)
    bench.add_argument("--size", type=int, default=512,
                       help="square frame edge (default 512)")
    bench.add_argument("--profile", type=str, default=None, metavar="DIR",
                       help="write a jax.profiler trace to DIR")
    bench.add_argument("--e2e", action="store_true",
                       help="also time the full TIFF->.trpx pipeline on a "
                            "real file (read + encode + write, overlapped "
                            "via the streaming encoder)")
    bench.add_argument("--chunk-frames", type=int, default=64,
                       help="frames per device batch in --e2e mode")
    bench.set_defaults(fn=_bench)
    args = p.parse_args(argv)
    return args.fn(args)


def _bench(args) -> int:
    """Structured throughput report (runtime.metrics.RunReport)."""
    import jax

    from .. import api
    from ..runtime.metrics import RunReport, StageTimer, profiler_trace

    _configure_jax()
    rng = np.random.default_rng(0)
    h = w = args.size
    frames = rng.poisson(3.0, size=(args.frames, h, w)).astype(np.uint16)
    frames.reshape(args.frames, -1)[
        rng.integers(0, args.frames, 200 * args.frames),
        rng.integers(0, h * w, 200 * args.frames),
    ] = 60000
    api.compress(frames[:1])  # warm the compile cache

    dev = jax.devices()[0]
    t = StageTimer()
    with profiler_trace(args.profile):
        with t.stage("encode"):
            archive = api.compress(frames)
        with t.stage("decode"):
            out = api.decompress(archive)
    assert np.array_equal(out.reshape(frames.shape), frames)
    report = RunReport(
        operation="encode+decode",
        frames=args.frames,
        raw_bytes=frames.nbytes,
        compressed_bytes=archive.meta.memory_size,
        device_kind=getattr(dev, "device_kind", ""),
        n_devices=1,
        stage_seconds=t.seconds,
    )
    print(report.summary())
    print(report.to_json())
    if args.e2e:
        _bench_e2e(args, frames)
    return 0


def _bench_e2e(args, frames) -> None:
    """End-to-end TIFF -> .trpx wall time on a real file (the reference
    CLI's whole pipeline is end-to-end, terse.cpp:94-102): memory-mapped
    TIFF read + double-buffered streaming device encode + payload write."""
    import tempfile

    from ..io.tiff import TiffStream
    from ..runtime.stream import StreamingEncoder

    h = w = args.size
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "stack.tif"
        with open(src, "wb") as f:
            write_tiff(frames, f)
        dst = Path(td) / "stack.trpx"
        t0 = time.perf_counter()
        ts = TiffStream(src)
        enc = StreamingEncoder(
            dst, nvalues=w * h,
            dtype=ts.infos[0].dtype.newbyteorder("="),
            dimensions=(w, h), sync_every_chunk=False,
            backend=api.route(frames.dtype, frames.nbytes))
        for lo in range(0, len(ts), args.chunk_frames):
            chunk = ts.read(lo, min(len(ts), lo + args.chunk_frames))
            enc.add_frames(chunk.reshape(chunk.shape[0], -1))
        enc.finalize()
        e2e = time.perf_counter() - t0
        comp = dst.stat().st_size
        fps = args.frames / e2e
        gbs = frames.nbytes / e2e / 1e9
        print(f"e2e TIFF->trpx : {fps:,.1f} frames/s ({gbs:.2f} GB/s raw "
              f"in, {e2e:.3f} s wall, {1 - comp / frames.nbytes:.1%} "
              "reduction)")

        # decode direction: .trpx -> pixels via the pipelined chunked
        # decoder (host walk of chunk k+1 overlaps device unpack of k)
        from ..io.trpx import read_trpx
        from ..runtime.stream import iter_decode

        t0 = time.perf_counter()
        arch = read_trpx(dst)
        got = 0
        for chunk in iter_decode(arch, frames.dtype,
                                 chunk_frames=args.chunk_frames):
            got += chunk.shape[0]
        e2d = time.perf_counter() - t0
        assert got == args.frames
        print(f"e2e trpx->pixels: {args.frames / e2d:,.1f} frames/s "
              f"({frames.nbytes / e2d / 1e9:.2f} GB/s raw out, "
              f"{e2d:.3f} s wall, pipelined walk+unpack)")


if __name__ == "__main__":
    sys.exit(main())
