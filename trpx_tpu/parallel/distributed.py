"""Multi-host runtime: jax.distributed init + per-host shard file writing.

The reference has no distributed anything (SURVEY §2); this is the
BASELINE north-star layer: N hosts × M chips encode disjoint frame ranges,
the per-frame size table is all-gathered on device (parallel/codec.py), and
because every process ends up with the *replicated* offset/total tables,
each host can independently ``pwrite`` its frames' compressed bytes into the
shared output file at their absolute offsets — no host↔host data movement,
byte-identical result to the single-process encoder.

Elastic recovery follows from statelessness: a failed host's frame range is
simply re-encoded (encode has no cross-frame state except the prolix-bits
max, which is a replicated reduction) — see runtime/stream.py for the
frame-manifest resume logic.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..format.header import TrpxMeta, emit_header
from ..format.pycodec import TrpxArchive
from ..ops.coding import FrameSpec


def init_from_env() -> bool:
    """Initialize jax.distributed from the launcher's env vars if present.

    Returns True if a multi-process runtime was initialized. Coordinator
    address, process count and process id come from
    JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID.
    JAX_LOCAL_DEVICE_IDS (comma-separated) pins the process to those
    local devices: a launcher that starts one process per card on a
    multi-card host sets it, since each process would otherwise open —
    and reserve memory on — every card of the host.
    """
    import jax

    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    ids = os.environ.get("JAX_LOCAL_DEVICE_IDS")
    if coord and nproc and pid:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(pid),
            local_device_ids=([int(i) for i in ids.split(",")]
                              if ids else None),
        )
        return True
    return False


@dataclass
class ShardResult:
    """One process's share of a sharded encode, plus replicated tables."""

    frame_lo: int              # first global frame index owned by this host
    frame_hi: int              # one past the last
    words: np.ndarray          # (frame_hi-frame_lo, n_words) uint32
    nbytes: np.ndarray         # (F_global,) replicated per-frame byte counts
    offsets: np.ndarray        # (F_global,) replicated absolute byte offsets
    total_bytes: int           # replicated payload size
    prolix_bits: int           # replicated width max


def meta_for(
    spec: FrameSpec,
    n_frames: int,
    total_bytes: int,
    prolix_bits: int,
    dimensions: tuple[int, ...] = (),
) -> TrpxMeta:
    return TrpxMeta(
        prolix_bits=prolix_bits,
        signed=spec.signed,
        block=spec.block,
        memory_size=total_bytes,
        number_of_values=spec.n,
        dimensions=tuple(dimensions),
        number_of_frames=n_frames,
    )


def write_shard_file(
    path,
    result: ShardResult,
    spec: FrameSpec,
    n_frames: int,
    dimensions: tuple[int, ...] = (),
    is_coordinator: bool | None = None,
) -> None:
    """Write this host's frames into the shared ``.trpx`` file at their
    absolute offsets (coordinator also writes the header).

    All hosts compute the identical header from the replicated tables, so
    the header length — and hence every payload offset — agrees everywhere.
    The file must live on a shared filesystem (or be a local file in
    single-host runs).
    """
    total = _real_total(result, n_frames)
    meta = meta_for(spec, n_frames, total, result.prolix_bits, dimensions)
    header = emit_header(meta)
    if is_coordinator is None:
        try:
            import jax

            is_coordinator = jax.process_index() == 0
        except Exception:
            is_coordinator = True
    size = len(header) + total
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        os.truncate(fd, size)
        if is_coordinator:
            os.pwrite(fd, header, 0)
        words = np.ascontiguousarray(result.words)
        byte_view = words.view(np.uint8).reshape(words.shape[0], -1)
        for i, f in enumerate(range(result.frame_lo,
                                    min(result.frame_hi, n_frames))):
            nb = int(result.nbytes[f])
            os.pwrite(
                fd,
                byte_view[i, :nb].tobytes(),
                len(header) + int(result.offsets[f]),
            )
        os.fsync(fd)
    finally:
        os.close(fd)


def local_archive(
    result: ShardResult,
    spec: FrameSpec,
    n_frames: int,
    dimensions: tuple[int, ...] = (),
) -> TrpxArchive:
    """Assemble a full in-memory archive from a single-host ShardResult
    (requires the process to own all frames)."""
    if not (result.frame_lo == 0 and result.frame_hi >= n_frames):
        raise ValueError("local_archive needs every frame on this host")
    total = _real_total(result, n_frames)
    payload = np.zeros(total, dtype=np.uint8)
    words = np.ascontiguousarray(result.words)
    byte_view = words.view(np.uint8).reshape(words.shape[0], -1)
    for f in range(n_frames):
        off, nb = int(result.offsets[f]), int(result.nbytes[f])
        payload[off : off + nb] = byte_view[f, :nb]
    meta = meta_for(spec, n_frames, total, result.prolix_bits, dimensions)
    return TrpxArchive(meta=meta, payload=bytes(payload.tobytes()))


def _real_total(result: ShardResult, n_frames: int) -> int:
    """Payload size of the REAL frames only — mesh-padding zero frames at
    the tail are excluded so the archive matches the reference byte count."""
    return int(result.offsets[n_frames - 1] + result.nbytes[n_frames - 1])


# ------------------------------------------- streaming x distributed ---


class StreamingShardEncoder:
    """Multi-process CHUNKED encode into one shared ``.trpx`` — the
    composition of the streaming layer (runtime/stream.StreamingEncoder:
    chunked append + manifest resume) with the distributed layer
    (ShardedCodec.encode_shards: collective size tables + per-host
    pwrite). The reference has neither (SURVEY §2/§5).

    Every process feeds its slice of each chunk to :meth:`add_chunk`
    (collective — all processes must call it the same number of times
    with equal local frame counts). The replicated size table places
    each frame's bytes at absolute offsets in the shared ``.part`` file;
    each host pwrites only its own frames. The coordinator checkpoints a
    manifest AFTER a cross-process barrier confirms the chunk's writes
    are durable, so a crash at ANY point loses at most the un-checkpointed
    chunk: re-encoding it is idempotent (same bytes at the same offsets).

    Resume: reconstruct on the same path in every process and restart
    feeding from ``frames_done``. Finalize (coordinator) assembles
    header + payload and removes the temporaries.
    """

    def __init__(self, path, codec, dtype, dimensions: tuple[int, ...] = (),
                 sync_every_chunk: bool = True) -> None:
        from pathlib import Path

        from ..runtime.stream import _Manifest

        self.codec = codec
        self.dtype = np.dtype(dtype)
        self.path = Path(path)
        self.part = self.path.with_name(self.path.name + ".part")
        self.part_idx = self.path.with_name(self.path.name + ".part.idx")
        self.manifest_path = self.path.with_name(self.path.name + ".manifest")
        self.sync_every_chunk = sync_every_chunk
        self.dimensions = tuple(dimensions)
        try:
            import jax

            self.is_coordinator = jax.process_index() == 0
        except Exception:
            self.is_coordinator = True
        spec = codec.spec
        if self.manifest_path.exists():
            m = _Manifest.load(self.manifest_path)
            if (m.dtype, m.nvalues, m.block) != (self.dtype.str, spec.n,
                                                 spec.block):
                raise ValueError(
                    "existing manifest does not match this configuration")
            self.m = m
            if self.is_coordinator:
                # drop torn bytes past the checkpoint (idempotent pwrites
                # will rewrite any re-encoded chunk at the same offsets)
                for p, need in ((self.part, m.payload_bytes),
                                (self.part_idx, 8 * m.frames_done)):
                    if not p.exists() or p.stat().st_size < need:
                        raise FileNotFoundError(
                            f"manifest checkpoints {need} bytes but {p} is "
                            "missing/short; remove the manifest to restart")
        else:
            self.m = _Manifest(
                dtype=self.dtype.str, nvalues=spec.n, block=spec.block,
                signed=spec.signed, dimensions=list(self.dimensions),
                frames_done=0, payload_bytes=0, prolix_bits=0,
            )
            if self.is_coordinator:
                for p in (self.part, self.part_idx):
                    with open(p, "wb"):
                        pass
                self.m.save(self.manifest_path)
        self._barrier("trpx-stream-shard-init")

    def _barrier(self, tag: str) -> None:
        try:
            import jax

            multi = jax.process_count() > 1
        except Exception:  # no distributed runtime: single-process run
            return
        if multi:
            from jax.experimental import multihost_utils

            # barrier FAILURES must raise: checkpointing a chunk whose
            # peers' writes are unconfirmed would let a later resume
            # skip frames that never became durable
            multihost_utils.sync_global_devices(
                f"{tag}-{self.m.frames_done}")

    @property
    def frames_done(self) -> int:
        return self.m.frames_done

    def add_chunk(self, frames_local: np.ndarray, n_frames_chunk: int) -> None:
        """Collective: encode one global chunk (this process contributes
        ``frames_local``, its contiguous slice in global frame order) and
        pwrite this host's frames into the shared part file."""
        res = self.codec.encode_shards(frames_local, n_frames_chunk)
        base = self.m.payload_bytes
        total = _real_total(res, n_frames_chunk)
        words = np.ascontiguousarray(res.words)
        byte_view = words.view(np.uint8).reshape(words.shape[0], -1)
        fd = os.open(self.part, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            for i, f in enumerate(range(res.frame_lo,
                                        min(res.frame_hi, n_frames_chunk))):
                nb = int(res.nbytes[f])
                os.pwrite(fd, byte_view[i, :nb].tobytes(),
                          base + int(res.offsets[f]))
            if self.sync_every_chunk:
                os.fsync(fd)
        finally:
            os.close(fd)
        # every host's bytes must be durable BEFORE the checkpoint claims
        # the chunk done (crash after the barrier re-encodes nothing;
        # crash before it re-encodes the whole chunk idempotently)
        self._barrier("trpx-stream-shard-chunk")
        if self.is_coordinator:
            offs = (base + res.offsets[:n_frames_chunk]).astype("<u8")
            with open(self.part_idx, "r+b") as f:
                f.seek(8 * self.m.frames_done)
                f.write(offs.tobytes())
                if self.sync_every_chunk:
                    f.flush()
                    os.fsync(f.fileno())
        self.m.frames_done += n_frames_chunk
        self.m.payload_bytes += total
        self.m.prolix_bits = max(self.m.prolix_bits, int(res.prolix_bits))
        if self.is_coordinator:
            self.m.save(self.manifest_path)
        self._barrier("trpx-stream-shard-ckpt")

    def meta(self) -> TrpxMeta:
        return meta_for(
            self.codec.spec, self.m.frames_done, self.m.payload_bytes,
            self.m.prolix_bits, tuple(self.m.dimensions))

    def finalize(self):
        """Coordinator: assemble header + payload into ``path`` and drop
        the temporaries; other processes just barrier. Returns the path."""
        self._barrier("trpx-stream-shard-final")
        if self.is_coordinator:
            header = emit_header(self.meta())
            tmp = self.path.with_name(self.path.name + ".tmp")
            with open(tmp, "wb") as out, open(self.part, "rb") as part:
                out.write(header)
                remaining = self.m.payload_bytes
                while remaining:
                    buf = part.read(min(remaining, 1 << 24))
                    if not buf:
                        raise OSError("part file shorter than the manifest")
                    out.write(buf[:remaining])
                    remaining -= min(len(buf), remaining)
                out.flush()
                os.fsync(out.fileno())
            os.replace(tmp, self.path)
            for p in (self.part, self.part_idx, self.manifest_path):
                try:
                    p.unlink()
                except OSError:
                    pass
        self._barrier("trpx-stream-shard-done")
        return self.path


# ------------------------------------------------------- elastic recovery ---


def write_run_manifest(
    path,
    result: ShardResult,
    spec: FrameSpec,
    n_frames: int,
    dimensions: tuple[int, ...] = (),
    dtype=None,
) -> None:
    """Persist the replicated size table next to the shared output file
    (coordinator only, typically). Encode is deterministic and stateless
    per frame, so this manifest is everything a restarted host needs to
    re-encode and re-write its shard WITHOUT any collective — the elastic
    recovery path (SURVEY §5: re-enqueue unfinished frame ranges).

    ``dtype``: the pixel dtype of the original run (stored so recovery
    rebuilds the SAME FrameSpec instead of reverse-engineering a dtype
    from max_width — matching runtime/stream.py's manifest semantics)."""
    import json

    m = {
        "nbytes": [int(v) for v in result.nbytes[:n_frames]],
        "prolix_bits": int(result.prolix_bits),
        "n_frames": int(n_frames),
        "nvalues": int(spec.n),
        "block": int(spec.block),
        "signed": bool(spec.signed),
        "max_width": int(spec.max_width),
        "dimensions": list(dimensions),
    }
    if dtype is not None:
        m["dtype"] = np.dtype(dtype).str
    mp = str(path) + ".runmanifest"
    tmp = mp + ".tmp"
    with open(tmp, "w") as f:
        json.dump(m, f)
    os.replace(tmp, mp)


def recover_shard(path, frames_local: np.ndarray, frame_lo: int) -> None:
    """Re-encode one failed host's frame range and pwrite it into the
    shared file, using only the run manifest (no live collective).

    Raises if the re-encoded per-frame sizes disagree with the manifest —
    that would mean the input frames differ from the original run."""
    import json

    import jax

    from ..ops.coding import FrameSpec as FS
    from ..ops.coding import encode_batch_device

    with open(str(path) + ".runmanifest") as f:
        m = json.load(f)
    if "dtype" in m:
        dtype = np.dtype(m["dtype"])
    else:
        # legacy manifests (no dtype field): reconstruct from max_width
        dtype_bits = m["max_width"] - (1 if m["signed"] else 0)
        dtype = np.dtype(
            ("i" if m["signed"] else "u") + str(max(1, dtype_bits // 8))
        )
    spec = FS.for_dtype(m["nvalues"], dtype, m["block"], cap_ratio=0.5)
    F_local = frames_local.shape[0]
    padded = np.zeros((F_local, spec.n_padded), dtype)
    padded[:, : spec.n] = frames_local
    words, bits, maxw, over = jax.device_get(
        encode_batch_device(spec, padded))
    if spec.soft and bool(np.any(over)):
        words, bits, maxw, over = jax.device_get(
            encode_batch_device(spec.with_ratio(1.0), padded)
        )
    nbytes = 1 + np.asarray(bits, np.int64) // 8
    lo, hi = frame_lo, min(frame_lo + F_local, m["n_frames"])
    expect = np.asarray(m["nbytes"][lo:hi], np.int64)
    if not np.array_equal(nbytes[: hi - lo], expect):
        raise ValueError(
            "re-encoded shard sizes disagree with the run manifest — "
            "input frames differ from the original run"
        )
    offsets = np.zeros(m["n_frames"], np.int64)
    np.cumsum(m["nbytes"][:-1], out=offsets[1:])
    total = int(offsets[-1] + m["nbytes"][-1])
    res = ShardResult(
        frame_lo=lo, frame_hi=lo + F_local, words=np.asarray(words),
        nbytes=np.asarray(m["nbytes"], np.int64), offsets=offsets,
        total_bytes=total, prolix_bits=m["prolix_bits"],
    )
    write_shard_file(
        path, res, spec, m["n_frames"],
        dimensions=tuple(m["dimensions"]), is_coordinator=(lo == 0),
    )
