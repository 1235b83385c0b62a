"""Frame-parallel TRPX codec over a device mesh.

The reference is strictly single-threaded (SURVEY §2: no threads, no MPI,
no accelerator); the parallel dimension of this framework is specified by
the BASELINE north star, and frames are its natural data-parallel axis —
``f_compress`` is called once per frame with no cross-frame state except the
running ``prolix_bits`` max (Terse.hpp:269,301,516), which is an associative
reduction.

Design (idiomatic JAX, not a translation):

* one ``Mesh`` axis ``"frames"`` spanning every device of every process;
* ``shard_map`` runs the per-frame device encoder on each shard with **zero
  communication in the hot path**;
* the only collective is an ``all_gather`` of the per-frame compressed byte
  counts (the "block-size/frame-size table"), from which every device — and
  every host — derives the absolute byte offset of each of its frames in the
  final archive via one exclusive cumsum. Hosts can then write their shards
  into the output file at those offsets independently and in parallel; the
  resulting archive is byte-identical to the single-process (and reference)
  encoder output by construction.
* decode mirrors it: the (cheap, serial) header walk yields width/offset
  tables host-side; frames then unpack fully parallel across the mesh.

Multi-host execution uses the same code path via ``jax.distributed`` — each
process feeds its local shard of frames; ``dryrun_multichip`` in
``__graft_entry__.py`` validates the sharded compile on N virtual devices.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..format.header import TrpxMeta
from ..format.pycodec import TrpxArchive
from ..format.spec import DEFAULT_BLOCK
from ..ops.coding import (
    FrameSpec,
    decode_batch_device,
    encode_batch_device,
    measured_spec,
    narrow_values,
    walk_archive,
)

AXIS = "frames"


def default_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all available devices (the frame axis)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, (AXIS,))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _encode_sharded_jit(spec: FrameSpec, mesh: Mesh, frames: jax.Array):
    """Sharded encode step: per-frame words + the replicated size table.

    ``frames``: (F, n_padded), F divisible by mesh size, sharded on axis 0.
    Returns (words (F, n_words) sharded, nbytes (F,), prolix_bits scalar,
    overflow scalar) — the last three replicated. Absolute byte offsets
    are derived HOST-side in int64 (``_offsets_from_sizes``): an int32
    device cumsum would silently wrap for archives over 2 GiB.
    """

    def local_encode(frames_local):
        words, bits, maxw, over = encode_batch_device(spec, frames_local)
        nbytes_local = 1 + bits // 8  # Terse.hpp:547 terminal-byte rule
        # the one collective: all-gather the per-frame size table; every
        # device (and every process) then holds the replicated global
        # table, from which each frame's absolute byte offset follows
        sizes = jax.lax.all_gather(nbytes_local, AXIS)  # (ndev, F_local)
        flat = sizes.reshape(-1)  # frame order == shard order (contiguous)
        prolix = jax.lax.pmax(jnp.max(maxw), AXIS)
        overflow = jax.lax.pmax(
            jnp.any(over).astype(jnp.int32), AXIS
        )
        return words, flat, prolix, overflow

    return shard_map(
        local_encode,
        mesh=mesh,
        in_specs=P(AXIS, None),
        out_specs=(P(AXIS, None), P(), P(), P()),
        check_vma=False,
    )(frames)


def _offsets_from_sizes(nbytes: np.ndarray) -> tuple[np.ndarray, int]:
    """Exclusive int64 cumsum of the per-frame byte sizes -> (offsets,
    total). Host-side so >2 GiB archives can't wrap int32."""
    nbytes = np.asarray(nbytes, dtype=np.int64)
    offsets = np.zeros_like(nbytes)
    np.cumsum(nbytes[:-1], out=offsets[1:])
    total = int(offsets[-1] + nbytes[-1]) if nbytes.size else 0
    return offsets, total


@dataclass(frozen=True)
class ShardedCodec:
    """Sharded encode/decode over a fixed mesh + frame geometry."""

    spec: FrameSpec
    mesh: Mesh

    @property
    def ndev(self) -> int:
        return self.mesh.size

    def _shard(self, arr: np.ndarray, spec: P) -> jax.Array:
        return jax.device_put(arr, NamedSharding(self.mesh, spec))

    def _measured(self, x) -> FrameSpec:
        """Measured capacity schedule for this batch (ops/coding.py).

        Safe under sharding: the schedule sizes internal tree buffers
        only — emitted bytes are identical for ANY non-overflowing
        schedule — so even process-local schedules (multi-host
        encode_shards measures only the local shard) preserve
        byte-identity of the assembled archive. Applied regardless of
        the spec's cap_ratio (matching ops.encode's 'measured' default);
        a caller-provided cap_sched is respected as-is."""
        if self.spec.cap_sched is not None:
            return self.spec
        return measured_spec(self.spec, x)

    def pad_frames(self, frames: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad (F, n) to (F', n_padded): F' a multiple of the mesh size,
        values padded with zeros (zero blocks cost 1 header bit each)."""
        F, n = frames.shape
        if n != self.spec.n:
            raise ValueError(f"frames have {n} values, spec says {self.spec.n}")
        Fp = -(-F // self.ndev) * self.ndev
        out = np.zeros((Fp, self.spec.n_padded), dtype=frames.dtype)
        out[:F, : self.spec.n] = frames
        return out, F

    def encode(
        self, frames: np.ndarray, dimensions: tuple[int, ...] = ()
    ) -> TrpxArchive:
        """Encode (F, n) frames mesh-parallel into a byte-exact archive."""
        padded, F = self.pad_frames(frames)
        x = self._shard(padded, P(AXIS, None))
        spec = self._measured(x)
        words, nbytes, prolix, over = jax.device_get(
            _encode_sharded_jit(spec, self.mesh, x)
        )
        if spec.soft and int(over):
            spec = spec.with_ratio(1.0)
            words, nbytes, prolix, over = jax.device_get(
                _encode_sharded_jit(spec, self.mesh, x)
            )
        offsets, _ = _offsets_from_sizes(nbytes)
        return self.assemble(
            words[:F], nbytes[:F], offsets[:F], int(prolix), F, dimensions
        )

    def encode_shards(self, frames_local: np.ndarray, n_frames: int):
        """Multi-host encode step: each process feeds its LOCAL frames and
        gets back its local words plus the replicated global size/offset
        tables (see parallel/distributed.py for the file-writing side).

        ``frames_local``: this process's (F_local, n) slice, in global frame
        order; every process must pass the same F_local (pad the tail host
        with zero frames so F_global = F_local * num_processes).
        ``n_frames``: the real global frame count (un-padded).
        """
        from .distributed import ShardResult

        F_local, n = frames_local.shape
        if n != self.spec.n:
            raise ValueError(f"frames have {n} values, spec says {self.spec.n}")
        try:
            pid, nproc = jax.process_index(), jax.process_count()
        except Exception:
            pid, nproc = 0, 1
        if not (F_local * (nproc - 1) < n_frames <= F_local * nproc):
            raise ValueError(
                f"n_frames={n_frames} inconsistent with F_local={F_local} "
                f"× {nproc} processes (every process must pass the same "
                "F_local; pad the tail host with zero frames)"
            )
        padded = np.zeros((F_local, self.spec.n_padded), frames_local.dtype)
        padded[:, : self.spec.n] = frames_local
        # globally the batch is (F_local * nproc, n_padded), frame-sharded;
        # each process contributes its addressable slice
        global_shape = (F_local * nproc, self.spec.n_padded)
        sharding = NamedSharding(self.mesh, P(AXIS, None))
        ndev_local = max(1, self.ndev // nproc)
        per_dev = -(-F_local // ndev_local)
        arrs = [
            jax.device_put(padded[i * per_dev : (i + 1) * per_dev], d)
            for i, d in enumerate(self.mesh.local_devices)
        ]
        x = jax.make_array_from_single_device_arrays(
            global_shape, sharding, arrs
        )
        # SPMD maxima prepass over the global array: every process
        # derives the SAME measured schedule (and identical bytes hold
        # regardless — see _measured)
        spec = self._measured(x)
        out = _encode_sharded_jit(spec, self.mesh, x)
        if spec.soft and int(jax.device_get(out[3])):
            spec = spec.with_ratio(1.0)
            out = _encode_sharded_jit(spec, self.mesh, x)
        words, nbytes, prolix, _ = out
        # local words: addressable shards in global frame order
        shards = sorted(
            words.addressable_shards, key=lambda s: s.index[0].start or 0
        )
        words_local = np.concatenate([np.asarray(s.data) for s in shards])
        offsets, total = _offsets_from_sizes(jax.device_get(nbytes))
        return ShardResult(
            frame_lo=pid * F_local,
            frame_hi=(pid + 1) * F_local,
            words=words_local,
            nbytes=np.asarray(jax.device_get(nbytes), dtype=np.int64),
            offsets=offsets,
            total_bytes=total,
            prolix_bits=int(jax.device_get(prolix)),
        )

    def assemble(
        self,
        words: np.ndarray,
        nbytes: np.ndarray,
        offsets: np.ndarray,
        prolix_bits: int,
        n_frames: int,
        dimensions: tuple[int, ...] = (),
    ) -> TrpxArchive:
        """Ordered concat of per-frame streams at their absolute offsets."""
        total = int(offsets[n_frames - 1] + nbytes[n_frames - 1])
        payload = np.zeros(total, dtype=np.uint8)
        words = np.ascontiguousarray(words)
        byte_view = words.view(np.uint8).reshape(words.shape[0], -1)
        for f in range(n_frames):
            off, nb = int(offsets[f]), int(nbytes[f])
            payload[off : off + nb] = byte_view[f, :nb]
        meta = TrpxMeta(
            prolix_bits=prolix_bits,
            signed=self.spec.signed,
            block=self.spec.block,
            memory_size=total,
            number_of_values=self.spec.n,
            dimensions=tuple(dimensions),
            number_of_frames=n_frames,
        )
        return TrpxArchive(
            meta=meta, payload=bytes(payload.tobytes()),
            frame_index=np.asarray(offsets[:n_frames], dtype=np.int64),
        )

    # ------------------------------------------------------------ decode ---

    def decode(self, archive: TrpxArchive, dtype) -> np.ndarray:
        """Mesh-parallel decode -> (F, n) array of ``dtype``."""
        dtype = np.dtype(dtype)
        meta = archive.meta
        F = meta.number_of_frames
        Fp = -(-F // self.ndev) * self.ndev
        # serial header walk (SURVEY §7 hard part 3) — native C++ when built
        widths, _poffs, words = walk_archive(archive, self.spec,
                                             pad_frames_to=Fp)
        vals = jax.device_get(
            _decode_sharded_jit(
                self.spec,
                self.mesh,
                self._shard(words, P(AXIS, None)),
                self._shard(widths, P(AXIS, None)),
            )
        )[:F, : meta.number_of_values]
        return narrow_values(vals, dtype)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _decode_sharded_jit(spec, mesh, words, widths):
    def local(words_l, widths_l):
        return decode_batch_device(spec, words_l, widths_l)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS, None)),
        out_specs=P(AXIS, None),
        check_vma=False,
    )(words, widths)


def encode_sharded(
    frames: np.ndarray,
    block: int = DEFAULT_BLOCK,
    dimensions: tuple[int, ...] = (),
    mesh: Mesh | None = None,
) -> TrpxArchive:
    """One-shot sharded encode of (F, n) or (F, h, w) frames."""
    frames = np.asarray(frames)
    if frames.ndim == 3:
        if not dimensions:
            dimensions = (frames.shape[2], frames.shape[1])
        frames = frames.reshape(frames.shape[0], -1)
    mesh = mesh or default_mesh()
    spec = FrameSpec.for_dtype(frames.shape[1], frames.dtype, block,
                               cap_ratio=0.5)
    return ShardedCodec(spec, mesh).encode(frames, dimensions)


def decode_sharded(
    archive: TrpxArchive, dtype, mesh: Mesh | None = None
) -> np.ndarray:
    """One-shot sharded decode -> (F, n)."""
    mesh = mesh or default_mesh()
    meta = archive.meta
    spec = FrameSpec.for_dtype(meta.number_of_values, np.dtype(dtype),
                               meta.block)
    return ShardedCodec(spec, mesh).decode(archive, dtype)
