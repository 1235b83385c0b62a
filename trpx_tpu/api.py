"""High-level public API: compress/decompress arrays, device path by default.

This is the surface a reference-library user lands on:

* ``compress(frames)``    ≈ ``jpa::Terse t(frames); t.write(...)``
  (Terse.hpp:249,454) — returns a :class:`TrpxArchive`
* ``decompress(archive)`` ≈ ``t.prolix(out)`` (Terse.hpp:333) — returns
  pixels, with the output dtype chosen the way the ``prolix`` CLI does
  (prolix.cpp:69-92) but with the 32-bit dispatch bug B3 fixed and 64-bit
  streams supported.

Routing (:func:`route`): workloads of a device dtype ((u)int8/16/32) of at
least ``_DEVICE_MIN_BYTES`` are encoded/decoded on the device
(``trpx_tpu.ops``) when jax runs on an accelerator; everything else takes
the host codec (``trpx_tpu.native``, or ``format.pycodec`` without a
compiler). Floats are truncated through int64 exactly like the reference
CLI (terse.cpp:120-123).
"""

from __future__ import annotations

import os

import numpy as np

from .format import pycodec
from .format.header import TrpxMeta
from .format.pycodec import TrpxArchive
from .format.spec import DEFAULT_BLOCK

_DEVICE_KINDS = {
    np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.uint32),
    np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32),
}

#: auto mode (device=None) keeps workloads below this on the host codec
_DEVICE_MIN_BYTES = 4 << 20
#: device decodes beyond this many frames stream through the chunked
#: walk||unpack pipeline (runtime/stream.iter_decode) instead of one
#: whole-archive call: bounds host buffers at O(chunk) and overlaps the
#: serial header walk with device work
_DEVICE_CHUNK_FRAMES = 256



def _accelerator() -> bool:
    """True when jax's default backend is an accelerator, not the CPU."""
    import jax

    return jax.default_backend() != "cpu"


def route(dtype, raw_bytes: int, device: bool | None = None,
          prolix_bits: int | None = None) -> str:
    """The engine that codes a workload: ``"device"`` (the jnp merge/split
    trees of ``trpx_tpu.ops``, compiled by XLA for jax's default backend)
    or ``"host"`` (the native C++ codec; ``format.pycodec`` without a
    compiler).

    ``dtype``: the pixel dtype encoded, or decoded into; ``raw_bytes``:
    the pixels' size. ``prolix_bits`` (decode only): the stream's widest
    field, which the device lanes of ``dtype`` must hold. ``device``
    forces the engine; True raises ValueError on a decode the device
    cannot take. None picks the device only for a device dtype of at
    least ``_DEVICE_MIN_BYTES`` on an accelerator: small workloads finish
    on the host codec in milliseconds, under any device dispatch and
    without an XLA compile per new shape, and on a CPU-only host the
    native codec is far faster than XLA's CPU build of the trees.
    """
    dtype = np.dtype(dtype)
    ok = dtype in _DEVICE_KINDS
    if prolix_bits is not None:
        ok = ok and prolix_bits <= 8 * dtype.itemsize + (dtype.kind == "i")
    if device is None:
        device = ok and raw_bytes >= _DEVICE_MIN_BYTES and _accelerator()
    elif device and prolix_bits is not None and not ok:
        raise ValueError(
            f"device decode unavailable for dtype {dtype} with "
            f"prolix_bits={prolix_bits}"
        )
    return "device" if device else "host"


def _as_stack(frames) -> tuple[np.ndarray, tuple[int, ...]]:
    """Normalize input to (F, n) plus the dimensions attribute tuple."""
    frames = np.asarray(frames)
    dims: tuple[int, ...] = ()
    if frames.ndim == 1:
        frames = frames[None]
    elif frames.ndim == 2:
        # a single image: dimensions = (width, height) (terse.cpp:70-71)
        dims = (frames.shape[1], frames.shape[0])
        frames = frames.reshape(1, -1)
    elif frames.ndim == 3:
        dims = (frames.shape[2], frames.shape[1])
        frames = frames.reshape(frames.shape[0], -1)
    else:
        raise ValueError("frames must be 1-D, 2-D (one image) or 3-D (stack)")
    if frames.shape[0] == 0 or frames.shape[1] == 0:
        # match the normative codec (format/pycodec.py): a degenerate
        # 0-frame/0-value archive is never valid TRPX
        raise ValueError("no frames to encode")
    return frames, dims


def compress(
    frames,
    block: int = DEFAULT_BLOCK,
    dimensions: tuple[int, ...] | None = None,
    device: bool | None = None,
) -> TrpxArchive:
    """Losslessly compress integral frames into a TRPX archive.

    ``frames``: (n,), (h, w) or (F, h, w) array (or nested lists).
    ``dimensions``: overrides the dims stored in the header.
    ``device``: force the device (True) or host (False) path; default
    lets :func:`route` decide.
    """
    frames = np.asarray(frames)
    if frames.dtype.kind == "f":
        # reference CLI truncates float TIFFs through int64 (terse.cpp:120-123)
        frames = frames.astype(np.int64)
    if frames.dtype.kind not in "iu":
        raise TypeError(f"only integral frames are encodable, got {frames.dtype}")
    stack, dims = _as_stack(frames)
    if dimensions is not None:
        dims = tuple(dimensions)
    if route(stack.dtype, stack.nbytes, device) == "device":
        from . import ops  # deferred: jax import is heavy

        return ops.encode(stack, block=block, dimensions=dims)
    return _host_encode(stack, block, dims)


def _host_encode(stack, block, dims) -> TrpxArchive:
    from . import native

    if native.available():
        from .native import codec as ncodec

        return ncodec.encode(stack, block=block, dimensions=dims)
    return pycodec.encode(list(stack), block=block, dimensions=dims)


def output_dtype(meta: TrpxMeta) -> np.dtype:
    """Output pixel dtype the way the prolix CLI picks it (prolix.cpp:69-92),
    with bug B3 fixed (true 32-bit paths) and 64-bit supported."""
    bits = meta.prolix_bits
    if meta.signed:
        if bits <= 16:
            return np.dtype(np.int16)
        if bits <= 32:
            return np.dtype(np.int32)
        return np.dtype(np.int64)
    if bits <= 16:
        return np.dtype(np.uint16)
    if bits <= 32:
        return np.dtype(np.uint32)
    return np.dtype(np.uint64)


def decompress(
    archive: TrpxArchive | bytes | str,
    dtype=None,
    device: bool | None = None,
    frames=None,
) -> np.ndarray:
    """Decode an archive to pixels.

    ``archive`` may be a :class:`TrpxArchive`, the raw ``.trpx`` bytes,
    or a filesystem path (read via :func:`io.trpx.read_trpx`, which also
    attaches any ``.idx`` sidecar — repeat decodes are then walk-free).
    Returns (F, h, w) when the header carries 2-D dimensions, else (F, n);
    single-frame archives are squeezed to (h, w) / (n,).
    ``dtype`` defaults to :func:`output_dtype` of the stream.
    ``frames`` selects a subset to decode — an int (that frame, squeezed),
    slice, or sequence of indices; cost is O(selected frames), not
    O(archive) (frames are byte-aligned and independent, Terse.hpp:505).
    """
    if isinstance(archive, (str, os.PathLike)):
        from .io.trpx import read_trpx

        archive = read_trpx(archive)
    if isinstance(archive, (bytes, bytearray, memoryview)):
        archive = TrpxArchive.from_bytes(bytes(archive))
    if frames is not None:
        from .io.trpx import subset_frames

        archive = subset_frames(archive, frames)
    meta = archive.meta
    dtype = np.dtype(dtype) if dtype is not None else output_dtype(meta)
    if meta.signed and dtype.kind == "u":
        raise TypeError(
            "signed streams must not be decoded into unsigned types "
            "(Terse.hpp:356-357)"
        )
    raw_bytes = (meta.number_of_frames * meta.number_of_values
                 * dtype.itemsize)
    if route(dtype, raw_bytes, device, meta.prolix_bits) == "device":
        if meta.number_of_frames > _DEVICE_CHUNK_FRAMES:
            # big archives stream through the chunked walk||unpack
            # pipeline: O(chunk) host buffers (whole-archive decode
            # pow2-buckets the width tables — 1.4 GB at 10k frames) and
            # the serial header walk of chunk k+1 overlaps the device
            # unpack of chunk k (runtime/stream.iter_decode)
            from .runtime.stream import iter_decode

            # preallocate + copy each chunk into its slice: concatenating
            # the chunk list would transiently hold ~2x the decoded output
            # in host memory
            out = np.empty(
                (meta.number_of_frames, meta.number_of_values), dtype
            )
            lo = 0
            for chunk in iter_decode(archive, dtype,
                                     _DEVICE_CHUNK_FRAMES, device=True):
                out[lo : lo + chunk.shape[0]] = chunk
                lo += chunk.shape[0]
        else:
            from . import ops

            out = ops.decode(archive, dtype)
    else:
        from . import native

        if native.available():
            from .native import codec as ncodec

            out = ncodec.decode(archive, dtype)
        else:
            out = pycodec.decode(archive, dtype)
    if len(meta.dimensions) == 2:
        w, h = meta.dimensions
        if w * h == meta.number_of_values:
            out = out.reshape(meta.number_of_frames, h, w)
    if meta.number_of_frames == 1:
        out = out[0]
    return out
