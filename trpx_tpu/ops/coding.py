"""Device path: vectorized TRPX encode/decode in plain JAX, compiled by XLA
for whatever backend jax runs on (the GPU in production, the CPU in tests).

Design (not a translation of the C++ serial bit loop):

Encode (per frame, all static shapes, runs under ``jit``/``vmap``):
  1. per-block OR-reduce of magnitudes -> significant-bit widths
  2. header bits/values from ``width != prev`` (elementwise)
  3. ragged bit-concat of the per-block strings via the merge-tree pack
     (ops/pack.py) — elementwise/slice work only

Decode: the host header walk yields per-block widths; the split tree
(ops/unpack.py) cuts the stream back into per-block rows and extracts the
values. ``decode_batch_direct`` is the O(n) alternative: payload offsets
from a device cumsum, then every value is an independent gather of two
words + shift/mask.

The serial bitstream of the reference (Bit_pointer.hpp append/get loops,
Terse.hpp:500-549,352-389) is replaced by this offset-table decomposition;
bit-for-bit output equality is property-tested against format/pycodec.py and
the compiled reference binary.

Supported device dtypes: (u)int8/16/32. 64-bit frames take the host codec
(native/, format/pycodec.py): the device tables are 32-bit lanes, and the
reference itself is broken beyond 32 bits (SURVEY B6).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..format.header import TrpxMeta
from ..format.pycodec import TrpxArchive, walk_frame
from ..format.spec import DEFAULT_BLOCK, frame_nbytes

_U32 = jnp.uint32
_I32 = jnp.int32

_DEVICE_DTYPES = {
    np.dtype(np.uint8): (False, 8),
    np.dtype(np.uint16): (False, 16),
    np.dtype(np.uint32): (False, 32),
    np.dtype(np.int8): (True, 9),
    np.dtype(np.int16): (True, 17),
    np.dtype(np.int32): (True, 33),
}


@dataclass(frozen=True)
class FrameSpec:
    """Static (compile-time) description of one frame's encoding problem.

    ``cap_ratio < 1`` turns on the optimistic soft-capacity merge tree
    (ops/pack.py): level buffers are sized for streams compressing to at
    most that fraction of the worst case; overflow is detected on device
    and callers transparently fall back to the ``cap_ratio=1.0`` kernel.
    """

    n: int          # values per frame
    block: int      # values per block
    signed: bool
    max_width: int  # widest possible field for the dtype (incl. sign bit)
    cap_ratio: float = 1.0
    #: MEASURED per-level capacity schedule (words, index = log2(blocks));
    #: when set it overrides the ratio formula — built by
    #: pack.measured_schedule from proven per-level node maxima, so the
    #: merge/split trees carry no worst-case slack the data doesn't need
    cap_sched: tuple[int, ...] | None = None

    @property
    def nb(self) -> int:
        return -(-self.n // self.block)

    @property
    def n_padded(self) -> int:
        return self.nb * self.block

    @property
    def worst_bits(self) -> int:
        return self.n_padded * self.max_width + self.nb * 12

    @property
    def n_words(self) -> int:
        # +2 pad words so decode-side reads of words[W+1] stay in bounds
        return -(-self.worst_bits // 32) + 2

    @property
    def max_block_bits(self) -> int:
        return 12 + self.block * self.max_width

    @property
    def tree_rows(self) -> int:
        p = 1
        while p < self.nb:
            p *= 2
        return p

    @property
    def soft(self) -> bool:
        """Capacities below worst case (ratio < 1 or measured schedule):
        the merge tree clamps level buffers and flags overflow."""
        return self.cap_ratio < 1.0 or self.cap_sched is not None

    @property
    def pack_caps(self) -> tuple[int, ...]:
        from .pack import capacity_schedule, row_capacity

        if self.cap_sched is not None:
            return self.cap_sched
        return tuple(
            capacity_schedule(
                self.tree_rows, row_capacity(self.max_block_bits),
                self.max_block_bits, self.cap_ratio,
            )
        )

    @property
    def out_words(self) -> int:
        """Words in the encode output buffer (soft-capped final row)."""
        return min(self.n_words, self.pack_caps[-1] + 2)

    def with_ratio(self, ratio: float) -> "FrameSpec":
        from dataclasses import replace

        return replace(self, cap_ratio=ratio, cap_sched=None)

    def with_sched(self, sched: tuple[int, ...]) -> "FrameSpec":
        from dataclasses import replace

        return replace(self, cap_sched=tuple(sched))

    @classmethod
    def for_dtype(cls, n: int, dtype, block: int = DEFAULT_BLOCK,
                  cap_ratio: float = 1.0) -> "FrameSpec":
        dtype = np.dtype(dtype)
        if dtype not in _DEVICE_DTYPES:
            raise TypeError(
                f"device path supports (u)int8/16/32, got {dtype}; "
                "use the host codec for 64-bit data"
            )
        signed, max_width = _DEVICE_DTYPES[dtype]
        spec = cls(n=n, block=block, signed=signed, max_width=max_width,
                   cap_ratio=cap_ratio)
        if spec.worst_bits >= 2**31:
            raise ValueError("frame too large for 32-bit bit offsets")
        return spec


def _mask_for(width):
    """(1 << width) - 1 as uint32, saturating at width >= 32."""
    w = jnp.clip(width, 0, 31).astype(_U32)
    m = (_U32(1) << w) - _U32(1)
    return jnp.where(width >= 32, jnp.uint32(0xFFFFFFFF), m)



def plan_frame(spec: FrameSpec, frame: jax.Array):
    """Per-block width/header/offset tables for one frame.

    frame: (n_padded,) int32 (signed dtypes) or uint32-bitcastable int32.
    Returns dict of (nb,) arrays + scalar total_bits.
    """
    nb, B = spec.nb, spec.block
    v = frame.astype(_I32)
    if spec.signed:
        # |v| via negate-select; int32 min wraps to itself and bitcasts to
        # 2**31 as uint32 — exactly the magnitude we need
        mag = jax.lax.bitcast_convert_type(jnp.where(v < 0, -v, v), _U32)
    else:
        mag = jax.lax.bitcast_convert_type(v, _U32)
    setbits = jnp.bitwise_or.reduce(mag.reshape(nb, B), axis=1)
    nz = setbits != 0
    width = jnp.where(nz, _I32(32) - jax.lax.clz(setbits).astype(_I32), _I32(0))
    if spec.signed:
        width = width + nz.astype(_I32)  # one sign bit (Terse.hpp:553-554)

    prev = jnp.concatenate([jnp.zeros((1,), _I32), width[:-1]])
    repeat = width == prev
    hb = jnp.where(
        repeat, 1, jnp.where(width < 7, 4, jnp.where(width < 10, 6, 12))
    ).astype(_I32)
    hv = jnp.where(
        repeat,
        1,
        jnp.where(
            width < 7,
            width << 1,
            jnp.where(
                width < 10,
                (0b111 | ((width - 7) << 3)) << 1,
                (0b11111 | ((width - 10) << 5)) << 1,
            ),
        ),
    ).astype(_U32)

    counts = jnp.clip(spec.n - jnp.arange(nb, dtype=_I32) * B, 0, B)
    block_bits = hb + width * counts
    starts = jnp.concatenate(
        [jnp.zeros((1,), _I32), jnp.cumsum(block_bits)[:-1].astype(_I32)]
    )
    total_bits = starts[-1] + block_bits[-1]
    return dict(
        width=width, hb=hb, hv=hv, counts=counts, starts=starts,
        total_bits=total_bits, mag_or=setbits,
    )


def encode_frame_device(spec: FrameSpec, frame: jax.Array):
    """Encode one padded frame -> (words uint32[spec.out_words], total_bits,
    max_width, overflowed).

    ``frame``: (n_padded,) of the input dtype (padding values must be 0).
    ``overflowed`` is constant False for ``cap_ratio == 1.0``; otherwise
    the caller must discard and re-encode with the full-capacity spec.

    The bitstream is assembled with the merge-tree pack (ops/pack.py).
    """
    from .pack import pack_frame

    B, nb = spec.block, spec.nb
    plan = plan_frame(spec, frame)
    width, hb, hv = plan["width"], plan["hb"], plan["hv"]

    v = frame.astype(_I32).reshape(nb, B)
    u = jax.lax.bitcast_convert_type(v, _U32)
    w2 = width[:, None]
    lo = u & _mask_for(w2)
    # the only >32-bit field is int32's width-33 (sign bit is bit 32)
    hi = (
        ((v < 0) & (w2 == 33)).astype(_U32)
        if spec.max_width > 32
        else None
    )
    words, total_bits, overflow = pack_frame(
        lo, width, hb, hv.astype(_U32), plan["counts"],
        spec.max_block_bits, out_words=spec.out_words, values_hi=hi,
        caps=spec.pack_caps if spec.soft else None,
    )
    return words, total_bits, jnp.max(width), overflow


@functools.partial(jax.jit, static_argnums=0)
def encode_batch_device(spec: FrameSpec, frames: jax.Array):
    """vmap of encode_frame_device over a (F, n_padded) batch."""
    return jax.vmap(lambda f: encode_frame_device(spec, f))(frames)


def _pad_batch(frames: np.ndarray, spec: FrameSpec,
               bucket: bool = True) -> np.ndarray:
    """Zero-pad values to the block grid (``spec.n_padded``) and
    (optionally) the frame count to the next power of two — per-frame
    outputs are independent, so the callers simply ignore the padding
    frames, and jit recompiles are bounded to log2 batch-shape buckets."""
    F = frames.shape[0]
    Fp = F
    if bucket:
        Fp = 1
        while Fp < F:
            Fp *= 2
    out = np.zeros((Fp, spec.n_padded), dtype=frames.dtype)
    out[:F, : spec.n] = frames
    return out


#: default capacity mode: "measured" runs a cheap device prepass that
#: measures per-level node maxima and builds a PROVEN quantized capacity
#: schedule (pack.measured_schedule) — the merge tree carries no slack
#: the batch doesn't need; "auto" picks among the fixed ratio buckets
#: (0.25/0.5/1.0 of worst case); an explicit float keeps the
#: optimistic-with-fallback behavior
DEFAULT_CAP_RATIO = "measured"


def _encode_bucket_jit(spec, padded):
    """Module-level jitted capacity-bucket prepass: the trace cache is
    reused across encode() calls (a per-call jax.jit wrapper would retrace
    every time)."""
    from .pack import encode_bucket_device

    global _ENCODE_BUCKET_FN
    if _ENCODE_BUCKET_FN is None:
        _ENCODE_BUCKET_FN = jax.jit(encode_bucket_device, static_argnums=0)
    return _ENCODE_BUCKET_FN(spec, padded)


_ENCODE_BUCKET_FN = None


def _encode_maxima_jit(spec, padded):
    """Module-level jitted per-level maxima prepass (measured mode)."""
    from .pack import encode_level_maxima

    global _ENCODE_MAXIMA_FN
    if _ENCODE_MAXIMA_FN is None:
        _ENCODE_MAXIMA_FN = jax.jit(encode_level_maxima, static_argnums=0)
    return _ENCODE_MAXIMA_FN(spec, padded)


_ENCODE_MAXIMA_FN = None


def measured_spec(spec: FrameSpec, padded) -> FrameSpec:
    """Return ``spec`` with a PROVEN measured capacity schedule for this
    batch: one device prepass + one small vector fetch (same round-trip
    count as the bucket prepass)."""
    from .pack import measured_schedule, row_capacity

    mx = np.asarray(jax.device_get(_encode_maxima_jit(spec, padded)))
    return spec.with_sched(
        measured_schedule(spec.tree_rows, row_capacity(spec.max_block_bits),
                          spec.max_block_bits, mx)
    )


def encode(
    frames: np.ndarray,
    block: int = DEFAULT_BLOCK,
    dimensions: tuple[int, ...] = (),
    cap_ratio=DEFAULT_CAP_RATIO,
) -> TrpxArchive:
    """Host wrapper: encode frames on the device and assemble a byte-exact
    ``.trpx`` archive.

    ``frames``: (n,) one frame, (F, n) a batch of flat frames, or (F, h, w)
    a stack of images (dimensions inferred). Unlike format.pycodec's
    convenience API, 2-D here always means a batch.
    """
    from .pack import ENCODE_BUCKETS

    frames = np.asarray(frames)
    if frames.ndim == 1:
        frames = frames[None]
    elif frames.ndim == 3:
        if not dimensions:
            dimensions = (frames.shape[2], frames.shape[1])
        frames = frames.reshape(frames.shape[0], -1)
    elif frames.ndim != 2:
        raise ValueError("frames must be 1-D, 2-D (batch) or 3-D (image stack)")
    F, n = frames.shape
    spec = FrameSpec.for_dtype(n, frames.dtype, block)
    run = encode_batch_device
    padded = _pad_batch(frames, spec)
    if cap_ratio in ("auto", "measured") and F <= 8:
        # small batches (the 1-frame CLI case): the prepass's blocking
        # scalar fetch would dominate; go optimistic instead — the
        # overflow flag rides the same device_get as the outputs, so the
        # happy path costs ONE round trip
        cap_ratio = ENCODE_BUCKETS[0]
    if cap_ratio == "measured":
        # one small vector fetch proves a per-level measured schedule;
        # no overflow possible (the schedule is built from these frames)
        spec = measured_spec(spec, padded)
        words, bits, maxw, over = jax.device_get(run(spec, padded))
        if bool(np.any(over[:F])):  # pragma: no cover - proven impossible
            spec = spec.with_ratio(1.0)
            words, bits, maxw, over = jax.device_get(run(spec, padded))
    elif cap_ratio == "auto":
        # one tiny scalar fetch proves the bucket; no overflow possible
        idx = int(jax.device_get(_encode_bucket_jit(spec, padded)))
        ratios = tuple(ENCODE_BUCKETS) + (1.0,)
        spec = spec.with_ratio(ratios[idx])
        words, bits, maxw, over = jax.device_get(run(spec, padded))
    else:
        spec = spec.with_ratio(float(cap_ratio))
        words, bits, maxw, over = jax.device_get(run(spec, padded))
        if spec.soft and bool(np.any(over[:F])):
            # optimistic capacities overflowed (incompressible data):
            # re-encode with the guaranteed worst-case kernel
            spec = spec.with_ratio(1.0)
            words, bits, maxw, over = jax.device_get(run(spec, padded))
    return assemble_archive(spec, words[:F], bits[:F], maxw[:F], dimensions)


def assemble_archive(
    spec: FrameSpec,
    words: np.ndarray,
    bits: np.ndarray,
    maxw: np.ndarray,
    dimensions: tuple[int, ...] = (),
) -> TrpxArchive:
    """Concatenate per-frame word buffers into the final byte stream
    (frames are byte-aligned with a terminal byte each — Terse.hpp:547)."""
    F = words.shape[0]
    nbytes = [frame_nbytes(int(b)) for b in bits]
    total = int(np.sum(nbytes))
    payload = np.zeros(total, dtype=np.uint8)
    pos = 0
    # device_get can hand back non-contiguous arrays
    words = np.ascontiguousarray(words)
    byte_view = words.view(np.uint8).reshape(F, -1)  # little-endian words
    for f in range(F):
        nb_f = nbytes[f]
        payload[pos : pos + nb_f] = byte_view[f, :nb_f]
        pos += nb_f
    meta = TrpxMeta(
        prolix_bits=int(np.max(maxw)),
        signed=spec.signed,
        block=spec.block,
        memory_size=total,
        number_of_values=spec.n,
        dimensions=tuple(dimensions),
        number_of_frames=F,
    )
    # the encoder knows every frame's offset — carry them so decode (and
    # an optional .trpx.idx sidecar) can walk frames in parallel
    offsets = np.zeros(F, dtype=np.int64)
    np.cumsum(nbytes[:-1], out=offsets[1:])
    return TrpxArchive(meta=meta, payload=bytes(payload.tobytes()),
                       frame_index=offsets)


# ---------------------------------------------------------------- decode ---


def narrow_values(vals: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Narrow decoded int32 lanes into the target dtype with the
    reference's CLAMP semantics (Bit_pointer.hpp:747-762: fields wider
    than the target saturate at its range instead of wrapping). Values
    already within range pass through unchanged, so the clip is a no-op
    for the common width <= dtype-bits case."""
    dtype = np.dtype(dtype)
    if vals.dtype == dtype:
        return vals
    if dtype == np.int32:
        return vals
    if dtype.kind == "u":
        u = vals.view(np.uint32)
        if dtype == np.uint32:
            return u
        return np.minimum(u, np.uint32(np.iinfo(dtype).max)).astype(dtype)
    info = np.iinfo(dtype)
    return np.clip(vals, info.min, info.max).astype(dtype)


def decode_frame_device(
    spec: FrameSpec, words: jax.Array, width: jax.Array, poff: jax.Array
):
    """Parallel unpack: (n_words,) uint32 + per-block width/payload-offset
    tables -> (n_padded,) int32 values (sign-extended iff spec.signed)."""
    nb, B = spec.nb, spec.block
    j = jnp.arange(B, dtype=_I32)[None, :]
    w2 = width[:, None]
    off = poff[:, None] + j * w2
    W = off >> 5
    s = (off & 31).astype(_U32)
    lo = words[W]
    hi = words[W + 1]
    u = (lo >> s) | jnp.where(s == 0, _U32(0), (hi << (_U32(31) - s)) << _U32(1))
    u = u & _mask_for(w2)
    if spec.signed:
        # sign-extend w-bit two's complement into the int32 lane. Fields with
        # w >= 32 already fill the lane: for w == 33 (only reachable from
        # int32 data) the low 32 bits ARE the exact int32 pattern, since
        # bit 32 of a 33-bit sign extension of an int32 equals bit 31.
        top = jnp.where(
            w2 > 0, (u >> jnp.clip(w2 - 1, 0, 31).astype(_U32)) & _U32(1), _U32(0)
        )
        ext = jnp.where((w2 < 32) & (top == 1), ~_mask_for(w2), _U32(0))
        u = u | ext
    vals = jax.lax.bitcast_convert_type(u, _I32)
    return vals.reshape(-1)


def decode_frame_tree(spec: FrameSpec, words: jax.Array, widths: jax.Array):
    """Scatter/gather-free unpack of one frame via the split tree
    (ops/unpack.py). ``words``: (n_words,) uint32 of this frame's stream;
    ``widths``: (nb,) int32 from the header walk."""
    from .pack import row_capacity
    from .unpack import (
        extract_values,
        header_bits_from_widths,
        split_stream,
    )

    nb, B = spec.nb, spec.block
    widths = widths.astype(_I32)
    hb = header_bits_from_widths(widths)
    counts = jnp.clip(spec.n - jnp.arange(nb, dtype=_I32) * B, 0, B)
    block_bits = hb + widths * counts
    P = 1
    while P < nb:
        P *= 2
    cap = row_capacity(spec.max_block_bits)
    bb = jnp.concatenate([block_bits, jnp.zeros((P - nb,), _I32)])
    # words may be sized to the actual stream (walk_archive buckets it);
    # the split tree clamps node capacities at that size
    rows_t = split_stream(words, bb, cap,
                          max_block_bits=spec.max_block_bits)[:, :nb]
    lo, _ = extract_values(rows_t, widths, hb, B,
                           max_width=spec.max_width)   # (B, nb)
    w2 = widths[None, :]
    u = lo & _mask_for(w2)
    if spec.signed:
        # sign-extend w-bit two's complement into the int32 lane; for
        # w >= 32 the low 32 bits are already the exact int32 pattern
        top = jnp.where(
            w2 > 0, (u >> jnp.clip(w2 - 1, 0, 31).astype(_U32)) & _U32(1),
            _U32(0),
        )
        ext = jnp.where((w2 < 32) & (top == 1), ~_mask_for(w2), _U32(0))
        u = u | ext
    vals = jax.lax.bitcast_convert_type(u, _I32)     # (B, nb)
    return vals.T.reshape(-1)


@functools.partial(jax.jit, static_argnums=0)
def decode_batch_device(spec: FrameSpec, words, widths):
    """Split-tree decode of a (F, W) uint32 word batch with its (F, nb)
    width tables -> (F, n_padded) int32 values (payload offsets follow
    from the widths)."""
    return jax.vmap(lambda w, wd: decode_frame_tree(spec, w, wd))(
        words, widths
    )


@functools.partial(jax.jit, static_argnums=0)
def decode_batch_direct(spec: FrameSpec, words, widths):
    """Direct O(n) decode, same contract as :func:`decode_batch_device`:
    each block's payload offset is a device cumsum of ``hb + width *
    count`` (header length from the width chain, Terse.hpp:517-535), and
    every value is a two-word gather + shift/mask
    (:func:`decode_frame_device`). Measured against the split tree; not
    a route yet."""
    from .unpack import header_bits_from_widths

    counts = jnp.clip(
        spec.n - jnp.arange(spec.nb, dtype=_I32) * spec.block, 0, spec.block)

    def one(w, wd):
        wd = wd.astype(_I32)
        hb = header_bits_from_widths(wd)
        bits = hb + wd * counts
        starts = jnp.cumsum(bits) - bits
        return decode_frame_device(spec, w, wd, starts + hb)

    return jax.vmap(one)(words, widths)


def block_bits_host(spec: FrameSpec, widths: np.ndarray) -> np.ndarray:
    """Exact per-block bit lengths (host numpy int64) from the walk's
    (F, nb) width tables — header length from the frame-level repeat
    chain (Terse.hpp:517-535) plus width × count payload."""
    B = spec.block
    F, nb = widths.shape
    w = widths.astype(np.int64)
    prev = np.concatenate([np.zeros((F, 1), np.int64), w[:, :-1]], axis=1)
    hb = np.where(w == prev, 1, np.where(w < 7, 4, np.where(w < 10, 6, 12)))
    counts = np.minimum(
        B, np.maximum(0, spec.n - np.arange(nb, dtype=np.int64) * B)
    )[None, :]
    return hb + w * counts                                   # (F, nb)


def _level_maxima(bits: np.ndarray, P: int) -> list[int]:
    """Per-level max node bit-length for N trees of P blocks: level i =
    the largest node of 2^(i+1) blocks (contiguous aligned groups)."""
    N = bits.shape[0]
    node = bits
    cb = 1
    out = []
    while cb < P:
        cb *= 2
        node = node.reshape(N, P // cb, 2).sum(axis=2)
        out.append(int(node.max(initial=0)))
    return out


def _tile_tables(spec: FrameSpec, widths: np.ndarray, Tb: int):
    """Tables from the walk's width tables: per-tile total bits (F, T)
    int64 over tiles of ``Tb`` blocks, and per-level node maxima (list of
    log2(Tb) ints).

    Routed to the native OpenMP helper when available — the numpy
    block_bits -> pad -> reshape-sum -> level-reduce pipeline's int64
    temporaries cost seconds per 2048² batch; the C pass is ~30 ms."""
    try:
        from .. import native

        have = native.available()
    except Exception as e:  # pragma: no cover - environment-dependent
        from .._fallback import warn_once

        warn_once("ops.tile_tables_native", e,
                  "numpy prepass tables (~20x slower)")
        have = False
    if have:
        return native.tile_tables(widths, spec.n, spec.block, Tb)
    F, nb = widths.shape
    T = -(-nb // Tb)
    bits = block_bits_host(spec, widths)                    # (F, nb) int64
    bits_p = bits
    if T * Tb > nb:
        bits_p = np.zeros((F, T * Tb), np.int64)
        bits_p[:, :nb] = bits
    tile_bits = bits_p.reshape(F, T, Tb).sum(axis=2)        # (F, T)
    return tile_bits, _level_maxima(bits_p.reshape(F * T, Tb), Tb)


def validate_tables(spec: FrameSpec, meta, wtab: np.ndarray,
                    starts: np.ndarray, ends: np.ndarray) -> None:
    """Cross-check sidecar v2 tables before trusting them for walk-free
    decode. The sidecar CRC only proves the FILE is intact — a stale
    sidecar (archive re-encoded in place) or a crafted one passes it, so
    the tables themselves must be proven against the header:

    - every width within the header's prolix_bits claim (Terse.hpp:516);
    - frame offsets a contiguous partition of the payload;
    - each frame's byte length EXACTLY the one its width table implies
      (1 + total_bits // 8, the terminal-byte rule of Terse.hpp:547) —
      total bits are fully determined by the widths (header repeat chain
      + width x count), so any inconsistent table fails here.

    Cost: one vectorized pass over the tables (native tile_tables,
    ~ms/GB) — far below the serial walk these tables replace. Raises
    ValueError on any mismatch.
    """
    F = wtab.shape[0]
    if F == 0:
        return
    w = np.asarray(wtab)
    wmax = int(w.max(initial=0)) if w.size else 0
    if wmax > meta.prolix_bits:
        raise ValueError(
            f"sidecar width {wmax} exceeds the header's "
            f"prolix_bits={meta.prolix_bits}")
    if w.dtype.kind == "i" and w.size and int(w.min()) < 0:
        raise ValueError("sidecar width table holds negative widths")
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    sizes = ends - starts
    if (int(starts[0]) != 0 or bool(np.any(sizes <= 0))
            or int(ends[-1]) != meta.memory_size
            or bool(np.any(starts[1:] != ends[:-1]))):
        raise ValueError(
            "sidecar frame offsets are not a contiguous partition of "
            "the payload")
    Tb = min(32768, 1 << max(0, int(spec.nb - 1).bit_length()))
    tb, _lm = _tile_tables(spec, np.ascontiguousarray(w, np.int32), Tb)
    nbytes = 1 + tb.sum(axis=1) // 8
    if not np.array_equal(nbytes, sizes):
        raise ValueError(
            "sidecar width tables disagree with the frame byte ranges "
            "(stale or crafted sidecar)")


def walk_archive(
    archive: TrpxArchive, spec: FrameSpec, pad_frames_to: int | None = None
):
    """Serial decode prepass for a whole archive: per-block width tables,
    frame-relative payload bit offsets, and per-frame uint32 word buffers.

    Uses the native C++ walker when available (trpx_tpu/native), falling
    back to the pure-Python walk. Returns (widths (F', nb) int32,
    poffs (always None — every tree decoder derives offsets from the
    width tables; skipping them drops ~2/3 of the walk's memory traffic),
    words (F', n_words) uint32) where F' is F padded up to
    ``pad_frames_to`` with zero rows.
    """
    meta = archive.meta
    F, nb = meta.number_of_frames, spec.nb
    Fp = pad_frames_to if pad_frames_to is not None else F
    payload = archive.payload
    # np.empty, not zeros: every [:F] row is fully written (walk or v2
    # sidecar), so only the padding rows need the (45 MB/512fr) zeroing
    widths = np.empty((Fp, nb), dtype=np.int32)
    if Fp > F:
        widths[F:] = 0
    poffs = None
    try:
        from .. import native

        have_native = native.available()
    except Exception as e:
        from .._fallback import warn_once

        warn_once("ops.walk_native", e,
                  "pure-Python header walk (~100x slower)")
        have_native = False
    if have_native:
        # the padded uint8 copy of the payload (bit-reader slack) is a
        # full memcpy — cache it on the archive across walks
        buf = getattr(archive, "_padded_buf", None)
        if buf is None:
            buf = native.padded_buffer(payload)
            try:
                archive._padded_buf = buf
            except AttributeError:
                pass
    wtab = getattr(archive, "width_table", None)
    fidx0 = getattr(archive, "frame_index", None)
    if (wtab is not None and fidx0 is not None
            and wtab.shape == (F, nb)):
        # sidecar v2 (io/trpx.py): offsets AND width tables come from
        # the index — but a CRC-valid sidecar can still be stale or
        # crafted, so prove the tables against the header first; on any
        # mismatch distrust BOTH tables and fall back to a real walk
        starts = np.asarray(fidx0, dtype=np.int64)
        ends = np.concatenate([starts[1:], [meta.memory_size]])
        try:
            validate_tables(spec, meta, wtab, starts, ends)
        except ValueError as e:
            from .._fallback import warn_once

            warn_once("ops.sidecar_tables", e,
                      "revalidating header walk")
            wtab = fidx0 = None
    if (wtab is not None and fidx0 is not None
            and wtab.shape == (F, nb)):
        # validated: no header walk at all; the whole prepass is the
        # parallel memcpy gather below
        widths[:F] = wtab
    elif have_native and fidx0 is not None:
        # sidecar/encoder-provided offsets: frames walk in parallel
        fidx = np.asarray(fidx0, dtype=np.int64)
        native.walk_indexed(buf, fidx, meta.number_of_values,
                            meta.block, want_poffs=False,
                            out_widths=widths[:F],
                            max_width=meta.prolix_bits)
        starts = fidx
        ends = np.concatenate([fidx[1:], [meta.memory_size]])
    elif have_native:
        _w, _o, fstarts = native.walk(buf, F, meta.number_of_values,
                                      meta.block, want_poffs=False,
                                      out_widths=widths[:F],
                                      max_width=meta.prolix_bits)
        starts, ends = fstarts[:-1], fstarts[1:]
    else:
        starts = np.zeros(F, dtype=np.int64)
        ends = np.zeros(F, dtype=np.int64)
        pos = 0
        for f in range(F):
            w, o, nxt = walk_frame(payload, pos, meta.number_of_values,
                                   meta.block)
            widths[f] = w
            starts[f], ends[f] = pos, nxt
            pos = nxt
        if F and int(widths[:F].max()) > meta.prolix_bits:
            raise ValueError(
                f"corrupt TRPX payload: block width {int(widths[:F].max())}"
                f" exceeds the header's prolix_bits={meta.prolix_bits}")
    if wtab is None:
        # cache this walk ON the archive (validated widths <= prolix_bits
        # by every branch above): repeated decodes of the same object are
        # walk-free, and the CLI writes the v2 sidecar from this cache
        # instead of re-walking (first-contact foreign archives walk
        # exactly ONCE)
        try:
            archive.width_table = widths[:F].astype(np.uint8)
            if fidx0 is None:
                archive.frame_index = np.asarray(starts, dtype=np.int64)
        except AttributeError:
            pass
    # bucket the per-frame word buffers to the ACTUAL stream size (pow2,
    # bounding recompiles): the split tree clamps its node capacities at
    # this size — the decode analog of the encoder's soft capacities
    max_bytes = int(np.max(ends - starts)) if F else 1
    cap_words = 2
    while cap_words * 4 < max_bytes + 8:
        cap_words *= 2
    cap_words = min(cap_words, spec.n_words)
    if have_native:
        # np.empty: the C gather memcpys each chunk AND memsets the row
        # tail (parallel), so a Python-side zeros() would write the 67
        # MB/512fr buffer twice; only padding rows need explicit zeroing
        words = np.empty((Fp, cap_words), dtype=np.uint32)
        if Fp > F:
            words[F:] = 0
        byte_view = words.view(np.uint8).reshape(Fp, -1)
        native.gather_frames(buf, starts, ends, byte_view)
    else:
        words = np.zeros((Fp, cap_words), dtype=np.uint32)
        byte_view = words.view(np.uint8).reshape(Fp, -1)
        raw = np.frombuffer(payload, dtype=np.uint8)
        for f in range(F):
            chunk = raw[starts[f] : ends[f]]
            byte_view[f, : len(chunk)] = chunk
    return widths, poffs, words


def decode(archive: TrpxArchive, dtype) -> np.ndarray:
    """Host wrapper: header walk (serial, host) + parallel device unpack.
    Returns (F, n) array of ``dtype``."""
    dtype = np.dtype(dtype)
    meta = archive.meta
    spec = FrameSpec.for_dtype(meta.number_of_values, dtype, meta.block)
    if meta.prolix_bits > spec.max_width:
        # stream fields wider than the target spec's lanes/capacities
        # (narrowing beyond capacity+1): the device tree is sized for the
        # TARGET dtype, so route to the host codec, which implements the
        # reference's clamp semantics at C speed (api.decompress already
        # routes these; this guards direct ops.decode calls)
        from .. import native

        if native.available():
            from ..native import codec as ncodec

            return ncodec.decode(archive, dtype)
        from ..format import pycodec as _py

        return _py.decode(archive, dtype)
    F = meta.number_of_frames
    Fp = 1
    while Fp < F:  # bucket the batch shape (bounds jit recompiles)
        Fp *= 2
    widths, _poffs, words = walk_archive(archive, spec, pad_frames_to=Fp)
    out = jax.device_get(decode_batch_device(spec, words, widths))
    return narrow_values(out[:F, : meta.number_of_values], dtype)
