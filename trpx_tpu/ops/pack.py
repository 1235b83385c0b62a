"""Scatter-free ragged bit-concat: the device path's packing primitive.

The TRPX bitstream is a concatenation of ~21k variable-length per-block
bit strings per frame (header + packed values, SURVEY §2.1). The codebase
was first written for a device whose scatter serialized, so instead of
scattering every field this module builds the stream with a **binary
merge tree** (the direct prefix-sum + scatter-add form, SURVEY §7, is the
candidate to replace it on the GPU — ROADMAP G2):

  level 0: every block is a fixed-capacity word row ``(P, C0)`` holding its
           header+payload bits starting at bit 0, plus its bit length;
  level L: pairs of rows are concatenated — ``R = A | (B << len(A))`` —
           where ``<< len(A)`` decomposes into a *word* rotation (binary
           lifting over the bits of ``len(A) >> 5``, each step a static
           pad-and-slice select) and a *bit* funnel shift (elementwise);
  after log2(P) levels one row holds the whole frame bitstream.

Everything is static-shaped, elementwise, and fusible — no scatter, no
gather, no data-dependent control flow. Work is O(P * C0 * log P) word ops
per frame, independent of the data.

Capacities are exact powers of two: a level-L row holds up to
``C0 * 2**L`` words and a string of at most ``C0 * 2**L * 32 - 31`` bits,
which dominates the worst case ``2**L * max_block_bits`` provided
``C0 * 32 >= max_block_bits + 31``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_I32 = jnp.int32


def row_capacity(max_block_bits: int) -> int:
    """Smallest power-of-two word capacity for one block's staged row."""
    c = -(-(max_block_bits + 31) // 32)
    p = 1
    while p < c:
        p *= 2
    return p


#: switch from transposed (C, P) to row-major (P, C) orientation once rows
#: reach this many words — below it, the word axis is too narrow to be
#: the minor (contiguous) axis, so the big axis (P) rides it instead
_LANES = 128


def _funnel_up(rows: jax.Array, s: jax.Array) -> jax.Array:
    """Shift each row's bitstring towards higher bit positions by
    ``s in [0, 32)`` bits (LSB-first streams: bit p lives at word p>>5,
    bit p&31). rows: (P, C) uint32; s: (P,) uint32."""
    s = s[:, None].astype(_U32)
    prev = jnp.concatenate(
        [jnp.zeros((rows.shape[0], 1), _U32), rows[:, :-1]], axis=1
    )
    # (prev >> (32 - s)) with a well-defined 0 at s == 0
    carry = (prev >> (_U32(31) - s)) >> _U32(1)
    return (rows << s) | carry


def _funnel_up_t(rows_t: jax.Array, s: jax.Array) -> jax.Array:
    """Transposed funnel: rows_t (C, P), s (P,). Word axis is axis 0."""
    s = s[None, :].astype(_U32)
    prev = jnp.concatenate(
        [jnp.zeros((1, rows_t.shape[1]), _U32), rows_t[:-1]], axis=0
    )
    carry = (prev >> (_U32(31) - s)) >> _U32(1)
    return (rows_t << s) | carry


def _word_shift_up(rows: jax.Array, k: jax.Array, max_shift: int) -> jax.Array:
    """Shift each row by ``k`` whole words towards higher indices
    (binary lifting: one static pad-and-slice per bit of ``k``)."""
    P, C = rows.shape
    step = 1
    j = 0
    while step <= max_shift and step < C:
        bit = ((k >> j) & 1).astype(bool)[:, None]
        shifted = jnp.concatenate(
            [jnp.zeros((P, step), _U32), rows[:, :-step]], axis=1
        )
        rows = jnp.where(bit, shifted, rows)
        step *= 2
        j += 1
    return rows


def _word_shift_up_t(rows_t: jax.Array, k: jax.Array,
                     max_shift: int) -> jax.Array:
    """Transposed lifting: rows_t (C, P), k (P,)."""
    C, P = rows_t.shape
    step = 1
    j = 0
    while step <= max_shift and step < C:
        bit = ((k >> j) & 1).astype(bool)[None, :]
        shifted = jnp.concatenate(
            [jnp.zeros((step, P), _U32), rows_t[:-step]], axis=0
        )
        rows_t = jnp.where(bit, shifted, rows_t)
        step *= 2
        j += 1
    return rows_t


#: below this row count the merge switches to unrolled per-row dynamic
#: slices (one pass over the data) instead of the binary-lifting chain
#: (log(C) passes) — a large win for the deep, few-rows levels
_UNROLL_ROWS = 32


def _merge_level_unrolled(A, B, la, max_la_bits: int):
    """Deep-level merge: per-row dynamic word shift via lax.dynamic_slice
    (unrolled over the <= _UNROLL_ROWS/2 rows), then the bit funnel."""
    M, C = A.shape
    C2 = 2 * C
    pad = jnp.zeros((M, C), _U32)
    A2 = jnp.concatenate([A, pad], axis=1)
    out_rows = []
    max_k = min(C, max_la_bits // 32 + 1)
    for m in range(M):
        # B row m shifted up by k words == slice a (C2,) window starting at
        # (max_k - k) out of [zeros(max_k), B[m], zeros] — one dynamic slice
        buf = jnp.concatenate(
            [jnp.zeros((max_k,), _U32), B[m], jnp.zeros((C,), _U32)]
        )
        k = jnp.clip(la[m] >> 5, 0, max_k).astype(_I32)
        row = jax.lax.dynamic_slice(buf, (max_k - k,), (C2,))
        out_rows.append(row)
    B2 = jnp.stack(out_rows)
    B2 = _funnel_up(B2, (la & 31).astype(_U32))
    return A2 | B2


def capacity_schedule(
    P: int, cap0: int, max_block_bits: int, ratio: float
) -> list[int]:
    """Per-level row word capacities for the merge tree.

    ``ratio = 1.0`` is the worst case (capacity doubles every level and no
    overflow is possible). ``ratio < 1`` sizes upper levels for strings
    that compress to at most ``ratio`` of the worst case — an *optimistic*
    bound: the tree detects overflow and callers fall back to the
    ``ratio=1.0`` kernel (ops/coding.py), so correctness never depends on
    the guess. Early levels stay at full capacity (single-block variance
    is unbounded); the ratio engages once rows aggregate >= 8 blocks.
    """
    caps = []
    C = cap0
    blocks = 1
    # additive slack: room for several fully-wide blocks in ONE node, so
    # clustered hot pixels don't overflow small nodes (negligible vs the
    # ratio term at large nodes)
    slack_words = 6 * (-(-max_block_bits // 32)) + cap0
    while blocks <= P:
        if ratio >= 1.0 or blocks < 8:
            cap = min(C, cap0 * max(blocks, 1))
        else:
            need_words = -(-int(blocks * max_block_bits * ratio) // 32)
            cap = min(cap0 * blocks, need_words + slack_words)
        caps.append(max(cap, 1))
        blocks *= 2
        C *= 2
    return caps


def ragged_concat(rows, lengths: jax.Array,
                  max_string_bits: int | None = None,
                  caps: list[int] | None = None,
                  transposed: bool = False):
    """Concatenate P variable-length bitstrings (P a power of two).

    rows:    (P, C0) uint32 — string ``p`` occupies bits [0, lengths[p]) —
             or (C0, P) when ``transposed`` (stage_blocks' native output).
    lengths: (P,) int32
    max_string_bits: static upper bound on any level-0 string length
                     (defaults to C0*32 - 31); bounds the lifting depth.
    caps:    optional per-level row word capacities (capacity_schedule);
             levels beyond a row's capacity flag overflow instead of
             corrupting.

    Returns (words, total_bits, overflowed) — ``overflowed`` is a bool
    scalar; when True the words are invalid and the caller must re-run
    with full capacities. Zero-length rows concatenate as nothing, so
    callers pad P to a power of two with all-zero rows of length 0.

    Orientation: while rows are narrower than the VPU lane count the
    merge runs transposed — (C, P) with the huge pair axis on lanes —
    and flips to row-major (P, C) once C reaches 128 (one transpose).
    """
    if transposed:
        C, P = rows.shape
    else:
        P, C = rows.shape
    if P & (P - 1):
        raise ValueError("row count must be a power of two")
    if max_string_bits is None:
        max_string_bits = C * 32 - 31
    lengths = lengths.astype(_I32)
    max_bits = max_string_bits  # worst-case bits of one string this level
    overflow = jnp.zeros((), bool)
    level = 0
    while P > 1:
        la = lengths[0::2]
        lb = lengths[1::2]
        la_bound = min(max_bits, C * 32)
        if transposed and (2 * C >= _LANES or P <= 2 * _UNROLL_ROWS):
            rows = rows.T  # one flip to row-major for the deep levels
            transposed = False
        if transposed:
            A = rows[:, 0::2]
            B = rows[:, 1::2]
            pad = jnp.zeros((C, P // 2), _U32)
            A2 = jnp.concatenate([A, pad], axis=0)
            B2 = jnp.concatenate([B, pad], axis=0)
            B2 = _word_shift_up_t(
                B2, (la >> 5).astype(_U32), max_shift=la_bound // 32 + 1
            )
            B2 = _funnel_up_t(B2, (la & 31).astype(_U32))
            rows = A2 | B2
        elif P <= _UNROLL_ROWS:
            rows = _merge_level_unrolled(rows[0::2], rows[1::2], la,
                                         la_bound)
        else:
            C2 = 2 * C
            pad = jnp.zeros((P // 2, C), _U32)
            A2 = jnp.concatenate([rows[0::2], pad], axis=1)
            B2 = jnp.concatenate([rows[1::2], pad], axis=1)
            # place B at bit offset la: word part then bit part
            B2 = _word_shift_up(
                B2, (la >> 5).astype(_U32), max_shift=la_bound // 32 + 1
            )
            B2 = _funnel_up(B2, (la & 31).astype(_U32))
            rows = A2 | B2
        lengths = la + lb
        P //= 2
        C = 2 * C
        max_bits *= 2
        level += 1
        if caps is not None and level < len(caps) and caps[level] < C:
            cap = caps[level]
            # safe to shrink only if every string fits the soft capacity
            overflow = overflow | jnp.any(lengths > cap * 32 - 31)
            rows = rows[:cap] if transposed else rows[:, :cap]
            C = cap
    out = rows[:, 0] if transposed else rows[0]
    return out, lengths[0], overflow


def stage_blocks(
    values_u32: jax.Array,
    widths: jax.Array,
    header_bits: jax.Array,
    header_values: jax.Array,
    counts: jax.Array,
    cap_words: int,
    values_hi: jax.Array | None = None,
    max_width: int | None = None,
):
    """Build the level-0 rows: one fixed-capacity word row per block.

    values_u32:    (nb, B) uint32 — payload fields pre-masked to width
                   (low 32 bits when the field is wider than 32)
    widths:        (nb,) int32 field width per block
    header_bits:   (nb,) int32 1/4/6/12
    header_values: (nb,) uint32 LSB-first header bit pattern
    counts:        (nb,) int32 real values in the block (partial tail)
    cap_words:     static row capacity (power of two)
    values_hi:     optional (nb, B) uint32 — field bits 32.. (the int32
                   sign bit of width-33 fields)

    Returns (rows_t (cap_words, nb) uint32 — TRANSPOSED so the big block
    axis rides the VPU lanes — and lengths (nb,) int32).

    Placement is scatter-free: for each target word ``i`` (static loop over
    cap_words, pruned to each value's statically reachable range) every
    value contributes via masked shifts (its low part if it starts in word
    i, its carry parts if it started in earlier words).
    """
    nb, B = values_u32.shape
    # transposed compute: the block axis (large) rides the VPU lanes
    v_t = values_u32.T                                    # (B, nb)
    vh_t = values_hi.T if values_hi is not None else None
    w = widths.astype(_I32)                               # (nb,)
    wpos = w > 0
    cols = [jnp.zeros((nb,), _U32) for _ in range(cap_words)]
    cols[0] = header_values.astype(_U32)
    for j in range(B):
        off = header_bits + j * w                         # (nb,)
        valid = (j < counts) & wpos
        vj = jnp.where(valid, v_t[j], _U32(0))
        word_idx = off >> 5
        bit_idx = (off & 31).astype(_U32)
        lo = vj << bit_idx
        hi = (vj >> (_U32(31) - bit_idx)) >> _U32(1)
        if vh_t is not None:
            vhj = jnp.where(valid & (w > 32), vh_t[j], _U32(0))
            hi = hi | (vhj << bit_idx)   # bits 32.. land one word up
            hi2 = (vhj >> (_U32(31) - bit_idx)) >> _U32(1)
        # static reachability pruning: value j starts at off in
        # [1 + j, 12 + j*max_w] and its parts reach words word_idx..+2
        max_w = (cap_words * 32 - 12) // B
        if max_width is not None:
            max_w = min(max_w, max_width)
        i_lo = (1 + j) >> 5
        i_hi = min(cap_words - 1, ((12 + (j + 1) * max_w) >> 5) + 2)
        for i in range(i_lo, i_hi + 1):
            contrib = jnp.where(word_idx == i, lo, _U32(0)) | jnp.where(
                word_idx == i - 1, hi, _U32(0)
            )
            if vh_t is not None:
                contrib = contrib | jnp.where(word_idx == i - 2, hi2,
                                              _U32(0))
            cols[i] = cols[i] | contrib
    rows_t = jnp.stack(cols, axis=0)                      # (cap, nb)
    lengths = (header_bits + widths * counts).astype(_I32)
    return rows_t, lengths


def pack_frame(
    values_u32: jax.Array,
    widths: jax.Array,
    header_bits: jax.Array,
    header_values: jax.Array,
    counts: jax.Array,
    max_block_bits: int,
    out_words: int | None = None,
    values_hi: jax.Array | None = None,
    caps: tuple[int, ...] | None = None,
):
    """Full scatter-free pack of one frame: stage + merge tree.

    Returns (words (out_words,) uint32, total_bits int32, overflowed bool).
    ``overflowed`` is always False when ``caps`` is None/full.
    """
    nb = values_u32.shape[0]
    cap = row_capacity(max_block_bits)
    rows_t, lengths = stage_blocks(
        values_u32, widths, header_bits, header_values, counts, cap,
        values_hi=values_hi,
        max_width=(max_block_bits - 12) // values_u32.shape[1],
    )
    P = 1
    while P < nb:
        P *= 2
    if P != nb:
        rows_t = jnp.concatenate(
            [rows_t, jnp.zeros((cap, P - nb), _U32)], axis=1
        )
        lengths = jnp.concatenate(
            [lengths, jnp.zeros((P - nb,), _I32)]
        )
    words, total, overflow = ragged_concat(
        rows_t, lengths, max_string_bits=max_block_bits,
        caps=list(caps) if caps is not None else None,
        transposed=True,
    )
    if out_words is not None:
        if out_words <= words.shape[0]:
            words = words[:out_words]
        else:
            words = jnp.concatenate(
                [words, jnp.zeros((out_words - words.shape[0],), _U32)]
            )
    return words, total, overflow


def block_bits_device(spec, frames: jax.Array) -> jax.Array:
    """Per-block bit lengths for a (F, n_padded+) batch — the cheap
    planning prepass (one elementwise pass + OR-reduce)."""
    F = frames.shape[0]
    B = spec.block
    P = spec.tree_rows
    if frames.shape[1] < P * B:
        frames = jnp.concatenate(
            [frames,
             jnp.zeros((F, P * B - frames.shape[1]), frames.dtype)],
            axis=1,
        )
    v = frames[:, : P * B].astype(_I32).reshape(F, P, B)
    if spec.signed:
        mag = jax.lax.bitcast_convert_type(jnp.where(v < 0, -v, v), _U32)
    else:
        mag = jax.lax.bitcast_convert_type(v, _U32)
    setbits = jnp.bitwise_or.reduce(mag, axis=2)
    nz = setbits != 0
    width = jnp.where(
        nz, _I32(32) - jax.lax.clz(setbits).astype(_I32), _I32(0)
    )
    if spec.signed:
        width = width + nz.astype(_I32)
    bidx = jnp.arange(P, dtype=_I32)[None, :]
    real = bidx < spec.nb
    width = jnp.where(real, width, _I32(0))
    counts = jnp.clip(spec.n - bidx * B, 0, B)
    prev = jnp.concatenate(
        [jnp.zeros((F, 1), _I32), width[:, :-1]], axis=1
    )
    repeat = (width == prev) & real
    hb = jnp.where(
        repeat, 1, jnp.where(width < 7, 4, jnp.where(width < 10, 6, 12))
    ).astype(_I32)
    hb = jnp.where(real, hb, _I32(0))
    return hb + width * counts                              # (F, P)


#: encode capacity buckets the prepass chooses among
ENCODE_BUCKETS = (0.25, 0.5)


def encode_bucket_device(spec, frames: jax.Array) -> jax.Array:
    """Device prepass: smallest capacity bucket PROVEN to fit every merge
    node. Returns an int32 scalar index into ENCODE_BUCKETS + (1.0,).

    Replaces the encode-then-check-overflow gamble: one tiny scalar
    fetch picks a kernel that cannot overflow.
    """
    bits = block_bits_device(spec, frames)                  # (F, P)
    P = spec.tree_rows
    cap0 = row_capacity(spec.max_block_bits)
    fits = [jnp.bool_(True) for _ in ENCODE_BUCKETS]
    schedules = [
        capacity_schedule(P, cap0, spec.max_block_bits, r)
        for r in ENCODE_BUCKETS
    ]
    node = bits
    level = 0
    blocks = 1
    while blocks < P:
        blocks *= 2
        level += 1
        F = node.shape[0]
        node = node.reshape(F, node.shape[1] // 2, 2).sum(axis=2)
        mx = jnp.max(node)
        for k, sched in enumerate(schedules):
            fits[k] = fits[k] & (mx <= sched[level] * 32 - 31)
    idx = jnp.int32(len(ENCODE_BUCKETS))
    for k in range(len(ENCODE_BUCKETS) - 1, -1, -1):
        idx = jnp.where(fits[k], jnp.int32(k), idx)
    return idx


def _quant_words(w: int) -> int:
    """Smallest grid value >= w; grid = {1, 1.25, 1.5, 1.75} * 2^k words,
    min 8. Quantizing measured capacities onto this grid bounds the
    number of distinct schedules (jit recompiles) while capping the
    overshoot vs the true maximum at 25%."""
    w = int(w)
    if w <= 8:
        return 8
    k = (w - 1).bit_length() - 1        # 2^k < w <= 2^(k+1)
    for m in (4, 5, 6, 7, 8):
        c = (m << k) >> 2
        if c >= w:
            return c
    raise AssertionError("unreachable")


def measured_schedule(P: int, cap0: int, max_block_bits: int,
                      level_max_bits) -> tuple[int, ...]:
    """Per-level word capacities PROVEN from measured node maxima.

    ``level_max_bits``: log2(P) per-level maxima in bits, level i = the
    largest node of 2^(i+1) blocks anywhere in the batch (the output of
    ``encode_level_maxima`` on device, or pairwise sums of
    pallas_unpack.block_bits_host on the walk tables). Returns a
    capacity_schedule-shaped tuple — index 0 (single block) = ``cap0``,
    each level ceil((max+31)/32) words quantized up (25% max overshoot,
    _quant_words) and clamped at the worst case. The +31-bit margin
    matches the split/merge kernels' funnel-shift reads, so a schedule
    built from the same data can never overflow.
    """
    caps = [cap0]
    blocks = 1
    for mb in level_max_bits:
        blocks *= 2
        worst = min(cap0 * blocks,
                    -(-(blocks * max_block_bits + 31) // 32))
        need = -(-(int(mb) + 31) // 32)
        caps.append(max(1, min(_quant_words(need), worst)))
    return tuple(caps)


def encode_level_maxima(spec, frames: jax.Array) -> jax.Array:
    """Device prepass for the MEASURED capacity schedule: per-level max
    node bit-length over the whole batch -> (log2(P),) int32, level i =
    nodes of 2^(i+1) blocks. One vector fetch (same round trip as the
    bucket prepass); the host quantizes it into a proven schedule via
    ``measured_schedule``."""
    bits = block_bits_device(spec, frames)                  # (F, P)
    P = spec.tree_rows
    out = []
    node = bits
    blocks = 1
    while blocks < P:
        blocks *= 2
        node = node.reshape(
            node.shape[0], node.shape[1] // 2, 2
        ).sum(axis=2)
        out.append(jnp.max(node))
    return jnp.stack(out).astype(jnp.int32)
