"""Scatter/gather-free ragged bit-split: the device path's unpacking primitive.

Inverse of ops/pack.py's merge tree. Given one frame's bitstream (uint32
words, LSB-first) and the per-block widths recovered by the host header
walk, the per-block bit lengths are fully determined (the 1/4/6/12-bit
header length follows from ``width[b] == width[b-1]`` — after every block
the reference's ``prevbits`` equals that block's width, Terse.hpp:517-535).
The stream is then split recursively:

  level L: every node row splits into (A, B) where B = node >> len(A);
           the variable down-shift is binary-lifted static word shifts
           plus an elementwise bit funnel — no gather;
  after log2(P) levels each block owns a fixed-capacity row with its
  header+payload at bit 0; per-value extraction is a static masked-select
  loop over the row's words.

Work mirrors the pack: O(P * C0 * log P) elementwise word ops per frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .pack import _LANES, row_capacity

_U32 = jnp.uint32
_I32 = jnp.int32


def _funnel_down(rows: jax.Array, s: jax.Array) -> jax.Array:
    """Shift each row's bitstring towards lower bit positions by
    ``s in [0, 32)`` bits. rows: (P, C) uint32; s: (P,)."""
    s = s[:, None].astype(_U32)
    nxt = jnp.concatenate(
        [rows[:, 1:], jnp.zeros((rows.shape[0], 1), _U32)], axis=1
    )
    # (nxt << (32 - s)) with a well-defined 0 at s == 0
    carry = (nxt << (_U32(31) - s)) << _U32(1)
    return (rows >> s) | carry


def _funnel_down_t(rows_t: jax.Array, s: jax.Array) -> jax.Array:
    """Transposed funnel: rows_t (C, P), word axis 0, s (P,)."""
    s = s[None, :].astype(_U32)
    nxt = jnp.concatenate(
        [rows_t[1:], jnp.zeros((1, rows_t.shape[1]), _U32)], axis=0
    )
    carry = (nxt << (_U32(31) - s)) << _U32(1)
    return (rows_t >> s) | carry


def _word_shift_down_t(rows_t: jax.Array, k: jax.Array,
                       max_shift: int) -> jax.Array:
    """Transposed lifting: rows_t (C, P), k (P,)."""
    C, P = rows_t.shape
    step = 1
    j = 0
    while step <= max_shift and step < C:
        bit = ((k >> j) & 1).astype(bool)[None, :]
        shifted = jnp.concatenate(
            [rows_t[step:], jnp.zeros((step, P), _U32)], axis=0
        )
        rows_t = jnp.where(bit, shifted, rows_t)
        step *= 2
        j += 1
    return rows_t


def _word_shift_down(rows: jax.Array, k: jax.Array, max_shift: int) -> jax.Array:
    """Shift each row by ``k`` whole words towards lower indices."""
    P, C = rows.shape
    step = 1
    j = 0
    while step <= max_shift and step < C:
        bit = ((k >> j) & 1).astype(bool)[:, None]
        shifted = jnp.concatenate(
            [rows[:, step:], jnp.zeros((P, step), _U32)], axis=1
        )
        rows = jnp.where(bit, shifted, rows)
        step *= 2
        j += 1
    return rows


def header_bits_from_widths(widths: jax.Array) -> jax.Array:
    """Per-block header length from the width table (Terse.hpp:517-535)."""
    w = widths.astype(_I32)
    prev = jnp.concatenate([jnp.zeros((1,), _I32), w[:-1]])
    return jnp.where(
        w == prev, 1, jnp.where(w < 7, 4, jnp.where(w < 10, 6, 12))
    ).astype(_I32)


#: below this node count the split uses unrolled per-row dynamic slices
#: (one pass) instead of the binary-lifting chain — mirrors pack.py
_UNROLL_ROWS = 32


def split_stream(
    words: jax.Array, block_bits: jax.Array, cap_words: int,
    max_block_bits: int | None = None,
) -> jax.Array:
    """Split one bitstream into P per-block rows (P = len(block_bits),
    a power of two; zero-length tail blocks yield zero rows).

    words:      (R,) uint32 — the frame stream at bit 0. R may be smaller
                than the worst case P*cap_words: the caller guarantees the
                actual stream fits (R >= stream words + 1), and node
                capacities clamp at R — the decode analog of the encode
                side's soft capacities, sized from the (known) walk.
    block_bits: (P,) int32 per-block bit lengths
    Returns (P, cap_words) uint32 rows, block p's bits starting at bit 0.
    """
    P = block_bits.shape[0]
    if P & (P - 1):
        raise ValueError("block count must be a power of two")
    if max_block_bits is None:
        max_block_bits = cap_words * 32 - 31
    R = words.shape[0]
    C = R
    rows = words[None, :]
    transposed = False
    nodes = 1
    while nodes < P:
        half = P // (2 * nodes)                  # blocks per child
        # left-child bit length of every current node
        la = jnp.sum(
            block_bits.reshape(2 * nodes, half), axis=1
        ).astype(_I32)[0::2]
        # child capacity: worst case for `half` blocks, clamped at the
        # actual stream size R (a child never outgrows the whole stream)
        C2 = min(-(-(half * max_block_bits + 31) // 32), C)
        max_la = min(half * max_block_bits, C * 32)  # static bound on la
        if (not transposed and C2 < _LANES
                and nodes > _UNROLL_ROWS // 2):
            rows = rows.T                        # (C, nodes): flip once
            transposed = True
        if transposed:
            A = rows[:C2]
            B = _word_shift_down_t(
                rows, (la >> 5).astype(_U32), max_shift=max_la // 32 + 1
            )[:C2]
            # safe to funnel after the C2 cut: a child's bits end at
            # (la&31) + len_child <= 31 + (C2*32 - 31) = C2*32
            B = _funnel_down_t(B, (la & 31).astype(_U32))
            rows = jnp.stack([A, B], axis=2).reshape(C2, 2 * nodes)
        elif nodes <= _UNROLL_ROWS // 2:
            A = rows[:, :C2]
            max_k = min(C, max_la // 32 + 1)
            out = []
            for m in range(rows.shape[0]):
                buf = jnp.concatenate(
                    [rows[m], jnp.zeros((max_k + C2,), _U32)]
                )
                k = jnp.clip(la[m] >> 5, 0, max_k).astype(_I32)
                out.append(jax.lax.dynamic_slice(buf, (k,), (C2,)))
            B = jnp.stack(out)
            B = _funnel_down(B, (la & 31).astype(_U32))
            rows = jnp.stack([A, B], axis=1).reshape(2 * nodes, C2)
        else:
            A = rows[:, :C2]
            B = _word_shift_down(
                rows, (la >> 5).astype(_U32), max_shift=max_la // 32 + 1
            )[:, :C2]
            B = _funnel_down(B, (la & 31).astype(_U32))
            rows = jnp.stack([A, B], axis=1).reshape(2 * nodes, C2)
        nodes *= 2
        C = C2
    # always hand back transposed (C, P): extract_values consumes the
    # word axis as axis 0 so the big block axis stays on the VPU lanes
    return rows if transposed else rows.T


def extract_values(
    rows_t: jax.Array,
    widths: jax.Array,
    header_bits: jax.Array,
    block: int,
    wide: bool = False,
    max_width: int | None = None,
):
    """Per-value field extraction from per-block rows.

    rows_t: (C0, nb) uint32 TRANSPOSED (split_stream's output);
    widths/header_bits: (nb,) int32.
    Returns (block, nb) uint32 fields (low 32 bits), plus the bit-32 plane
    (block, nb) uint32 when ``wide`` (width-33 signed fields).
    """
    C0, nb = rows_t.shape
    w = widths.astype(_I32)                      # (nb,)
    zero = jnp.zeros((nb,), _U32)
    los = []
    his = []
    # bound the reachable word span by the dtype's real max field width
    max_w = (C0 * 32 - 12) // block
    if max_width is not None:
        max_w = min(max_w, max_width)
    for j in range(block):
        off = header_bits + j * w                # (nb,)
        word_idx = off >> 5
        bit_idx = (off & 31).astype(_U32)
        lo = zero
        hi = zero
        # static reachability: off <= max_block_bits, word span tiny
        i_lo = (1 + j) >> 5
        i_hi = min(C0 - 1, ((12 + (j + 1) * max_w) >> 5) + 1)
        for i in range(i_lo, i_hi + 1):
            cur = rows_t[i]
            nxt = rows_t[i + 1] if i + 1 < C0 else zero
            nx2 = rows_t[i + 2] if i + 2 < C0 else zero
            sel = word_idx == i
            win = (cur >> bit_idx) | (
                (nxt << (_U32(31) - bit_idx)) << _U32(1)
            )
            lo = jnp.where(sel, win, lo)
            if wide:
                win_hi = (nxt >> bit_idx) | (
                    (nx2 << (_U32(31) - bit_idx)) << _U32(1)
                )
                hi = jnp.where(sel, win_hi, hi)
        los.append(lo)
        his.append(hi)
    lo = jnp.stack(los, axis=0)                  # (block, nb)
    hi = jnp.stack(his, axis=0) if wide else None
    return lo, hi
