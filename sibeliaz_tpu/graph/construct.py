"""Device compacted-dBG junction enumeration (the TwoPaCo stage).

Design (not a translation): instead of TwoPaCo's two-pass Bloom-filter +
hash-table candidate confirmation (a RAM-saving device), we use an *exact*
sort-based formulation that maps onto XLA primitives:

  1. all chromosomes are concatenated with one separator char, encoded to
     2-bit codes on device,
  2. forward and reverse-complement k-mer integer codes for every position
     are built with a logarithmic doubling scheme (O(log k) elementwise
     shifted adds — no sequential scan),
  3. canonical code = min(fwd, rc); a single stable 64-bit sort groups all
     occurrences of a vertex while preserving first-occurrence order,
  4. per-class junction predicates (>=2 distinct out- or in-extensions, or a
     run-boundary occurrence) are computed with segmented maxima,
  5. results scatter back to genome order; the host compacts the fixed-shape
     masks into .dbg-style records.

Semantics contract: identical output to graph/oracle.py (tested), which in
turn mirrors the reference stream contract (common/junctionapi.h).

The heavy stages (2)-(4) are one fused XLA program; multi-device sharding of
stage (2) with (k-1)-halo exchange lives in sibeliaz_tpu/parallel.
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sibeliaz_tpu.core import alphabet
from sibeliaz_tpu.io.dbg import JunctionChr
from sibeliaz_tpu.utils.device import device_memory_bytes

# Sentinel used for "no extension" (run/sequence boundary).
_NO_EXT = 4
# Canonical code sentinel for invalid windows; sorts after all real codes.
# numpy, NOT jnp: a module-level jnp constant is an eager device array,
# created at import and fetched back whenever a jit lowering embeds it.
_INVALID_CANON = np.int64(2**62)


def _doubling_codes(codes: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward and reverse-complement k-mer codes for every position.

    codes: int64 array with values in [0,3] (invalid positions may hold
    garbage in [0,3]; validity is tracked separately by the caller).
    Returns (fwd, rc) where fwd[p] encodes codes[p:p+k] big-endian base-4 and
    rc[p] encodes the reverse complement of that window.

    Doubling scheme: f_m[i] = value of window [i, i+m); f_{2m}[i] =
    f_m[i]*4^m + f_m[i+m]; windows are combined per set bit of k.  All ops
    are elementwise shifts/adds, O(log k) passes over device memory.
    """
    n = codes.shape[0]
    f = codes  # window size 1
    r = 3 - codes  # rc window size 1 (complement; reversal is in the combine)
    # Precompute power-of-two window values.
    fs = {1: f}
    rs = {1: r}
    m = 1
    while m * 2 <= k:
        fm, rm = fs[m], rs[m]
        shifted_f = jnp.roll(fm, -m)
        shifted_r = jnp.roll(rm, -m)
        fs[2 * m] = (fm << (2 * m)) + shifted_f
        # rc of window [i, i+2m) = rc([i+m, i+2m)) concat rc([i, i+m)) where
        # each half's rc is little-endian of complements:
        # r_{2m}[i] = r_m[i] + r_m[i+m] << (2m)
        rs[2 * m] = rm + (shifted_r << (2 * m))
        m *= 2
    # Combine per binary decomposition of k, most significant block first.
    fwd = None
    rc = None
    consumed = 0
    for bit in reversed(range(k.bit_length())):
        m = 1 << bit
        if not (k & m):
            continue
        fm = jnp.roll(fs[m], -consumed)
        rm = jnp.roll(rs[m], -consumed)
        if fwd is None:
            fwd = fm
            rc = rm
        else:
            fwd = (fwd << (2 * m)) + fm
            # New block B sits to the RIGHT of the accumulated window A, so
            # in the reverse complement rc(B) supplies the HIGH digits:
            # rc(A++B) = rc(B)*4^|A| + rc(A).
            rc = (rm << (2 * consumed)) + rc
        consumed += m
    return fwd, rc


_LIMB_BITS = 62
_LIMB_MASK = (1 << _LIMB_BITS) - 1


def _shl2(hi: jnp.ndarray, lo: jnp.ndarray, s: int):
    """(hi, lo) << s over base-2^62 limbs.  For s >= 62 the caller's value
    must be single-limb (hi == 0) — true everywhere in the doubling scheme:
    only small trailing blocks are shifted that far."""
    if s == 0:
        return hi, lo
    if s >= _LIMB_BITS:
        return lo << (s - _LIMB_BITS), jnp.zeros_like(lo)
    return (hi << s) | (lo >> (_LIMB_BITS - s)), (lo << s) & _LIMB_MASK


def _doubling_codes2(codes: jnp.ndarray, k: int):
    """Two-limb variant of _doubling_codes for 31 < k <= 61 (2k bits no
    longer fit one int64).  Window values are (hi, lo) base-2^62 pairs; the
    bit ranges combined by every add are disjoint per limb, so limb adds
    never carry.  Returns (fwd_hi, fwd_lo, rc_hi, rc_lo)."""
    z = jnp.zeros_like(codes)
    fs = {1: (z, codes)}
    rs = {1: (z, 3 - codes)}
    m = 1
    while m * 2 <= k:
        fh, fl = fs[m]
        rh, rl = rs[m]
        sfh, sfl = jnp.roll(fh, -m), jnp.roll(fl, -m)
        srh, srl = jnp.roll(rh, -m), jnp.roll(rl, -m)
        ah, al = _shl2(fh, fl, 2 * m)
        fs[2 * m] = (ah + sfh, al + sfl)
        bh, bl = _shl2(srh, srl, 2 * m)
        rs[2 * m] = (rh + bh, rl + bl)
        m *= 2
    fwd = rc = None
    consumed = 0
    for bit in reversed(range(k.bit_length())):
        m = 1 << bit
        if not (k & m):
            continue
        fh, fl = (jnp.roll(x, -consumed) for x in fs[m])
        rh, rl = (jnp.roll(x, -consumed) for x in rs[m])
        if fwd is None:
            fwd, rc = (fh, fl), (rh, rl)
        else:
            ah, al = _shl2(*fwd, 2 * m)
            fwd = (ah + fh, al + fl)
            bh, bl = _shl2(rh, rl, 2 * consumed)
            rc = (rc[0] + bh, rc[1] + bl)
        consumed += m
    return fwd[0], fwd[1], rc[0], rc[1]


def junction_analysis(codes_u8: jnp.ndarray, k: int):
    """Fixed-shape junction analysis over a separator-joined code array.

    Returns per-position arrays:
      is_junction_occ: bool — valid k-mer whose vertex is a junction
      positive:        bool — forward k-mer is canonical
      first_idx:       int32 — global index of the vertex's first occurrence
                       (meaningful only where is_junction_occ)

    Thin position-order view over the production class analysis (_v7_core:
    payload-carrying sort + running-maximum broadcasts); one extra sort
    brings the sorted-order results back to genome order.  This replaced
    the original segment_max/segment_min formulation, whose nine segment
    ops were ~10x the cost of the cummax broadcasts (see _v7_core notes).
    """
    junction_s, first_s, idx_s, packed_s, _ = _v7_core(codes_u8, k)
    _, isj, first, pos_flag = jax.lax.sort(
        (
            idx_s,
            junction_s,
            first_s,
            ((packed_s >> 11) & 1).astype(jnp.uint8),
        ),
        num_keys=1,
    )
    return isj, pos_flag > 0, first


def junction_analysis_packed(codes_u8: jnp.ndarray, k: int):
    """Transfer-lean variant: flags packed into one uint8 (bit0 = junction
    occurrence, bit1 = canonical/positive orientation) and the
    first-occurrence index narrowed to int32 (valid for inputs < 2 Gbp;
    the uint32 position format caps chromosomes far earlier anyway)."""
    isj, pos, first = junction_analysis(codes_u8, k)
    flags = isj.astype(jnp.uint8) | (pos.astype(jnp.uint8) << 1)
    return flags, first.astype(jnp.int32)


def _windowed_all(flags: jnp.ndarray, k: int) -> jnp.ndarray:
    """valid[p] = AND of flags[p..p+k) via log-doubling shifts (replaces an
    expensive full-length cumsum; boolean traffic only)."""
    n = flags.shape[0]
    vs = {1: flags}
    m = 1
    while m * 2 <= k:
        vs[2 * m] = vs[m] & jnp.roll(vs[m], -m)
        m *= 2
    out = None
    consumed = 0
    for bit in reversed(range(k.bit_length())):
        m = 1 << bit
        if not (k & m):
            continue
        vm = jnp.roll(vs[m], -consumed)
        out = vm if out is None else (out & vm)
        consumed += m
    # windows that wrap past the end are invalid
    idx = jnp.arange(n)
    return out & (idx + k <= n)


def junction_records_compact_v7(codes_u8: jnp.ndarray, k: int, capacity: int):
    """v5 with the segmented reductions replaced by running-maximum
    broadcasts — the final scatter-free form.

    Segment ops scatter through random indices; a cummax streams its
    input once.  Per-class "contains
    extension char c" becomes: last-set-bit rank (forward cummax) at the
    class END, spread back to members by a packed (flipped-rank, value)
    cummax over the reversed array, compared against the class-start rank.
    The first-occurrence index rides a forward packed cummax (stable sort
    puts the minimum at the class start).
    """
    n = codes_u8.shape[0]
    junction_s, first_s, idx_s, packed_s, _ = _v7_core(codes_u8, k)
    count = jnp.sum(junction_s.astype(jnp.int64)).astype(jnp.int32)
    key2 = jnp.where(
        junction_s, idx_s.astype(jnp.int64), idx_s.astype(jnp.int64) + n
    )
    _, out_pos, out_first, out_flags = jax.lax.sort(
        (key2, idx_s, first_s, (packed_s >> 11).astype(jnp.uint8)),
        num_keys=1,
    )
    return count, out_pos[:capacity], out_first[:capacity], out_flags[:capacity]


def junction_records_compact_v8(codes_u8: jnp.ndarray, k: int, capacity: int):
    """v7 plus on-device id assignment.

    The host used to compute ids as rank-of-first (`np.unique` +
    `np.searchsorted`) after transferring each record's class-first index.
    Ranking the class-first positions on device (one more sort + a
    searchsorted) lets the kernel emit the final signed int32 id directly,
    so (a) the host id pass disappears and (b) the d2h payload drops to
    8 bytes/junction (pos int32 + signed id int32).  Ids are identical to
    the host assignment (dense ascending ranks of class first-occurrence,
    +1; sign = orientation flag, junctionstorage/TwoPaCo signed-id
    semantics)."""
    n = codes_u8.shape[0]
    junction_s, first_s, idx_s, packed_s, seg_start = _v7_core(codes_u8, k)

    # Rank class-first positions with two payload-carrying sorts (sorts are
    # the primitive this kernel family is built on).  Sort rows by
    # class-first value, count distinct firsts with a cumsum, sort the
    # ranks back.
    row = jnp.arange(n, dtype=jnp.int32)
    fkey = jnp.where(junction_s, first_s, jnp.int32(0x7FFFFFFF))
    fkey_s, row_s = jax.lax.sort((fkey, row), num_keys=1)
    new_class = jnp.concatenate(
        [jnp.ones(1, dtype=bool), fkey_s[1:] != fkey_s[:-1]]
    )
    crank = jnp.cumsum(new_class.astype(jnp.int32))  # 1-based class rank
    _, sid = jax.lax.sort((row_s, crank), num_keys=1)
    signed = jnp.where(((packed_s >> 11) & 1) > 0, sid, -sid)

    count = jnp.sum(junction_s.astype(jnp.int64)).astype(jnp.int32)
    key2 = jnp.where(
        junction_s, idx_s.astype(jnp.int64), idx_s.astype(jnp.int64) + n
    )
    _, out_pos, out_id = jax.lax.sort((key2, idx_s, signed), num_keys=1)
    out_pos = out_pos[:capacity]
    out_id = out_id[:capacity]
    # Positions are ascending, so ship them as uint16 deltas (2 B/junction
    # instead of 4) when no gap overflows 16 bits; the host checks the
    # escape count (one scalar) and falls back to the absolute array only
    # in the rare overflow case.
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), out_pos[:-1]])
    delta = out_pos - prev
    row = jnp.arange(out_pos.shape[0], dtype=jnp.int32)
    in_count = row < count
    n_escape = jnp.sum((in_count & (delta > 65535)).astype(jnp.int32))
    delta_u16 = jnp.clip(delta, 0, 65535).astype(jnp.uint16)
    return count, out_pos, out_id, delta_u16, n_escape


def junction_records_compact_v9(codes_u8: jnp.ndarray, k: int, capacity: int):
    """v8 with a 4-byte packed payload.

    Junction gaps average a few bp (every branching k-mer is a junction),
    so positions ship as uint8 deltas (255 = in-band escape sentinel; the
    host gathers those rows' absolute positions afterwards) and ids as
    24-bit two's-complement (guarded: the host falls back to the absolute
    int32 arrays if any id needs more), packed into one uint32 word per
    junction — a single contiguous 4 B/junction d2h stream (6 B in v8)."""
    n = codes_u8.shape[0]
    junction_s, first_s, idx_s, packed_s, seg_start = _v7_core(codes_u8, k)

    # Rank class-first positions with ONE payload-carrying sort (ids = dense
    # ascending ranks of class first-occurrence, +1; sign = orientation
    # flag), then compact straight from first-key order to position order —
    # v8's separate rank-back sort folds into the compaction sort.
    fkey = jnp.where(junction_s, first_s, jnp.int32(0x7FFFFFFF))
    sign_bit = ((packed_s >> 11) & 1).astype(jnp.int32)
    fkey_s, idx2, sgn2 = jax.lax.sort((fkey, idx_s, sign_bit), num_keys=1)
    new_class = jnp.concatenate(
        [jnp.ones(1, dtype=bool), fkey_s[1:] != fkey_s[:-1]]
    )
    crank = jnp.cumsum(new_class.astype(jnp.int32))  # 1-based class rank
    signed = jnp.where(sgn2 > 0, crank, -crank)
    isj = fkey_s < jnp.int32(0x7FFFFFFF)

    count = jnp.sum(junction_s.astype(jnp.int64)).astype(jnp.int32)
    key2 = jnp.where(
        isj, idx2.astype(jnp.int64), idx2.astype(jnp.int64) + n
    )
    _, out_pos, out_id = jax.lax.sort((key2, idx2, signed), num_keys=1)
    out_pos = out_pos[:capacity]
    out_id = out_id[:capacity]

    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), out_pos[:-1]])
    delta = out_pos - prev
    rowc = jnp.arange(out_pos.shape[0], dtype=jnp.int32)
    in_count = rowc < count
    id_ovf = (
        jnp.max(jnp.where(in_count, jnp.abs(out_id), 0)) >= (1 << 23)
    )
    # one uint32 word per junction: delta byte | 24-bit id << 8 (pure
    # elementwise packing; 255 is an in-band escape sentinel, so no
    # escape-compaction sort is needed: the host gathers the few
    # >=255-gap rows' absolute positions afterwards)
    u = out_id.astype(jnp.uint32)
    d8 = jnp.clip(delta, 0, 255).astype(jnp.uint32)
    pack = d8 | ((u & 0xFFFFFF) << 8)
    return count, out_pos, out_id, pack, id_ovf


def _prepare_packed(codes_u8: jnp.ndarray, k: int):
    """Shared front half of the class analysis: validity, canonical codes,
    and the per-position packed extension bits, in genome order.

    Returns (canon_keys, packed, idx) where canon_keys is a tuple of int64
    sort keys identifying the canonical k-mer class: one limb for k <= 31,
    two base-2^62 limbs for 31 < k <= 61 (lexicographic over the tuple)."""
    n = codes_u8.shape[0]
    definite = codes_u8 != alphabet.BAD_CODE
    codes = jnp.where(definite, codes_u8, 0).astype(jnp.int64)
    valid = _windowed_all(definite, k)

    if k <= 31:
        fwd, rc = _doubling_codes(codes, k)
        positive = fwd < rc
        keys = (jnp.where(valid, jnp.minimum(fwd, rc), _INVALID_CANON),)
    else:
        fh, fl, rh, rl = _doubling_codes2(codes, k)
        positive = (fh < rh) | ((fh == rh) & (fl < rl))
        ch = jnp.where(positive, fh, rh)
        cl = jnp.where(positive, fl, rl)
        keys = (
            jnp.where(valid, ch, _INVALID_CANON),
            jnp.where(valid, cl, jnp.int64(0)),
        )

    idx = jnp.arange(n, dtype=jnp.int32)
    nxt_ok = jnp.roll(definite, -k) & (idx + k < n)
    prv_ok = jnp.roll(definite, 1) & (idx >= 1)
    nxt_c = jnp.roll(codes, -k).astype(jnp.int32)
    prv_c = jnp.roll(codes, 1).astype(jnp.int32)
    nxt = jnp.where(nxt_ok, nxt_c, _NO_EXT)
    prv = jnp.where(prv_ok, prv_c, _NO_EXT)
    comp_nxt = jnp.where(nxt_ok, 3 - nxt_c, _NO_EXT)
    comp_prv = jnp.where(prv_ok, 3 - prv_c, _NO_EXT)
    right_ext = jnp.where(positive, nxt, comp_prv)
    left_ext = jnp.where(positive, prv, comp_nxt)
    prev_valid = jnp.concatenate([jnp.zeros(1, dtype=bool), valid[:-1]])
    next_valid = jnp.concatenate([valid[1:], jnp.zeros(1, dtype=bool)])
    at_boundary = valid & (~prev_valid | ~next_valid)

    packed = (
        (jnp.int32(1) << right_ext)
        | (jnp.int32(1) << (left_ext + 5))
        | (at_boundary.astype(jnp.int32) << 10)
        | (positive.astype(jnp.int32) << 11)
    )
    return keys, packed, idx


def _v7_core_cummax(codes_u8: jnp.ndarray, k: int):
    """Cummax-broadcast class analysis (the v7-era formulation); kept for
    A/B rooflining and as a fallback.  Returns, in canon-sorted row order:
    junction flag, class-first index (int32), original index (int32),
    packed extension bits, class-start flag."""
    n = codes_u8.shape[0]
    keys, packed, idx = _prepare_packed(codes_u8, k)

    *keys_s, packed_s, idx_s = jax.lax.sort(
        (*keys, packed, idx), num_keys=len(keys), is_stable=True
    )
    seg_start = jnp.concatenate(
        [jnp.ones(1, dtype=bool), keys_s[0][1:] != keys_s[0][:-1]]
    )
    for ks in keys_s[1:]:
        seg_start = seg_start | jnp.concatenate(
            [jnp.ones(1, dtype=bool), ks[1:] != ks[:-1]]
        )
    invalid_s = keys_s[0] == _INVALID_CANON
    seg_end = jnp.concatenate([seg_start[1:], jnp.ones(1, dtype=bool)])
    rank = jnp.arange(n, dtype=jnp.int64)
    start_rank = jax.lax.cummax(jnp.where(seg_start, rank, -1))
    M = jnp.int64(1) << 32

    # all nine per-bit "last set rank" chains ride ONE [9, n] cummax, and
    # their class-end values spread back in ONE flipped [9, n] cummax —
    # this keeps the HLO small (an unrolled per-bit variant compiles
    # slower for the same work)
    shifts = jnp.array([0, 1, 2, 3, 5, 6, 7, 8, 10], dtype=jnp.int32)
    bits = ((packed_s[None, :] >> shifts[:, None]) & 1) > 0  # [9, n]
    last_set = jax.lax.cummax(
        jnp.where(bits, rank[None, :], jnp.int64(-1)), axis=1
    )
    vpack = jnp.where(
        seg_end[None, :],
        (n - 1 - rank)[None, :] * M + (last_set + 1),
        jnp.int64(-1),
    )
    spread = jax.lax.cummax(vpack[:, ::-1], axis=1)[:, ::-1] % M - 1
    has = spread >= start_rank[None, :]  # [9, n]
    distinct_r = jnp.sum(has[0:4].astype(jnp.int32), axis=0)
    distinct_l = jnp.sum(has[4:8].astype(jnp.int32), axis=0)
    boundary_any = has[8]
    junction_s = (
        (distinct_r > 1) | (distinct_l > 1) | boundary_any
    ) & ~invalid_s
    first_s = (
        jax.lax.cummax(
            jnp.where(seg_start, rank * M + idx_s.astype(jnp.int64), -1)
        )
        % M
    ).astype(jnp.int32)
    return junction_s, first_s, idx_s, packed_s, seg_start


def _v7_core_cummax2(codes_u8: jnp.ndarray, k: int):
    """Leaner cummax core (round 3): same outputs as _v7_core_cummax with
    ~4x less running-maximum traffic.

    The v7 formulation spreads all nine per-bit class facts back to every
    member with a [9, n] int64 reversed cummax (~144 B/row).  But members
    only need the one-bit JUNCTION verdict — so compute the nine
    "class contains bit c" facts AT THE CLASS END ROW ONLY (where the
    forward last-set ladder already has the full class), reduce them to
    the junction bit there, and spread just that bit with a single packed
    int64 reversed cummax.  The last-set ladder itself narrows to int32
    (ranks fit: the monolithic bucket is HBM-capped far below 2^31).
    Differential-tested identical to _v7_core_cummax."""
    n = codes_u8.shape[0]
    keys, packed, idx = _prepare_packed(codes_u8, k)

    *keys_s, packed_s, idx_s = jax.lax.sort(
        (*keys, packed, idx), num_keys=len(keys), is_stable=True
    )
    seg_start = jnp.concatenate(
        [jnp.ones(1, dtype=bool), keys_s[0][1:] != keys_s[0][:-1]]
    )
    for ks in keys_s[1:]:
        seg_start = seg_start | jnp.concatenate(
            [jnp.ones(1, dtype=bool), ks[1:] != ks[:-1]]
        )
    invalid_s = keys_s[0] == _INVALID_CANON
    seg_end = jnp.concatenate([seg_start[1:], jnp.ones(1, dtype=bool)])

    rank32 = jnp.arange(n, dtype=jnp.int32)
    start_rank = jax.lax.cummax(jnp.where(seg_start, rank32, -1))
    shifts = jnp.array([0, 1, 2, 3, 5, 6, 7, 8, 10], dtype=jnp.int32)
    bits = ((packed_s[None, :] >> shifts[:, None]) & 1) > 0  # [9, n]
    last_set = jax.lax.cummax(
        jnp.where(bits, rank32[None, :], jnp.int32(-1)), axis=1
    )
    # class facts, valid at end rows (start_rank there = own class start)
    has_end = last_set >= start_rank[None, :]  # [9, n]
    distinct_r = jnp.sum(has_end[0:4].astype(jnp.int32), axis=0)
    distinct_l = jnp.sum(has_end[4:8].astype(jnp.int32), axis=0)
    jbit = (distinct_r > 1) | (distinct_l > 1) | has_end[8]
    # spread the junction bit from each class end back to its members:
    # pack (n-1-rank) | bit so the reversed cummax picks the nearest
    # end row at-or-after each position (exactly one end per class)
    vp = jnp.where(
        seg_end,
        ((jnp.int64(n - 1) - rank32.astype(jnp.int64)) << 1)
        | jbit.astype(jnp.int64),
        jnp.int64(-1),
    )
    spread = jax.lax.cummax(vp[::-1])[::-1]
    junction_s = ((spread & 1) > 0) & ~invalid_s

    rank = jnp.arange(n, dtype=jnp.int64)
    M = jnp.int64(1) << 32
    first_s = (
        jax.lax.cummax(
            jnp.where(seg_start, rank * M + idx_s.astype(jnp.int64), -1)
        )
        % M
    ).astype(jnp.int32)
    return junction_s, first_s, idx_s, packed_s, seg_start


def _v7_core_cummax3(codes_u8: jnp.ndarray, k: int):
    """Segmented-max-chain core (round 4): same outputs as
    _v7_core_cummax2 with the [9, n] one-hot rank ladders replaced by
    five packed [n] int32 chains.

    Every valid row's packed word has exactly one right-extension bit
    (0..3), one left-extension bit (5..8), and an optional boundary bit
    (10), so "class contains >=2 distinct right extensions" is segmented
    max(r) != min(r) of the 2-bit extension value.  A segmented max rides
    a packed (start_rank << 2 | value) cummax: earlier classes have
    strictly smaller start_rank, so the running max self-resets at class
    boundaries (requires start_rank < 2^29; the monolithic bucket is
    HBM-capped far below).  Differential-tested identical to the other
    cores (tests/test_graph.py::test_v7_cores_identical)."""
    n = codes_u8.shape[0]
    keys, packed, idx = _prepare_packed(codes_u8, k)

    *keys_s, packed_s, idx_s = jax.lax.sort(
        (*keys, packed, idx), num_keys=len(keys), is_stable=True
    )
    seg_start = jnp.concatenate(
        [jnp.ones(1, dtype=bool), keys_s[0][1:] != keys_s[0][:-1]]
    )
    for ks in keys_s[1:]:
        seg_start = seg_start | jnp.concatenate(
            [jnp.ones(1, dtype=bool), ks[1:] != ks[:-1]]
        )
    invalid_s = keys_s[0] == _INVALID_CANON
    seg_end = jnp.concatenate([seg_start[1:], jnp.ones(1, dtype=bool)])

    rank32 = jnp.arange(n, dtype=jnp.int32)
    start_rank = jax.lax.cummax(jnp.where(seg_start, rank32, -1))
    r_ext = 31 - jax.lax.clz(packed_s & 15)  # -1 only where packed == 0
    l_ext = 31 - jax.lax.clz((packed_s >> 5) & 15)
    rc = jnp.maximum(r_ext, 0)
    lc = jnp.maximum(l_ext, 0)
    bnd = (packed_s >> 10) & 1
    base = start_rank << 2
    rmax = jax.lax.cummax(base | rc)
    rmin = jax.lax.cummax(base | (3 - rc))
    lmax = jax.lax.cummax(base | lc)
    lmin = jax.lax.cummax(base | (3 - lc))
    bany = jax.lax.cummax((start_rank << 1) | bnd)
    jbit = (
        ((rmax & 3) + (rmin & 3) != 3)
        | ((lmax & 3) + (lmin & 3) != 3)
        | ((bany & 1) > 0)
    )
    vp = jnp.where(
        seg_end,
        ((jnp.int64(n - 1) - rank32.astype(jnp.int64)) << 1)
        | jbit.astype(jnp.int64),
        jnp.int64(-1),
    )
    spread = jax.lax.cummax(vp[::-1])[::-1]
    junction_s = ((spread & 1) > 0) & ~invalid_s

    rank = jnp.arange(n, dtype=jnp.int64)
    M = jnp.int64(1) << 32
    first_s = (
        jax.lax.cummax(
            jnp.where(seg_start, rank * M + idx_s.astype(jnp.int64), -1)
        )
        % M
    ).astype(jnp.int32)
    return junction_s, first_s, idx_s, packed_s, seg_start


def _popcount4(x: jnp.ndarray) -> jnp.ndarray:
    """Number of set bits among the low 4 bits of x (int32)."""
    return (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1) + ((x >> 3) & 1)


def _v7_core_scan(codes_u8: jnp.ndarray, k: int):
    """Segmented-scan class analysis — the production core (v10).

    The cummax formulation streams two [9, n] int64 running-maximum ladders
    plus three packed int64 rank chains (~150 B/row of scan traffic).  But
    the per-class facts we need are exactly a segmented bitwise OR of the
    12-bit packed extension word: "class contains right-extension c" is one
    bit of OR over the class's rows.  A segmented OR is associative, so it
    is ONE `lax.associative_scan` over (flag: bool, bits: int32); the
    class-first index rides the same scan as a copy-from-segment-start
    lane; a second reversed scan spreads each class's total OR (available
    at its end row) back to every member.  Scan traffic falls to ~9 B/row
    forward + 5 B/row reversed, and all int64 scratch disappears.
    Identical outputs to _v7_core_cummax (differential-tested).
    """
    keys, packed, idx = _prepare_packed(codes_u8, k)

    *keys_s, packed_s, idx_s = jax.lax.sort(
        (*keys, packed, idx), num_keys=len(keys), is_stable=True
    )
    seg_start = jnp.concatenate(
        [jnp.ones(1, dtype=bool), keys_s[0][1:] != keys_s[0][:-1]]
    )
    for ks in keys_s[1:]:
        seg_start = seg_start | jnp.concatenate(
            [jnp.ones(1, dtype=bool), ks[1:] != ks[:-1]]
        )
    invalid_s = keys_s[0] == _INVALID_CANON

    def fwd(a, b):
        af, av, ai = a
        bf, bv, bi = b
        return (
            af | bf,
            jnp.where(bf, bv, av | bv),
            jnp.where(bf, bi, ai),
        )

    _, cum_or, first_s = jax.lax.associative_scan(
        fwd, (seg_start, packed_s, idx_s)
    )

    # Reversed copy-from-class-end: each class's end row holds its full OR.
    seg_end = jnp.concatenate([seg_start[1:], jnp.ones(1, dtype=bool)])

    def bwd(a, b):
        af, av = a
        bf, bv = b
        return af | bf, jnp.where(bf, bv, av)

    _, class_or_r = jax.lax.associative_scan(
        bwd, (seg_end[::-1], cum_or[::-1])
    )
    class_or = class_or_r[::-1]

    distinct_r = _popcount4(class_or)
    distinct_l = _popcount4(class_or >> 5)
    boundary_any = ((class_or >> 10) & 1) > 0
    junction_s = (
        (distinct_r > 1) | (distinct_l > 1) | boundary_any
    ) & ~invalid_s
    return junction_s, first_s, idx_s, packed_s, seg_start


# Default core: cummax2 — class facts at end rows + one-bit spread, the
# fewest running-maximum passes of the cummax family.  The other cores
# stay selectable: "cummax" is the v7 [9, n] spread formulation; "scan"'s
# two lax.associative_scan trees stream the least but their slice/concat
# recursion makes XLA's compile time grow ~4x per input doubling.  All
# are differential-tested identical (tests/test_graph.py); which core is
# fastest on the GPU is not measured yet.
_CORES = {
    "cummax": _v7_core_cummax,
    "cummax2": _v7_core_cummax2,
    "cummax3": _v7_core_cummax3,
    "scan": _v7_core_scan,
}
_core_name = os.environ.get("SZ_JUNCTION_CORE", "cummax2")
if _core_name not in _CORES:
    raise ValueError(
        f"SZ_JUNCTION_CORE={_core_name!r} is not a junction core; "
        f"valid options: {sorted(_CORES)}"
    )
_v7_core = _CORES[_core_name]


def pack_codes_host(codes: np.ndarray):
    """Pack a BAD_CODE-carrying uint8 code stream into (2-bit codes,
    1-bit validity bitmap) for upload — 0.375 B/position instead of 1;
    len(codes) must be a multiple of 8 (bucket-padded)."""
    valid = codes != alphabet.BAD_CODE
    c = np.where(valid, codes, 0).astype(np.uint8).reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    nmask = np.packbits(
        valid.reshape(-1, 8), axis=1, bitorder="little"
    ).ravel()
    return packed, nmask


def unpack_codes_device(packed, nmask, n: int):
    """Device inverse of pack_codes_host (invalid positions -> BAD_CODE).

    Two formulations, picked by size, both exact: the [n/4, 4] stack +
    contiguous reshape is elementwise-only, while the 1-D gather
    formulation keeps no [n/4, 4]-shaped temporaries, whose layout a
    backend may pad along the minor dimension at chromosome scale."""
    if n <= (1 << 26):
        c = jnp.stack(
            [(packed >> (2 * j)) & 3 for j in range(4)], axis=1
        ).reshape(-1)[:n]
        v = jnp.stack(
            [(nmask >> j) & 1 for j in range(8)], axis=1
        ).reshape(-1)[:n]
    else:
        i = jnp.arange(n, dtype=jnp.int32)
        c = (packed[i >> 2] >> ((i & 3) * 2).astype(jnp.uint8)) & 3
        v = (nmask[i >> 3] >> (i & 7).astype(jnp.uint8)) & 1
    return jnp.where(v > 0, c, alphabet.BAD_CODE).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _junction_kernel_compact_v9_packed(packed, nmask, k, capacity, n):
    return junction_records_compact_v9(
        unpack_codes_device(packed, nmask, n), k, capacity
    )


_junction_kernel = jax.jit(junction_analysis, static_argnums=(1,))
_junction_kernel_packed = jax.jit(junction_analysis_packed, static_argnums=(1,))
_junction_kernel_compact_v7 = jax.jit(
    junction_records_compact_v7, static_argnums=(1, 2)
)
_junction_kernel_compact_v8 = jax.jit(
    junction_records_compact_v8, static_argnums=(1, 2)
)
_junction_kernel_compact_v9 = jax.jit(
    junction_records_compact_v9, static_argnums=(1, 2)
)


# Peak device memory of the monolithic kernel per bucket position: the
# compiled plan (memory_analysis: arguments + outputs + temporaries) on an
# NVIDIA H100 80GB HBM3 is 35.6 B at k=15 (the same at the 2^24, 2^26 and
# 2^28 buckets) and 57.4 B at k=33, whose two-limb keys widen the class
# sort.  Inputs whose bucket would exceed the budget route to the
# multi-round streamed path.
MONOLITHIC_PEAK_BYTES_PER_POS = 36
MONOLITHIC_PEAK_BYTES_PER_POS_TWO_LIMB = 58
# Streamed-resident rounds per input position: one round's epilogue plan
# is 76.5 B per round-buffer row on the same card (k=15), rows are 1.25x
# the round's positions, and the epilogue gets the third of the budget
# the G round buffers leave: 3 x 1.25 x 76.5.
STREAMED_PEAK_BYTES_PER_POS = 288
# Share of the device's memory the graph stage plans for; the rest holds
# the uploaded input, the fetched output and allocator fragmentation.
GRAPH_BUDGET_FRACTION = 0.75


def graph_budget_bytes(hbm_budget_bytes: int | None = None) -> int:
    """The graph stage's device-memory budget: -f when given, else a fixed
    share of what the device reports."""
    if hbm_budget_bytes:
        return int(hbm_budget_bytes)
    return int(device_memory_bytes() * GRAPH_BUDGET_FRACTION)


def build_junctions(
    seqs: Sequence[np.ndarray],
    k: int,
    hbm_budget_bytes: int | None = None,
) -> List[JunctionChr]:
    """Run junction enumeration on device; return per-chromosome records.

    Inputs too large for the monolithic kernel's HBM footprint delegate to
    graph/streamed.py (bit-identical output, O(chunk + N/rounds) memory)."""
    if not seqs:
        return []
    empty = [
        JunctionChr(pos=np.zeros(0, np.uint32), ids=np.zeros(0, np.int64))
        for _ in seqs
    ]
    lengths = [len(s) for s in seqs]
    if sum(lengths) + len(seqs) - 1 < k:
        return empty
    sep = np.array([ord("N")], dtype=np.uint8)  # separator (never definite)
    joined = np.concatenate(
        [x for s in seqs for x in (s, sep)][:-1] if len(seqs) > 1 else [seqs[0]]
    )
    # Pad to a shape bucket (next power of two) so jit caches compilations
    # across inputs; trailing 'N's are invalid windows and change nothing.
    bucket = max(4096, 1 << (len(joined) - 1).bit_length())
    budget = graph_budget_bytes(hbm_budget_bytes)
    mono_per_pos = (MONOLITHIC_PEAK_BYTES_PER_POS if k <= 31
                    else MONOLITHIC_PEAK_BYTES_PER_POS_TWO_LIMB)
    if bucket * mono_per_pos > budget:
        from sibeliaz_tpu.graph import streamed

        # k > 31 rounds carry an extra int64 limb buffer and one more sort
        # operand in _round_analysis2, so scale the per-position estimate
        # before sizing rounds (advisor round-3 finding).
        per_pos = STREAMED_PEAK_BYTES_PER_POS
        if k > 31:
            per_pos = int(per_pos * 1.4)
        # size rounds from the REAL input length: the streamed path pads
        # to a chunk multiple, not to the pow2 bucket, and sizing from
        # the bucket doubles the round count (and the rescan passes) for
        # any input just above a power of two (2.2 Gbp -> 128 rounds
        # instead of 66).  The resident path re-joins with a LEADING
        # separator plus one trailing separator per sequence, so its N is
        # sum(lengths) + len(seqs) + 1, not len(joined) — sizing from the
        # latter undershoots for many short sequences, and an overflow
        # retry at chromosome scale costs a full recompile + rescan.
        n_eff = sum(lengths) + len(seqs) + 1
        n_rounds = max(1, -(-(n_eff * per_pos) // budget))
        return streamed.build_junctions_streamed_resident(
            seqs, k, n_rounds=int(n_rounds), budget_bytes=budget
        )
    if bucket > len(joined):
        joined = np.concatenate(
            [joined, np.full(bucket - len(joined), ord("N"), dtype=np.uint8)]
        )
    codes = alphabet.encode(joined)
    capacity = max(4096, len(joined) // 3)
    prof = os.environ.get("SZ_GRAPH_PROFILE")
    pk_host, nm_host = pack_codes_host(codes)
    pk_in, nm_in = jnp.asarray(pk_host), jnp.asarray(nm_host)
    if prof:
        # profile mode: sync at each boundary so the wall clock attributes
        # to (upload, kernel, fetch, host decode)
        import sys as _sys
        import time as _t

        _t0 = _t.time()
        jax.block_until_ready((pk_in, nm_in))
        _prof_t = {"upload": _t.time() - _t0}
        _prof_t["upload_bytes"] = len(pk_host) + len(nm_host)
        _prof_t["t0"] = _t.time()
    # v9 = payload-carrying sorts + running-maximum class broadcasts (no
    # standalone random gathers/scatters, no segment ops) + on-device signed
    # id assignment + 4-byte packed payload (uint8 pos deltas with a sorted
    # escape list, 24-bit ids), so the host does no id work and one
    # contiguous 4 B/junction stream comes back.
    count, out_pos, out_id, pack, id_ovf = _junction_kernel_compact_v9_packed(
        pk_in, nm_in, k, capacity, len(codes)
    )
    count = int(count)
    if prof:
        import sys as _sys
        import time as _t

        _prof_t["kernel"] = _t.time() - _prof_t.pop("t0")
        _prof_t["t0"] = _t.time()
    if count > capacity:
        # extremely junction-dense input: fall back to the full-length path
        flags, first_idx = _junction_kernel_packed(jnp.asarray(codes), k)
        flags = np.asarray(flags)
        first_idx = np.asarray(first_idx)
        mask = (flags & 1) > 0
        positive = (flags & 2) > 0
        jpos = np.flatnonzero(mask)
        from sibeliaz_tpu.graph.assemble import assign_ids

        signed = assign_ids(first_idx[jpos], positive[jpos])
    elif bool(id_ovf):
        # guard rail: >=2^23 distinct vertex classes — ship absolute int32
        signed = np.asarray(out_id[:count]).astype(np.int64)
        jpos = np.asarray(out_pos[:count]).astype(np.int64)
    else:
        p = np.asarray(pack[:count])  # ONE 4 B/junction transfer
        if prof:
            _prof_t["fetch"] = _t.time() - _prof_t.pop("t0")
            _prof_t["fetch_bytes"] = count * 4
            _prof_t["t0"] = _t.time()
        delta = (p & 0xFF).astype(np.int64)
        er = np.flatnonzero(delta == 255)  # escape sentinel: gap >= 255
        if len(er):
            gat = jnp.asarray(
                np.concatenate([er, np.maximum(er - 1, 0)]).astype(np.int64)
            )
            vals = np.asarray(jnp.take(out_pos, gat)).astype(np.int64)
            pe = vals[: len(er)]
            pp = np.where(er > 0, vals[len(er):], 0)
            delta[er] = pe - pp
        jpos = np.cumsum(delta)
        signed = (p >> 8).astype(np.int64)
        signed = np.where(signed >= (1 << 23), signed - (1 << 24), signed)

    # Split global positions back into chromosomes (separator widths = 1;
    # no leading separator in the monolithic join).
    from sibeliaz_tpu.graph.assemble import split_chromosomes

    out = split_chromosomes(jpos, signed, lengths, lead_sep=0)
    if prof:
        if "t0" in _prof_t:
            _prof_t["decode+split"] = _t.time() - _prof_t.pop("t0")
        print(f"[graph-profile] n={len(joined)} junctions={count} "
              + " ".join(f"{k_}={v:.3f}s" if isinstance(v, float) else
                         f"{k_}={v}" for k_, v in _prof_t.items()),
              file=_sys.stderr, flush=True)
    return out
