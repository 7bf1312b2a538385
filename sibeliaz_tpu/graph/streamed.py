"""Memory-bounded junction enumeration: chunked scan + multi-round analysis.

This is the TwoPaCo `--filtermemory` capability re-imagined for the device
memory model (reference README.md:226-233: multiple rounds partition the
hash space to bound memory).  The single-kernel path (construct.py) needs
a few hundred bytes of device memory per genome position; chromosome-scale
inputs exceed one card, so here:

  pass 1 (chunked scan): the genome stream is processed in fixed-size
    chunks with a (k+1)-byte halo; each chunk kernel emits per-position
    occurrence evidence — canonical code, packed extension-presence bits,
    boundary flag, orientation — which the host buckets by
    canon mod n_rounds (a vertex class lands wholly in one round),

  pass 2 (per-round analysis): each round's records (≈ N / n_rounds) are
    sorted by canonical code on device and reduced with the same segmented
    predicates as the monolithic kernel; junction verdicts and class
    first-occurrence indices return to the host,

  assembly: ids are dense ranks of class first-occurrence positions across
    all rounds; records are merged back into per-chromosome position order.

Output is bit-identical to construct.build_junctions (tested); peak device
memory is O(chunk + N / n_rounds) instead of O(N).
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sibeliaz_tpu.core import alphabet
from sibeliaz_tpu.graph.construct import (
    _INVALID_CANON,
    _NO_EXT,
    _doubling_codes,
    _doubling_codes2,
    graph_budget_bytes,
)
from sibeliaz_tpu.graph.assemble import assign_ids, split_chromosomes
from sibeliaz_tpu.io.dbg import JunctionChr


@functools.partial(jax.jit, static_argnums=(1,))
def _chunk_scan(codes_u8: jnp.ndarray, k: int):
    """Occurrence evidence for one chunk.  codes_u8 = [left_halo(1) |
    chunk | right_halo(k+1)]; outputs cover the chunk's M local positions:
    canon int64, packed int32 (bits 0-4 right-ext presence, 5-9 left-ext,
    10 boundary), positive bool."""
    n = codes_u8.shape[0]
    M = n - k - 2  # local positions
    definite = codes_u8 != alphabet.BAD_CODE
    codes = jnp.where(definite, codes_u8, 0).astype(jnp.int64)

    defc = jnp.cumsum(definite.astype(jnp.int64))
    defc = jnp.concatenate([jnp.zeros(1, jnp.int64), defc])
    valid_full = (defc[k:] - defc[:-k]) == k  # windows at offsets 0..n-k
    # local position p corresponds to window offset p+1
    valid = valid_full[1 : M + 1]

    fwd_full, rc_full = _doubling_codes(codes, k)
    fwd = fwd_full[1 : M + 1]
    rc = rc_full[1 : M + 1]
    positive = fwd < rc
    canon = jnp.where(valid, jnp.minimum(fwd, rc), _INVALID_CANON)

    nxt_def = definite[k + 1 : M + k + 1]
    prv_def = definite[0:M]
    nxt_c = codes[k + 1 : M + k + 1]
    prv_c = codes[0:M]
    nxt = jnp.where(nxt_def, nxt_c, _NO_EXT)
    prv = jnp.where(prv_def, prv_c, _NO_EXT)
    comp_nxt = jnp.where(nxt_def, 3 - nxt_c, _NO_EXT)
    comp_prv = jnp.where(prv_def, 3 - prv_c, _NO_EXT)
    right_ext = jnp.where(positive, nxt, comp_prv)
    left_ext = jnp.where(positive, prv, comp_nxt)

    prev_valid = valid_full[0:M]
    next_valid = valid_full[2 : M + 2]
    at_boundary = valid & (~prev_valid | ~next_valid)

    packed = (
        (jnp.int32(1) << right_ext.astype(jnp.int32))
        | (jnp.int32(1) << (left_ext.astype(jnp.int32) + 5))
        | (at_boundary.astype(jnp.int32) << 10)
    )
    return canon, packed, positive


@functools.partial(jax.jit, static_argnums=(1,))
def _chunk_scan2(codes_u8: jnp.ndarray, k: int):
    """Two-limb (31 < k <= 61) variant of _chunk_scan: canonical codes are
    (hi, lo) base-2^62 pairs (construct._doubling_codes2), compared
    lexicographically.  Invalid windows carry (hi=_INVALID_CANON, lo=0) —
    the same sentinel convention as construct._prepare_packed."""
    n = codes_u8.shape[0]
    M = n - k - 2
    definite = codes_u8 != alphabet.BAD_CODE
    codes = jnp.where(definite, codes_u8, 0).astype(jnp.int64)

    defc = jnp.cumsum(definite.astype(jnp.int64))
    defc = jnp.concatenate([jnp.zeros(1, jnp.int64), defc])
    valid_full = (defc[k:] - defc[:-k]) == k
    valid = valid_full[1 : M + 1]

    fh_f, fl_f, rh_f, rl_f = _doubling_codes2(codes, k)
    fh, fl = fh_f[1 : M + 1], fl_f[1 : M + 1]
    rh, rl = rh_f[1 : M + 1], rl_f[1 : M + 1]
    positive = (fh < rh) | ((fh == rh) & (fl < rl))
    ch = jnp.where(valid, jnp.where(positive, fh, rh), _INVALID_CANON)
    cl = jnp.where(valid, jnp.where(positive, fl, rl), jnp.int64(0))

    nxt_def = definite[k + 1 : M + k + 1]
    prv_def = definite[0:M]
    nxt_c = codes[k + 1 : M + k + 1]
    prv_c = codes[0:M]
    nxt = jnp.where(nxt_def, nxt_c, _NO_EXT)
    prv = jnp.where(prv_def, prv_c, _NO_EXT)
    comp_nxt = jnp.where(nxt_def, 3 - nxt_c, _NO_EXT)
    comp_prv = jnp.where(prv_def, 3 - prv_c, _NO_EXT)
    right_ext = jnp.where(positive, nxt, comp_prv)
    left_ext = jnp.where(positive, prv, comp_nxt)

    prev_valid = valid_full[0:M]
    next_valid = valid_full[2 : M + 2]
    at_boundary = valid & (~prev_valid | ~next_valid)

    packed = (
        (jnp.int32(1) << right_ext.astype(jnp.int32))
        | (jnp.int32(1) << (left_ext.astype(jnp.int32) + 5))
        | (at_boundary.astype(jnp.int32) << 10)
    )
    return ch, cl, packed, positive


def _class_analysis_sorted(seg_start, invalid_s, packed_s, gpos_s,
                           gather_first: bool = False):
    """Per-class junction predicates over CLASS-SORTED rows.  Returns
    (is_junction, first_gpos) per sorted row.

    Round-4 formulation (construct._v7_core_cummax2 pattern): int32
    last-set ladders, the nine class facts evaluated at class END rows
    only, the one-bit junction verdict spread back with a single packed
    reversed cummax, and class-first gpos riding a packed (rank << 32 |
    gpos) cummax when gpos < 2^32 (both resident-round payloads).  The
    >=4 Gbp host-bucketed path has unbounded int64 gpos and sets
    `gather_first` to read it from the class-start rank instead."""
    n = packed_s.shape[0]
    seg_end = jnp.concatenate([seg_start[1:], jnp.ones(1, dtype=bool)])

    rank32 = jnp.arange(n, dtype=jnp.int32)
    start_rank = jax.lax.cummax(jnp.where(seg_start, rank32, -1))
    # Each VALID row's packed word has exactly one right-extension bit
    # (0..3), one left-extension bit (5..8), and an optional boundary bit
    # (10) — see _chunk_scan.  "class has >=2 distinct right extensions"
    # is therefore segmented max(r) != min(r) over the class, and a
    # segmented max rides a packed (start_rank << 2 | value) cummax:
    # earlier classes have strictly smaller start_rank, so the running
    # max self-resets at class boundaries.  This replaces the round-3
    # [9, n] one-hot rank ladders (whose materializations were ~220 B/row
    # of XLA temp at chromosome caps) with five [n] int32 chains.
    # start_rank < 2^29 is required for the << 2 pack — round buffers are
    # HBM-bounded orders of magnitude below that.
    r_ext = 31 - jax.lax.clz(packed_s & 15)  # -1 only on pad rows (p==0)
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
    isj_s = ((spread & 1) > 0) & ~invalid_s
    # ascending insertion (= gpos) order within a class, so the class
    # minimum gpos sits at the class-start row
    if gather_first:
        first_s = jnp.take(gpos_s, start_rank)
    else:
        first_s = jax.lax.cummax(
            jnp.where(
                seg_start,
                (rank32.astype(jnp.int64) << 32) | gpos_s,
                jnp.int64(-1),
            )
        ) & ((jnp.int64(1) << 32) - 1)
    return isj_s, first_s


@jax.jit
def _round_analysis(canon: jnp.ndarray, packed: jnp.ndarray, gpos: jnp.ndarray):
    """Per-class junction predicates over one round's records (padded with
    _INVALID_CANON rows).  Returns (is_junction, first_gpos) per record,
    in the caller's (insertion) row order.

    PRECONDITION: callers must supply records in ascending-gpos order
    (both round paths do — the resident rounds scan chunks in genome
    order and the host-bucketed path concatenates chunk buckets in scan
    order).  first_gpos is derived from the class-START row of the
    (canon, row) sort, which equals the class minimum gpos only under
    that insertion order."""
    n = canon.shape[0]
    row = jnp.arange(n, dtype=jnp.int32)
    canon_s, perm, packed_s, gpos_s = jax.lax.sort(
        (canon, row, packed, gpos), num_keys=2
    )
    seg_start = jnp.concatenate(
        [jnp.ones(1, dtype=bool), canon_s[1:] != canon_s[:-1]]
    )
    isj_s, first_s = _class_analysis_sorted(
        seg_start, canon_s == _INVALID_CANON, packed_s, gpos_s,
        gather_first=True,
    )
    isj = jnp.zeros(n, bool).at[perm].set(isj_s)
    first = jnp.zeros(n, jnp.int64).at[perm].set(first_s)
    return isj, first


@jax.jit
def _round_analysis2(ch, cl, packed, gpos):
    """Two-limb variant of _round_analysis: class identity is the
    lexicographic (hi, lo) pair, so the grouping sort carries two keys and
    segment starts compare both limbs."""
    n = ch.shape[0]
    row = jnp.arange(n, dtype=jnp.int32)
    ch_s, cl_s, perm, packed_s, gpos_s = jax.lax.sort(
        (ch, cl, row, packed, gpos), num_keys=3
    )
    seg_start = jnp.concatenate(
        [
            jnp.ones(1, dtype=bool),
            (ch_s[1:] != ch_s[:-1]) | (cl_s[1:] != cl_s[:-1]),
        ]
    )
    isj_s, first_s = _class_analysis_sorted(
        seg_start, ch_s == _INVALID_CANON, packed_s, gpos_s,
        gather_first=True,
    )
    isj = jnp.zeros(n, bool).at[perm].set(isj_s)
    first = jnp.zeros(n, jnp.int64).at[perm].set(first_s)
    return isj, first


# ---------------------------------------------------------------------------
# Device-resident rounds (v2): instead of shipping every position's
# occurrence evidence to the host for bucketing (~13 B/position d2h, then
# the same back h2d per round — the dominant cost at chromosome scale on a
# slow link), keep the 2-bit code stream RESIDENT on device and rescan it
# once per round, filtering to the round's canon bucket on device.  This is
# TwoPaCo's multiple-rounds idea in its purest form: R passes over the
# input, each materializing only 1/R of the class table.
#
#   * one h2d of the byte stream (N bytes), R round dispatches;
#   * a round = lax.fori_loop over chunks: dynamic_slice -> chunk scan ->
#     keep rows whose mixed canon hash lands in this round -> sort-compact
#     -> dynamic_update_slice append into the round buffer (garbage rows
#     pre-masked to the invalid sentinel);
#   * the round buffer feeds the same segmented class analysis, junction
#     rows compact on device, and each ships as ONE int64
#     (gpos << 32 | class_first << 1 | orientation)  — 8 B/junction d2h;
#   * id assignment on host: dense ranks of distinct class-first values
#     across rounds (identical to the monolithic kernel's numbering).
# ---------------------------------------------------------------------------

def _split64(x):
    """int64 -> (lo u32, hi u32).  The multi-GB round-buffer carry crosses
    dispatch boundaries as explicit u32 pairs; values are reassembled only
    inside the consuming dispatch (chunk- or one-round-sized temporaries),
    so no backend ever needs a full-size int64 temporary of the carry.
    All packed values here are non-negative."""
    return (
        (x & 0xFFFFFFFF).astype(jnp.uint32),
        (x >> 32).astype(jnp.uint32),
    )


def _join64(lo, hi):
    return (hi.astype(jnp.int64) << 32) | lo.astype(jnp.int64)


# numpy, NOT jnp (device-constant lowering fetch; see construct._INVALID_CANON)
_MIX = np.int64(-7046029254386353131)  # 0x9E3779B97F4A7C15 as two's compl.


def _round_bucket(canon, n_rounds: int):
    """Deterministic class->round assignment (any pure function of canon
    keeps a class whole).  The product's HIGH bits feed the modulo
    (Fibonacci hashing): its low bits are just a permutation of
    canon mod 2^b, and canon's low bits (the k-mer's last bases on the
    canonical strand) are biased by the canonical-strand selection —
    measured 1.8-1.9x max/mean round skew for power-of-two n_rounds,
    enough to overflow a 1.5x-slack round buffer."""
    h = ((canon * _MIX) >> 32) & jnp.int64(0x7FFFFFFF)
    return h % jnp.int64(n_rounds) if isinstance(n_rounds, int) else h % n_rounds


# second mix constant for the low limb (0xC2B2AE3D27D4EB4F two's compl.)
_MIX2 = np.int64(-4417276706812531889)


def _round_bucket2(ch, cl, n_rounds):
    """Two-limb class->round assignment: mix both limbs so classes that
    share a hi limb still spread across rounds.  High product bits feed
    the modulo for the same skew reason as _round_bucket."""
    h = (((ch * _MIX) ^ (cl * _MIX2)) >> 32) & jnp.int64(0x7FFFFFFF)
    return h % jnp.int64(n_rounds) if isinstance(n_rounds, int) else h % n_rounds


@functools.partial(
    jax.jit, static_argnums=(7, 8, 9, 10, 11, 12), donate_argnums=(6,)
)
def _round_scan_pass(pkw, nmw, r0, n_rounds, ci0, ci1, carry,
                     G: int, k: int, chunk: int, cap: int, wide: bool,
                     two_limb: bool):
    """Scan chunks [ci0, ci1) once and bucket-append into G ROUND BUFFERS
    at once (rounds r0..r0+G-1).  This is the round-4 multi-round pass:
    the dominant chromosome-scale cost was R full input rescans (one per
    round, 302 s warm at 256 Mbp); materializing G rounds per rescan cuts
    the scan passes to ceil(R/G) for G x the round-buffer memory.  The
    chunk range is traced so the host can segment a pass into several
    bounded-length dispatches.

    The code stream stays PACKED on device (pkw = 2-bit codes u8[N/4],
    nmw = validity bits u8[N/8], pack_codes_host's wire format) and each
    chunk's window is sliced and unpacked in-kernel: chunk starts are
    word-aligned (chunk % 8 == 0), so the slices are pure u8 loads.
    The packed words stay under 2^31 elements up to 8.5 Gbp, so no
    resident array needs 64-bit indexing at the 2^32-bp scale, and the
    resident stream costs 0.375 B/position instead of 1.

    carry = (limb buffers [G, cap] x (1|2), packed [G, cap],
             gpos [G, cap], cursors [G], overflow); the per-chunk sort key
    g_rel*chunk + local left-compacts rows into per-round segments in one
    sort while preserving ascending-gpos order within each round
    (_round_analysis's insertion-order precondition)."""
    win = 1 + chunk + k + 1
    from sibeliaz_tpu.graph.construct import unpack_codes_device

    # carry layout: u32 lo/hi pairs per logical int64 buffer (see _split64)
    #   single-limb: (c_lo, c_hi, pg_lo, pg_hi, cursors, ovf)
    #   two-limb:    (h_lo, h_hi, l_lo, l_hi, pg_lo, pg_hi, cursors, ovf)

    def body(ci, carry):
        if two_limb:
            bh_lo, bh_hi, bl_lo, bl_hi, pg_lo, pg_hi, cursors, ovf = carry
        else:
            bc_lo, bc_hi, pg_lo, pg_hi, cursors, ovf = carry
        start = 1 + ci * chunk
        pk_s = jax.lax.dynamic_slice(
            pkw, ((start - 1) >> 2,), (win // 4 + 2,)
        )
        nm_s = jax.lax.dynamic_slice(
            nmw, ((start - 1) >> 3,), (win // 8 + 2,)
        )
        block = unpack_codes_device(pk_s, nm_s, win)
        if two_limb:
            ch, cl, packed, positive = _chunk_scan2(block, k)
            bucket = _round_bucket2(ch, cl, n_rounds)
            invalid = ch == _INVALID_CANON
        else:
            canon, packed, positive = _chunk_scan(block, k)
            bucket = _round_bucket(canon, n_rounds)
            invalid = canon == _INVALID_CANON
        local = jnp.arange(chunk, dtype=jnp.int32)
        g_rel = bucket - r0
        keep = ~invalid & (g_rel >= 0) & (g_rel < G)
        pk = packed | (positive.astype(jnp.int32) << 11)
        # one-int64 row payload: gpos << 12 | 12-bit evidence word (gpos
        # < 2^32 always — larger inputs route to the host-bucketed path —
        # so the pack needs 44 bits).  Round 5: this replaces the separate
        # (packed int32, gpos int32/int64) buffers — one less sort operand
        # here and in the epilogue, one less buffer append per round, and
        # 16 B/row in BOTH payload modes (wide rows were 24), which is
        # directly fewer input rescans per G-budget at chromosome scale.
        gpos = start.astype(jnp.int64) + local.astype(jnp.int64)
        bpg_row = (gpos << 12) | pk.astype(jnp.int64)
        key = jnp.where(
            keep, g_rel.astype(jnp.int32) * chunk + local,
            jnp.int32(G * chunk),
        )
        if two_limb:
            _, h2, l2, pg2 = jax.lax.sort(
                (key, ch, cl, bpg_row), num_keys=1
            )
            limb_sorted = (h2, l2)
        else:
            _, c2, pg2 = jax.lax.sort((key, canon, bpg_row), num_keys=1)
            limb_sorted = (c2,)
        g_kept = jnp.where(keep, g_rel, G)
        cnts = jnp.zeros(G, jnp.int64).at[
            jnp.clip(g_kept, 0, G)
        ].add(keep.astype(jnp.int64), mode="drop")
        prefix = jnp.concatenate(
            [jnp.zeros(1, jnp.int64), jnp.cumsum(cnts)[:-1]]
        )
        # pad so a static-length dynamic_slice never reads out of range
        pad1 = jnp.full(chunk, _INVALID_CANON, jnp.int64)
        pad0 = jnp.zeros(chunk, jnp.int64)
        limb_pad = (
            (jnp.concatenate([limb_sorted[0], pad1]),)
            + ((jnp.concatenate([limb_sorted[1], pad0]),) if two_limb else ())
        )
        pg2p = jnp.concatenate([pg2, jnp.zeros(chunk, pg2.dtype)])
        lr = jnp.arange(chunk, dtype=jnp.int64)

        # The per-round append loop runs as a lax.fori_loop so the pass
        # body's compile size is G-INDEPENDENT (an unrolled append grows
        # the program with every round it materializes).
        def upd2(lo_buf, hi_buf, vals, g, at):
            # buffers are FLAT [G*cap], so their allocation is exactly
            # G*cap elements whatever tiling a backend gives 2-D arrays
            vlo, vhi = _split64(vals)
            lo_buf = jax.lax.dynamic_update_slice(
                lo_buf, vlo, (g * cap + at,)
            )
            hi_buf = jax.lax.dynamic_update_slice(
                hi_buf, vhi, (g * cap + at,)
            )
            return lo_buf, hi_buf

        def gbody(g, bufs):
            if two_limb:
                bh_lo, bh_hi, bl_lo, bl_hi, pg_lo, pg_hi, ovf = bufs
            else:
                bc_lo, bc_hi, pg_lo, pg_hi, ovf = bufs
            live = lr < cnts[g]
            at = jnp.minimum(cursors[g], jnp.int64(cap - chunk))
            seg0 = jax.lax.dynamic_slice(limb_pad[0], (prefix[g],), (chunk,))
            seg0 = jnp.where(live, seg0, _INVALID_CANON)
            if two_limb:
                seg1 = jax.lax.dynamic_slice(
                    limb_pad[1], (prefix[g],), (chunk,)
                )
                seg1 = jnp.where(live, seg1, 0)
                bh_lo, bh_hi = upd2(bh_lo, bh_hi, seg0, g, at)
                bl_lo, bl_hi = upd2(bl_lo, bl_hi, seg1, g, at)
            else:
                bc_lo, bc_hi = upd2(bc_lo, bc_hi, seg0, g, at)
            segpg = jax.lax.dynamic_slice(pg2p, (prefix[g],), (chunk,))
            pg_lo, pg_hi = upd2(
                pg_lo, pg_hi, jnp.where(live, segpg, 0), g, at
            )
            ovf = ovf | (cursors[g] + cnts[g] > cap - chunk)
            if two_limb:
                return (bh_lo, bh_hi, bl_lo, bl_hi, pg_lo, pg_hi, ovf)
            return (bc_lo, bc_hi, pg_lo, pg_hi, ovf)

        if two_limb:
            bh_lo, bh_hi, bl_lo, bl_hi, pg_lo, pg_hi, ovf = (
                jax.lax.fori_loop(
                    0, G, gbody,
                    (bh_lo, bh_hi, bl_lo, bl_hi, pg_lo, pg_hi, ovf),
                )
            )
        else:
            bc_lo, bc_hi, pg_lo, pg_hi, ovf = jax.lax.fori_loop(
                0, G, gbody, (bc_lo, bc_hi, pg_lo, pg_hi, ovf)
            )
        cursors = cursors + cnts
        if two_limb:
            return (bh_lo, bh_hi, bl_lo, bl_hi, pg_lo, pg_hi, cursors, ovf)
        return (bc_lo, bc_hi, pg_lo, pg_hi, cursors, ovf)

    return jax.lax.fori_loop(ci0, ci1, body, carry)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _round_epilogue(bufs, wide: bool,
                    two_limb: bool):
    """Class analysis + junction compaction of ONE round buffer (the tail
    of the round-3 _round_scan, as its own dispatch so round buffers from
    a multi-round pass are consumed one at a time).

    Round-4: runs entirely in class-sorted order — the class sort carries
    an int32 insertion-rank payload, the analysis core evaluates on the
    sorted rows, and the junction rows compact with ONE sort keyed by
    that insertion rank.  The previous version scattered isj/first back
    to insertion order (two random [cap]-scatters, the dominant epilogue
    cost at chromosome scale) and then re-sorted for compaction."""
    # bufs = u32 lo/hi pairs (canon limb(s), then bpg); reassemble the
    # int64 values inside this dispatch — one-round-sized temporaries,
    # not carry-sized (see _split64)
    if two_limb:
        limbs = (_join64(bufs[0], bufs[1]), _join64(bufs[2], bufs[3]))
        buf_bpg = _join64(bufs[4], bufs[5])
    else:
        limbs = (_join64(bufs[0], bufs[1]),)
        buf_bpg = _join64(bufs[2], bufs[3])
    cap = buf_bpg.shape[0]
    row = jnp.arange(cap, dtype=jnp.int32)
    if two_limb:
        ch_s, cl_s, perm, bpg_s = jax.lax.sort(
            (limbs[0], limbs[1], row, buf_bpg), num_keys=3
        )
        seg_start = jnp.concatenate(
            [
                jnp.ones(1, dtype=bool),
                (ch_s[1:] != ch_s[:-1]) | (cl_s[1:] != cl_s[:-1]),
            ]
        )
    else:
        ch_s, perm, bpg_s = jax.lax.sort(
            (limbs[0], row, buf_bpg), num_keys=2
        )
        seg_start = jnp.concatenate(
            [jnp.ones(1, dtype=bool), ch_s[1:] != ch_s[:-1]]
        )
    packed_s = (bpg_s & 0xFFF).astype(jnp.int32)  # 12-bit evidence word
    gpos_s = bpg_s >> 12
    isj_s, first_s = _class_analysis_sorted(
        seg_start, ch_s == _INVALID_CANON, packed_s & 0x7FF,
        gpos_s,
    )
    out_cap = cap // 3
    key3 = jnp.where(isj_s, perm, jnp.int32(cap))
    orient = ((packed_s >> 11) & 1).astype(jnp.uint8)
    if wide:
        packed_out = (
            (gpos_s.astype(jnp.uint64) << 32)
            | first_s.astype(jnp.uint64)
        )
        _, po, oo = jax.lax.sort((key3, packed_out, orient), num_keys=1)
    else:
        packed_out = (
            (gpos_s << 32)
            | (first_s << 1)
            | orient.astype(jnp.int64)
        )
        _, po = jax.lax.sort((key3, packed_out), num_keys=1)
        oo = jnp.zeros(cap, jnp.uint8)
    n_j = jnp.sum(isj_s.astype(jnp.int32))
    overflow = n_j > out_cap
    return n_j, po[:out_cap], oo[:out_cap], overflow


def build_junctions_streamed_resident(
    seqs: Sequence[np.ndarray],
    k: int,
    chunk_size: int = 1 << 22,
    n_rounds: int = 4,
    round_slack: float = 1.25,
    force_wide: bool = False,
    budget_bytes: int | None = None,
) -> List[JunctionChr]:
    """Bit-identical to construct.build_junctions; device memory is
    O(chunk + N/n_rounds) and host<->device traffic is one N-byte upload
    plus 8 bytes per junction (9 in the wide >=2^31-position mode; vs
    ~21 B/position round-tripped by the host-bucketed path).
    `budget_bytes` is the graph stage's device budget (-f; default derived
    from the device), which bounds the rounds materialized per rescan.
    `force_wide` exercises the wide payload on small inputs (tests).
    31 < k <= 61 routes the pass through the two-limb chunk scan; the
    output payload and host assembly are limb-count-independent."""
    if not seqs:
        return []
    empty = [
        JunctionChr(pos=np.zeros(0, np.uint32), ids=np.zeros(0, np.int64))
        for _ in seqs
    ]
    lengths = [len(s) for s in seqs]
    sep = np.full(1, ord("N"), dtype=np.uint8)
    pieces = [sep]
    for s in seqs:
        pieces.append(s)
        pieces.append(sep)
    joined = np.concatenate(pieces)
    if len(joined) < k + 2:
        return empty
    N = len(joined)
    # narrow pack: gpos and first<<1 must fit 31 bits; wide pack: 32 bits
    wide = force_wide or N >= (1 << 31) - chunk_size
    if N >= (1 << 32) - chunk_size:
        return build_junctions_streamed(seqs, k, chunk_size, n_rounds)
    M = chunk_size
    n_chunks = -(-(N - 2) // M)
    padded = 1 + n_chunks * M + k + 1
    codes_np = alphabet.encode(joined)
    if padded > len(codes_np):
        codes_np = np.concatenate(
            [codes_np,
             np.full(padded - len(codes_np), alphabet.BAD_CODE, np.uint8)]
        )
    # packed upload AND packed residency: 0.375 B/position h2d instead of
    # 1, and the scan unpacks each chunk's window in-kernel — the unpacked
    # stream is never materialized (see _round_scan_pass).
    from sibeliaz_tpu.graph.construct import pack_codes_host

    # margin: the last chunk's window slice reads a couple of words past
    # padded; keep them valid BAD_CODE pad
    n8 = -(-(len(codes_np) + 16) // 8) * 8
    if n8 > len(codes_np):
        codes_np = np.concatenate(
            [codes_np, np.full(n8 - len(codes_np), alphabet.BAD_CODE,
                               np.uint8)]
        )
    pk_np, nm_np = pack_codes_host(codes_np)
    pk_dev = jnp.asarray(pk_np)
    nm_dev = jnp.asarray(nm_np)

    per_round = int((N * round_slack) / n_rounds) + M
    # round up to a chunk multiple (a pow2 pad would nearly double the
    # round buffer at chromosome scale); retries double n_rounds and
    # re-derive cap/G/seg_chunks for the new round population
    cap = max(M, -(-per_round // M) * M)
    # _class_analysis_sorted packs (start_rank << 2 | v) into int32, which
    # requires row counts < 2^29 (< 2^30 for the boundary chain).  HBM
    # sizing keeps cap orders of magnitude below that; fail loudly if the
    # sizing logic ever changes rather than return wrong junction verdicts.
    if cap >= 1 << 29:
        raise ValueError(
            f"round-buffer cap {cap} exceeds the 2^29-row packing bound of "
            "_class_analysis_sorted; lower chunk_size or raise n_rounds"
        )
    two_limb = k > 31
    # G = rounds materialized per input rescan: the scan passes drop from
    # n_rounds to ceil(n_rounds/G) at G x the round-buffer bytes (the
    # analysis working set is unchanged — epilogues consume one buffer at
    # a time).
    row_bytes = 24 if two_limb else 16  # canon limb(s) + one bpg int64
    # The G round buffers take two thirds of the graph budget; the pass
    # carry is donated across segment dispatches, and the scan and
    # epilogue temporaries (chunk- or one-round-sized) fit in the rest.
    G_budget = graph_budget_bytes(budget_bytes) * 2 // 3
    # bounds the per-dispatch append chain (compile size is G-independent
    # since the fori_loop append; memory is the real bound)
    G_cap = 16
    G = max(1, min(n_rounds, G_cap, G_budget // max(cap * row_bytes, 1)))
    # chunks per dispatch: a high-G pass spends more per chunk (the G-loop's
    # per-round append slices), so it takes half the chunks per dispatch
    # to keep each dispatch about as long as a low-G one
    _seg_env = os.environ.get("SZ_SCAN_SEG_CHUNKS")

    def _seg_chunks(g: int) -> int:
        return int(_seg_env) if _seg_env else (32 if g <= 4 else 16)

    seg_chunks = _seg_chunks(G)
    stream_stats = os.environ.get("SZ_STREAM_STATS")
    n_rounds_initial = n_rounds
    while True:
        parts = []
        oparts = []
        overflowed = False
        for r0 in range(0, n_rounds, G):
            inv_lo = np.uint32(int(_INVALID_CANON) & 0xFFFFFFFF)
            inv_hi = np.uint32(int(_INVALID_CANON) >> 32)
            # flat [G*cap] u32 (2-D would pad the G axis to 8, see upd2)
            z = lambda: jnp.zeros(G * cap, jnp.uint32)
            if two_limb:
                carry = (
                    jnp.full(G * cap, inv_lo, jnp.uint32),
                    jnp.full(G * cap, inv_hi, jnp.uint32),
                    z(), z(), z(), z(),
                    jnp.zeros(G, jnp.int64),
                    jnp.bool_(False),
                )
            else:
                carry = (
                    jnp.full(G * cap, inv_lo, jnp.uint32),
                    jnp.full(G * cap, inv_hi, jnp.uint32),
                    z(), z(),
                    jnp.zeros(G, jnp.int64),
                    jnp.bool_(False),
                )
            import time as _t

            _t0 = _t.time()
            for ci0 in range(0, n_chunks, seg_chunks):
                carry = _round_scan_pass(
                    pk_dev, nm_dev, jnp.int64(r0), jnp.int64(n_rounds),
                    jnp.int64(ci0), jnp.int64(min(ci0 + seg_chunks, n_chunks)),
                    carry, G, k, M, cap, wide, two_limb,
                )
            ovf_now = bool(carry[-1])  # fetch = sync: pass fully timed
            if stream_stats:
                import sys as _sys

                print(
                    f"[stream] pass r0={r0} G={G} scan {_t.time() - _t0:.1f}s",
                    file=_sys.stderr, flush=True,
                )
                _t0 = _t.time()
            if ovf_now:  # cursor overflow in some round buffer
                overflowed = True
                break
            bufs = carry[:-2]  # flat u32 lo/hi pairs (see _round_scan_pass)
            # queue the G epilogues, then fetch: buffers are consumed one
            # dispatch at a time (memory), results pipelined (latency)
            queued = [
                _round_epilogue(
                    tuple(
                        jax.lax.dynamic_slice(b, (g * cap,), (cap,))
                        for b in bufs
                    ),
                    wide, two_limb,
                )
                for g in range(min(G, n_rounds - r0))
            ]
            for n_j, po, oo, eovf in queued:
                if bool(eovf):
                    overflowed = True
                    break
                n_j = int(n_j)
                if n_j:
                    parts.append(np.asarray(po[:n_j]))
                    if wide:
                        oparts.append(np.asarray(oo[:n_j]))
            del carry, bufs, queued
            if stream_stats:
                import sys as _sys

                print(
                    f"[stream] pass r0={r0} epilogues {_t.time() - _t0:.1f}s",
                    file=_sys.stderr, flush=True,
                )
            if overflowed:
                break
        if not overflowed:
            break
        # Bounded retries: cap floors at one chunk (~M rows), and a single
        # k-mer class larger than that can never be split by doubling
        # n_rounds (classes stay whole by design) — without a bound a
        # pathological repeat-dense input would retry/recompile forever.
        # Fall back to the host-bucketed path, whose per-round buffers are
        # sized from the actual round population and have no fixed cap.
        if n_rounds >= 64 * max(1, n_rounds_initial):
            return build_junctions_streamed(seqs, k, chunk_size, n_rounds)
        n_rounds *= 2  # skewed bucket or junction-dense input: re-round
        # resize cap to the new round population: keeping the old cap
        # would pin G at its old value (a 2x512 Mbp run measured G=1 for
        # 32 rounds — 32 full input rescans); the recompile this forces
        # is rare (retry path) and pays for itself immediately
        per_round = int((N * round_slack) / n_rounds) + M
        cap = max(M, -(-per_round // M) * M)
        G = max(1, min(n_rounds, G_cap, G_budget // max(cap * row_bytes, 1)))
        seg_chunks = _seg_chunks(G)

    if not parts:
        return empty
    packed = np.concatenate(parts)
    if wide:
        gpos = (packed >> np.uint64(32)).astype(np.int64)
        first = (packed & np.uint64(0xFFFFFFFF)).astype(np.int64)
        positive = np.concatenate(oparts) > 0
    else:
        packed = packed.astype(np.int64)
        gpos = packed >> 32
        first = (packed >> 1) & 0x7FFFFFFF
        positive = (packed & 1) > 0
    order = np.argsort(gpos, kind="stable")
    gpos, first, positive = gpos[order], first[order], positive[order]
    return split_chromosomes(gpos, assign_ids(first, positive), lengths)


def build_junctions_streamed(
    seqs: Sequence[np.ndarray],
    k: int,
    chunk_size: int = 1 << 22,
    n_rounds: int = 4,
) -> List[JunctionChr]:
    """Bit-identical to construct.build_junctions with bounded device memory.
    31 < k <= 61 carries two-limb canonical codes through the host buckets."""
    if not seqs:
        return []
    empty = [
        JunctionChr(pos=np.zeros(0, np.uint32), ids=np.zeros(0, np.int64))
        for _ in seqs
    ]
    lengths = [len(s) for s in seqs]
    sep = np.full(1, ord("N"), dtype=np.uint8)
    pieces = [sep]
    for s in seqs:
        pieces.append(s)
        pieces.append(sep)
    joined = np.concatenate(pieces)  # leading + trailing N
    if len(joined) < k + 2:
        return empty
    codes_all = alphabet.encode(joined)
    N = len(joined)

    # ---- pass 1: chunked scan, bucket by canon % n_rounds ----
    # Software-pipelined: the device scans chunk i+1 (async dispatch) while
    # the host buckets chunk i's materialized results, so host bucketing
    # overlaps device compute instead of serializing with it.
    # bucket rows: (canon_limbs..., packed, gpos); one limb for k <= 31
    buckets = [[] for _ in range(n_rounds)]
    two_limb = k > 31
    M = chunk_size

    def launch(start):
        end = min(start + M, N - 1)
        m = end - start
        lo = start - 1
        hi = min(end + k + 1, N)
        block = codes_all[lo:hi]
        pad = (1 + M + k + 1) - len(block)
        if pad > 0:
            block = np.concatenate(
                [block, np.full(pad, alphabet.BAD_CODE, np.uint8)]
            )
        if two_limb:
            ch, cl, packed, positive = _chunk_scan2(jnp.asarray(block), k)
            return ((ch, cl), packed, positive, start, end, m)
        canon, packed, positive = _chunk_scan(jnp.asarray(block), k)
        return ((canon,), packed, positive, start, end, m)

    def absorb(pending):
        limbs_d, packed_d, positive_d, start, end, m = pending
        limbs = [np.asarray(x)[:m] for x in limbs_d]
        packed = np.asarray(packed_d)[:m]
        positive = np.asarray(positive_d)[:m]
        valid = limbs[0] != int(_INVALID_CANON)
        gpos = np.arange(start, end, dtype=np.int64)
        pk = packed.astype(np.int32) | (positive.astype(np.int32) << 11)
        # same Fibonacci-hash bucketing as the resident rounds (numpy
        # int64 multiply wraps two's-complement like the device mix)
        if two_limb:
            h = (
                (limbs[0][valid] * _MIX) ^ (limbs[1][valid] * _MIX2)
            ) >> 32 & 0x7FFFFFFF
            rnd = h % n_rounds
        else:
            rnd = ((limbs[0][valid] * _MIX) >> 32 & 0x7FFFFFFF) % n_rounds
        lv = [x[valid] for x in limbs]
        pv, gv = pk[valid], gpos[valid]
        for r in range(n_rounds):
            mr = rnd == r
            if mr.any():
                buckets[r].append((*(x[mr] for x in lv), pv[mr], gv[mr]))

    start = 1
    pending = None
    while start < N - 1:
        nxt = launch(start)
        start = nxt[4]
        if pending is not None:
            absorb(pending)
        pending = nxt
    if pending is not None:
        absorb(pending)

    # ---- pass 2: per-round analysis ----
    all_gpos: List[np.ndarray] = []
    all_first: List[np.ndarray] = []
    all_positive: List[np.ndarray] = []
    n_limbs = 2 if two_limb else 1
    for r in range(n_rounds):
        if not buckets[r]:
            continue
        limbs = [
            np.concatenate([b[i] for b in buckets[r]]) for i in range(n_limbs)
        ]
        packed = np.concatenate([b[n_limbs] for b in buckets[r]])
        gpos = np.concatenate([b[n_limbs + 1] for b in buckets[r]])
        # _round_analysis derives class-first gpos from insertion order;
        # chunk buckets are appended in scan order, so gpos is ascending
        if __debug__ and len(gpos) > 1:
            assert (np.diff(gpos) > 0).all(), (
                "round bucket rows not in ascending gpos order"
            )
        n = len(limbs[0])
        n_pad = max(4096, 1 << (n - 1).bit_length())
        # _class_analysis_sorted's (start_rank << 2 | v) int32 pack needs
        # row counts < 2^29; fail loudly rather than mis-call junctions
        assert n_pad < 1 << 29, (
            f"round bucket {n_pad} rows exceeds the 2^29 packing bound; "
            "raise n_rounds"
        )
        if os.environ.get("SZ_STREAM_STATS"):
            import sys as _sys
            import time as _t2

            print(
                f"[stream-host] round {r}: n={n} n_pad={n_pad} "
                f"pad_waste={n_pad / max(n, 1):.2f}x",
                file=_sys.stderr, flush=True,
            )
            _t_round = _t2.time()
        limb_p = [np.zeros(n_pad, np.int64) for _ in range(n_limbs)]
        limb_p[0][:] = int(_INVALID_CANON)
        for i in range(n_limbs):
            limb_p[i][:n] = limbs[i]
        packed_p = np.zeros(n_pad, np.int32)
        packed_p[:n] = packed & 0x7FF
        gpos_p = np.zeros(n_pad, np.int64)
        gpos_p[:n] = gpos
        if two_limb:
            isj, first = _round_analysis2(
                jnp.asarray(limb_p[0]), jnp.asarray(limb_p[1]),
                jnp.asarray(packed_p), jnp.asarray(gpos_p),
            )
        else:
            isj, first = _round_analysis(
                jnp.asarray(limb_p[0]), jnp.asarray(packed_p),
                jnp.asarray(gpos_p),
            )
        isj = np.asarray(isj)[:n]
        first = np.asarray(first)[:n]
        if os.environ.get("SZ_STREAM_STATS"):
            import sys as _sys
            import time as _t2

            print(
                f"[stream-host] round {r}: analysis+fetch "
                f"{_t2.time() - _t_round:.2f}s",
                file=_sys.stderr, flush=True,
            )
        keep = isj
        all_gpos.append(gpos[keep])
        all_first.append(first[keep])
        all_positive.append(((packed[keep] >> 11) & 1) > 0)

    if not all_gpos:
        return empty
    gpos = np.concatenate(all_gpos)
    first = np.concatenate(all_first)
    positive = np.concatenate(all_positive)
    order = np.argsort(gpos, kind="stable")
    gpos, first, positive = gpos[order], first[order], positive[order]

    return split_chromosomes(gpos, assign_ids(first, positive), lengths)
