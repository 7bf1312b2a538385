"""Device (jnp) PointPushBack over a batch of lanes — the last batched-LCB
primitive, porting lcb/batched_push.py's lockstep to one jit program.

Lane state lives in padded [lanes, I_CAP] arrays (instances sorted by the
(chr, cmp) key) plus a sorted (vid -> distance) path-membership table of
capacity P_CAP.  One call applies push_back(edge_l) to every lane l:

  * membership test + path-table insert: per-lane searchsorted + masked
    shift,
  * a fori_loop over the occurrence index j (the reference processes a
    vertex's occurrences in order, and later steps observe earlier
    mutations — so j is the sequential axis, lanes the vector axis),
  * per step: upper_bound via vmapped searchsorted, the Within test,
    strand-dependent candidate pick, the compatibility test with
    used-between as a *range query over the phase-frozen used prefix sums*
    (the batched explorer runs against a frozen snapshot, exactly like the
    reference's speculative phase), the branch-bound adjacency escape, and
    either an in-place ChangeBack or a masked-shift insert.

Exactness: verified state-identical to the host lockstep (and therefore to
the oracle Path) across lanes and multi-step pushes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sibeliaz_tpu.junctions.table import JunctionTable
from sibeliaz_tpu.lcb.batched_push import I_CAP, LaneState
from sibeliaz_tpu.lcb.oracle import LcbEngine

P_CAP = 1024  # path vertices per lane
BIG = np.int64(1) << 60  # numpy, NOT jnp (device-constant lowering fetch)


def _padded(a: np.ndarray, fill, lo: int = 1024) -> np.ndarray:
    """Pad a 1-D array to the next power-of-two length (min `lo`)."""
    n = len(a)
    m = lo if n <= 1 else max(lo, 1 << (n - 1).bit_length())
    if m == n:
        return a
    out = np.full(m, fill, a.dtype)
    out[:n] = a
    return out


@dataclasses.dataclass
class DeviceTables:
    """Flat device copies of the junction table + phase-frozen used prefix."""

    chr_off: jnp.ndarray  # [n_chr+1]
    chr_len: jnp.ndarray  # [n_chr]
    jpos: jnp.ndarray  # [total]
    jid: jnp.ndarray  # [total]
    used_pfx: jnp.ndarray  # [total+1] exclusive prefix of used flags
    used: jnp.ndarray  # [total] the frozen flags themselves
    seq_off: jnp.ndarray  # [n_chr+1]
    seq: jnp.ndarray  # [sum len] uint8
    occ_off: jnp.ndarray  # [V+1]
    occ_chr: jnp.ndarray
    occ_idx: jnp.ndarray
    occ_ch: jnp.ndarray  # [n_occ] uint8 annotation char (+ strand)
    occ_revch: jnp.ndarray  # [n_occ] uint8 annotation char (- strand)
    k: int

    @classmethod
    def build(cls, table: JunctionTable) -> "DeviceTables":
        n_chr = table.n_chr
        chr_off = table.chr_off
        used_all = table.used_flat
        pfx = np.zeros(len(used_all) + 1, np.int64)
        np.cumsum(used_all, out=pfx[1:])
        seq_off = table.seq_off
        # All flat arrays are padded to power-of-two buckets so every jit
        # program over DeviceTables caches across inputs of similar size
        # (each distinct table shape is otherwise a fresh compile).  Every
        # consumer clips indices
        # and masks junk-row results, so padding is semantics-free;
        # offset-style arrays pad with their LAST value (so derived counts
        # for out-of-range ids are 0), data arrays with 0 / 'N'.
        return cls(
            chr_off=jnp.asarray(_padded(chr_off, chr_off[-1], lo=4)),
            chr_len=jnp.asarray(_padded(np.diff(chr_off), 0, lo=4)),
            jpos=jnp.asarray(_padded(table.jpos_flat, 0)),
            jid=jnp.asarray(_padded(table.jid_flat, 0)),
            used_pfx=jnp.asarray(_padded(pfx, pfx[-1])),
            used=jnp.asarray(_padded(used_all, 0)),
            seq_off=jnp.asarray(_padded(seq_off, seq_off[-1], lo=4)),
            seq=jnp.asarray(_padded(table.seq_flat, ord("N"))),
            occ_off=jnp.asarray(_padded(
                table.occ_off.astype(np.int64), table.occ_off[-1]
            )),
            occ_chr=jnp.asarray(_padded(table.occ_chr.astype(np.int64), 0)),
            occ_idx=jnp.asarray(_padded(table.occ_idx.astype(np.int64), 0)),
            occ_ch=jnp.asarray(_padded(table.occ_ch, 0)),
            occ_revch=jnp.asarray(_padded(table.occ_revch, 0)),
            k=table.k,
        )


@dataclasses.dataclass
class DeviceLanes:
    """Batched lane state on device (instance arrays + path table)."""

    chr: jnp.ndarray  # [L, I_CAP] int64, -1 pad (sorted with cmp key)
    s: jnp.ndarray  # [L, I_CAP] int64 (+-1)
    fi: jnp.ndarray
    bi: jnp.ndarray
    fdist: jnp.ndarray
    bdist: jnp.ndarray
    cmp: jnp.ndarray
    ffin: jnp.ndarray  # bool
    bfin: jnp.ndarray  # bool
    good_seq: jnp.ndarray  # int64, -1 = not good
    insert_seq: jnp.ndarray
    n: jnp.ndarray  # [L]
    next_good: jnp.ndarray  # [L]
    next_insert: jnp.ndarray  # [L]
    right_flank: jnp.ndarray  # [L]
    left_flank: jnp.ndarray  # [L]
    overflow: jnp.ndarray  # [L] bool
    pvid: jnp.ndarray  # [L, P_CAP] int64 sorted, BIG pad
    pdist: jnp.ndarray  # [L, P_CAP] int64
    pn: jnp.ndarray  # [L]
    # path-end vertex registers (the mirror's right_vertex/left_vertex,
    # oracle.py Path.right_vertex/left_vertex): updated on successful
    # pushes, snapshotted/restored with the lane slab
    rv: jnp.ndarray  # [L] int64 signed vid at the path's right end
    lv: jnp.ndarray  # [L] int64 signed vid at the path's left end

    @classmethod
    def from_host(cls, lanes: Sequence[LaneState]) -> "DeviceLanes":
        L = len(lanes)

        def stack(attr, dtype=np.int64):
            return jnp.asarray(
                np.stack([getattr(st, attr).astype(dtype) for st in lanes])
            )

        pvid = np.full((L, P_CAP), int(2**60), np.int64)
        pdist = np.zeros((L, P_CAP), np.int64)
        pn = np.zeros(L, np.int64)
        for l, st in enumerate(lanes):
            items = sorted(st.dist.items())
            pn[l] = len(items)
            for t, (v, dv) in enumerate(items):
                pvid[l, t] = v
                pdist[l, t] = dv
        return cls(
            chr=stack("chr"), s=stack("s"), fi=stack("fi"), bi=stack("bi"),
            fdist=stack("fdist"), bdist=stack("bdist"), cmp=stack("cmp"),
            ffin=stack("ffin", bool), bfin=stack("bfin", bool),
            good_seq=stack("good_seq"), insert_seq=stack("insert_seq"),
            n=jnp.asarray(np.array([st.n for st in lanes], np.int64)),
            next_good=jnp.asarray(
                np.array([st.next_good for st in lanes], np.int64)
            ),
            next_insert=jnp.asarray(
                np.array([st.next_insert for st in lanes], np.int64)
            ),
            right_flank=jnp.asarray(
                np.array([st.right_flank for st in lanes], np.int64)
            ),
            left_flank=jnp.asarray(
                np.array([st.left_flank for st in lanes], np.int64)
            ),
            overflow=jnp.asarray(
                np.array([st.overflow for st in lanes], bool)
            ),
            pvid=jnp.asarray(pvid),
            pdist=jnp.asarray(pdist),
            pn=jnp.asarray(pn),
            rv=jnp.asarray(
                np.array([st.origin for st in lanes], np.int64)
            ),
            lv=jnp.asarray(
                np.array([st.origin for st in lanes], np.int64)
            ),
        )

    def to_host(self, lanes: Sequence[LaneState]) -> None:
        """Write device state back into the host LaneStates (for tests)."""
        host = {
            f: np.asarray(getattr(self, f))
            for f in (
                "chr", "s", "fi", "bi", "fdist", "bdist", "cmp", "ffin",
                "bfin", "good_seq", "insert_seq", "n", "next_good",
                "next_insert", "right_flank", "left_flank", "overflow",
                "pvid", "pdist", "pn",
            )
        }
        for l, st in enumerate(lanes):
            st.chr = host["chr"][l].astype(np.int32)
            st.s = host["s"][l].astype(np.int8)
            for f in ("fi", "bi", "fdist", "bdist", "cmp", "good_seq",
                      "insert_seq"):
                setattr(st, f, host[f][l].astype(np.int64))
            st.ffin = host["ffin"][l].astype(bool)
            st.bfin = host["bfin"][l].astype(bool)
            st.n = int(host["n"][l])
            st.next_good = int(host["next_good"][l])
            st.next_insert = int(host["next_insert"][l])
            st.right_flank = int(host["right_flank"][l])
            st.left_flank = int(host["left_flank"][l])
            st.overflow = bool(host["overflow"][l])
            st.dist = {
                int(v): int(d)
                for v, d in zip(
                    host["pvid"][l][: int(host["pn"][l])],
                    host["pdist"][l][: int(host["pn"][l])],
                )
            }


_COMP_TBL = np.array(  # numpy, NOT jnp (device-constant lowering fetch)
    [0] * 65 + [ord("T")] + [0] * 1 + [ord("G")] + [0] * 3
    + [ord("C")] + [0] * 12 + [ord("A")] + [0] * 171,
    dtype=np.int64,
)


def edge_of(tb: DeviceTables, c, i, s, fwd):
    """Device twin of LcbEngine.out_edge/in_edge (oracle.py:180-208;
    junctionstorage.h:191-227): the edge at iterator (chr c, idx i, strand
    s) in direction fwd, as (u, v, ch, rev, length) int64 vectors.  All
    inputs are [L] vectors; out-of-range neighbor indices are clipped (the
    caller must only use rows whose walk is in range, exactly like the
    reference only builds edges between consecutive junctions)."""
    base = tb.chr_off[jnp.clip(c, 0, tb.chr_off.shape[0] - 2)]
    nbr = jnp.where(fwd, i + s, i - s)  # the other junction of the edge
    idx_self = jnp.clip(base + i, 0, tb.jid.shape[0] - 1)
    idx_nbr = jnp.clip(base + nbr, 0, tb.jid.shape[0] - 1)
    id_self = tb.jid[idx_self]
    id_nbr = tb.jid[idx_nbr]
    u = jnp.where(fwd, s * id_self, s * id_nbr)
    v = jnp.where(fwd, s * id_nbr, s * id_self)
    p_self = tb.jpos[idx_self]
    p_nbr = tb.jpos[idx_nbr]
    length = jnp.abs(p_nbr - p_self)
    p_start = jnp.where(fwd, p_self, p_nbr)  # the edge's start junction
    p_end = jnp.where(fwd, p_nbr, p_self)
    sq_off = tb.seq_off[jnp.clip(c, 0, tb.seq_off.shape[0] - 2)]
    sq_len = tb.seq_off[jnp.clip(c + 1, 0, tb.seq_off.shape[0] - 1)] - sq_off

    def byte_at(p):
        return tb.seq[jnp.clip(sq_off + p, 0, tb.seq.shape[0] - 1)].astype(
            jnp.int64
        )

    # staged literal (np host constant); hoisted out of comp_at so tracing
    # stages it once per edge_of call, not once per position
    tbl = jnp.asarray(_COMP_TBL)

    def comp_at(p):  # complement(seq[p-1]), 'N' at the chromosome edge
        bb = byte_at(p - 1)
        return jnp.where(
            p > 0,
            jnp.where(tbl[bb] > 0, tbl[bb], ord("N")),
            ord("N"),
        )

    # label char: + strand reads the start junction's successor byte,
    # - strand the complement of its predecessor (oracle.py:180-208)
    ch = jnp.where(
        s > 0,
        jnp.where(p_start + tb.k < sq_len, byte_at(p_start + tb.k), 0),
        comp_at(p_start),
    )
    # rc label: + strand reads complement at the end junction; - strand
    # reads seq[p_self + k] in BOTH directions (the oracle/reference read
    # it at the iterator itself: out_edge's start, in_edge's end)
    rev = jnp.where(
        s > 0,
        comp_at(p_end),
        jnp.where(p_self + tb.k < sq_len, byte_at(p_self + tb.k), 0),
    )
    return u, v, ch, rev, length


def _row_insert(arr, p, val, n):
    """Insert val at position p (shift right); rows are [L, CAP]."""
    L, CAP = arr.shape
    col = jnp.arange(CAP, dtype=jnp.int64)[None, :]
    shifted = jnp.concatenate([arr[:, :1], arr[:, :-1]], axis=1)
    return jnp.where(
        col < p[:, None],
        arr,
        jnp.where(col == p[:, None], val[:, None], shifted),
    )


def _push_impl(max_occ, forward: bool, tb: DeviceTables, ln: DeviceLanes,
               eu, ev, ech, elen, evalid, m, b):
    """Apply push_back (forward=True) or push_front to every valid lane."""
    L = ln.chr.shape[0]
    fwd = jnp.full((L,), bool(forward))
    return _push_impl_traced(max_occ, fwd, tb, ln, eu, ev, ech, elen,
                             evalid, m, b)


def _push_impl_traced(max_occ, fwd, tb: DeviceTables, ln: DeviceLanes,
                      eu, ev, ech, elen, evalid, m, b):
    """Apply push_back (fwd[l]=True) or push_front per lane, mixed in one
    program — the direction is a traced [L] bool vector, so a single
    invocation serves lanes in different protocol phases (the prerequisite
    for running the whole phase state machine inside one lax.while_loop).
    Direction differences (pushed vertex = edge end vs start, distance
    sign, candidate polarity, compatibility endpoint roles, which end of
    the instance mutates) become jnp.where selects; when `fwd` is a
    broadcast constant XLA folds them back to the static program."""
    L = ln.chr.shape[0]
    lanes_i = jnp.arange(L, dtype=jnp.int64)
    vtx = jnp.where(fwd, ev, eu)

    # ---- membership + path-table insert ----
    pp = jax.vmap(jnp.searchsorted)(ln.pvid, vtx)
    member = (
        jnp.take_along_axis(ln.pvid, pp[:, None], axis=1)[:, 0] == vtx
    ) & (pp < ln.pn)
    success = evalid & ~member & ~ln.overflow
    dval = jnp.where(
        fwd, ln.right_flank + elen, ln.left_flank - elen
    )
    pvid = jnp.where(
        success[:, None], _row_insert(ln.pvid, pp, vtx, ln.pn), ln.pvid
    )
    pdist = jnp.where(
        success[:, None], _row_insert(ln.pdist, pp, dval, ln.pn), ln.pdist
    )
    pn = jnp.where(success, ln.pn + 1, ln.pn)
    PC = ln.pvid.shape[1]  # path-slab width (tiered; P_CAP is the max)
    IC = ln.chr.shape[1]  # instance-slab width (tiered; I_CAP is the max)
    poverflow = ln.overflow | (success & (ln.pn >= PC - 1))

    av = jnp.abs(vtx)
    occ_lo = tb.occ_off[jnp.clip(av, 0, tb.occ_off.shape[0] - 2)]
    occ_cnt = tb.occ_off[jnp.clip(av + 1, 0, tb.occ_off.shape[0] - 1)] - occ_lo

    state = dict(
        chr=ln.chr, s=ln.s, fi=ln.fi, bi=ln.bi, fdist=ln.fdist,
        bdist=ln.bdist, cmp=ln.cmp, ffin=ln.ffin, bfin=ln.bfin,
        good_seq=ln.good_seq, insert_seq=ln.insert_seq, n=ln.n,
        next_good=ln.next_good, next_insert=ln.next_insert,
        overflow=poverflow,
    )

    def occ_step(j, state):
        act = success & (j < occ_cnt) & ~state["overflow"]
        oi = jnp.clip(occ_lo + j, 0, tb.occ_chr.shape[0] - 1)
        c = tb.occ_chr[oi]
        i = tb.occ_idx[oi]
        base = tb.chr_off[jnp.clip(c, 0, tb.chr_off.shape[0] - 2)]
        stored = tb.jid[jnp.clip(base + i, 0, tb.jid.shape[0] - 1)]
        s_ = jnp.where(stored == vtx, jnp.int64(1), jnp.int64(-1))

        keys = (state["chr"] << 40) | state["cmp"]
        keys = jnp.where(
            jnp.arange(IC, dtype=jnp.int64)[None, :] < state["n"][:, None],
            keys,
            BIG,
        )
        kq = (c << 40) | i
        p = jax.vmap(functools.partial(jnp.searchsorted, side="right"))(
            keys, kq
        )

        def gather(f, q):
            return jnp.take_along_axis(
                state[f], jnp.clip(q, 0, IC - 1)[:, None], axis=1
            )[:, 0]

        in_chr = (p < state["n"]) & (gather("chr", p) == c)
        fi_p, bi_p = gather("fi", p), gather("bi", p)
        within = in_chr & (jnp.minimum(fi_p, bi_p) <= i) & (
            i <= jnp.maximum(fi_p, bi_p)
        )

        use_prev = jnp.where(fwd, s_ > 0, s_ < 0)
        cand = jnp.where(use_prev, p - 1, p)
        prev_ok = (p - 1 >= 0) & (gather("chr", p - 1) == c)
        cand_ok = jnp.where(use_prev, prev_ok, in_chr)

        # ---- compatibility ----
        cc = gather("chr", cand)
        cs = gather("s", cand)
        # cand's mutable end: back on forward pushes, front on backward
        cend = jnp.where(fwd, gather("bi", cand), gather("fi", cand))
        same_strand = cs == s_
        # strand-aware used-slot range between start and end iterators
        # forward: start = cand.back, end = seq_it; backward: swapped
        start_i = jnp.where(fwd, cend, i)
        end_i = jnp.where(fwd, i, cend)
        lo_slot = jnp.where(s_ > 0, start_i, end_i)
        hi_slot = jnp.where(s_ > 0, end_i, start_i)
        cbase = tb.chr_off[jnp.clip(cc, 0, tb.chr_off.shape[0] - 2)]
        qlo = jnp.clip(cbase + lo_slot, 0, tb.used_pfx.shape[0] - 1)
        qhi = jnp.clip(cbase + hi_slot, 0, tb.used_pfx.shape[0] - 1)
        used_between = jnp.where(
            hi_slot > lo_slot, tb.used_pfx[qhi] - tb.used_pfx[qlo] > 0, False
        )
        pos_start = tb.jpos[
            jnp.clip(cbase + start_i, 0, tb.jpos.shape[0] - 1)
        ] + jnp.where(s_ < 0, tb.k, 0)
        pos_end = tb.jpos[
            jnp.clip(cbase + end_i, 0, tb.jpos.shape[0] - 1)
        ] + jnp.where(s_ < 0, tb.k, 0)
        real_diff = pos_end - pos_start
        # ancestral diff = dist[end.vid] - dist[start.vid]
        cvid = cs * tb.jid[jnp.clip(cbase + cend, 0, tb.jid.shape[0] - 1)]
        cp = jax.vmap(jnp.searchsorted)(pvid, cvid)
        cdist = jnp.take_along_axis(
            pdist, jnp.clip(cp, 0, PC - 1)[:, None], axis=1
        )[:, 0]
        anc_diff = jnp.where(fwd, dval - cdist, cdist - dval)
        dir_ok = jnp.where(s_ > 0, real_diff >= 0, -real_diff >= 0)
        over = (jnp.abs(real_diff) > b) | (anc_diff > b)
        # adjacency escape: start.Next() == end, chars match, next vid == ev
        nxt_i = start_i + s_
        nxt_valid = (nxt_i >= 0) & (
            nxt_i < tb.chr_len[jnp.clip(cc, 0, tb.chr_len.shape[0] - 1)]
        )
        spos_abs = tb.jpos[jnp.clip(cbase + start_i, 0, tb.jpos.shape[0] - 1)]
        sq_off = tb.seq_off[jnp.clip(cc, 0, tb.seq_off.shape[0] - 2)]
        sq_len = (
            tb.seq_off[jnp.clip(cc + 1, 0, tb.seq_off.shape[0] - 1)] - sq_off
        )
        ch_plus = jnp.where(
            spos_abs + tb.k < sq_len,
            tb.seq[jnp.clip(sq_off + spos_abs + tb.k, 0, tb.seq.shape[0] - 1)],
            0,
        )
        prev_byte = tb.seq[
            jnp.clip(sq_off + spos_abs - 1, 0, tb.seq.shape[0] - 1)
        ]
        comp_tbl = jnp.array(
            [0] * 65 + [ord("T")] + [0] * 1 + [ord("G")] + [0] * 3
            + [ord("C")] + [0] * 12 + [ord("A")] + [0] * 171,
            dtype=jnp.int64,
        )
        ch_minus = jnp.where(
            spos_abs > 0,
            jnp.where(comp_tbl[prev_byte] > 0, comp_tbl[prev_byte], ord("N")),
            ord("N"),
        )
        start_char = jnp.where(s_ > 0, ch_plus, ch_minus)
        nvid = s_ * tb.jid[
            jnp.clip(cbase + jnp.clip(nxt_i, 0, None), 0, tb.jid.shape[0] - 1)
        ]
        end_is_next = nxt_i == end_i
        escape = nxt_valid & (start_char == ech) & end_is_next & (nvid == ev)
        compat = (
            cand_ok & same_strand & ~used_between & dir_ok & (~over | escape)
        )

        do_update = act & ~within & compat & (cvid != vtx)
        cfin = jnp.where(fwd, gather("bfin", cand), gather("ffin", cand))
        do_change = do_update & ~cfin
        uslot = jnp.where(s_ > 0, base + i, base + i - 1)
        u = jnp.where(
            (s_ > 0) | (i > 0),
            tb.used[jnp.clip(uslot, 0, tb.used.shape[0] - 1)] > 0,
            False,
        )

        c_other = jnp.where(fwd, gather("fi", cand), gather("bi", cand))
        jp_other = tb.jpos[
            jnp.clip(cbase + c_other, 0, tb.jpos.shape[0] - 1)
        ]
        jp_end_old = tb.jpos[jnp.clip(cbase + cend, 0, tb.jpos.shape[0] - 1)]
        was_good = jnp.abs(jp_other - jp_end_old) >= m
        jp_end_new = tb.jpos[jnp.clip(base + i, 0, tb.jpos.shape[0] - 1)]
        now_good = jnp.abs(jp_other - jp_end_new) >= m

        def set_at(f, val, mask):
            cur = state[f]
            ci = jnp.clip(cand, 0, IC - 1)
            return cur.at[lanes_i, ci].set(
                jnp.where(mask, val, cur[lanes_i, ci])
            )

        state["bi"] = set_at("bi", i, do_change & fwd)
        state["bdist"] = set_at("bdist", dval, do_change & fwd)
        state["fi"] = set_at("fi", i, do_change & ~fwd)
        state["fdist"] = set_at("fdist", dval, do_change & ~fwd)
        cmp_strand = jnp.where(fwd, cs > 0, cs < 0)
        state["cmp"] = set_at("cmp", i, do_change & cmp_strand)
        newly_good = do_change & ~was_good & now_good
        state["good_seq"] = set_at("good_seq", state["next_good"], newly_good)
        state["next_good"] = jnp.where(
            newly_good, state["next_good"] + 1, state["next_good"]
        )
        state["bfin"] = set_at("bfin", True, do_change & u & fwd)
        state["ffin"] = set_at("ffin", True, do_change & u & ~fwd)

        do_insert = act & ~within & ~u & ~(compat & (cvid != vtx))
        room = state["n"] < IC
        ins = do_insert & room
        state["overflow"] = state["overflow"] | (do_insert & ~room)
        for f, val in (
            ("chr", c), ("s", s_), ("fi", i), ("bi", i),
            ("fdist", dval), ("bdist", dval), ("cmp", i),
            ("insert_seq", state["next_insert"]),
        ):
            shifted = _row_insert(state[f], p, val, state["n"])
            state[f] = jnp.where(ins[:, None], shifted, state[f])
        for f in ("ffin", "bfin"):
            shifted = _row_insert(
                state[f].astype(jnp.int64), p, jnp.zeros(L, jnp.int64),
                state["n"],
            ).astype(bool)
            state[f] = jnp.where(ins[:, None], shifted, state[f])
        shifted = _row_insert(
            state["good_seq"], p, jnp.full((L,), -1, jnp.int64), state["n"]
        )
        state["good_seq"] = jnp.where(ins[:, None], shifted, state["good_seq"])
        state["n"] = jnp.where(ins, state["n"] + 1, state["n"])
        state["next_insert"] = jnp.where(
            ins, state["next_insert"] + 1, state["next_insert"]
        )
        return state

    state = jax.lax.fori_loop(0, max_occ, occ_step, state)
    right_flank = jnp.where(success & fwd, dval, ln.right_flank)
    left_flank = jnp.where(success & ~fwd, dval, ln.left_flank)
    rv = jnp.where(success & fwd, ev, ln.rv)
    lv = jnp.where(success & ~fwd, eu, ln.lv)
    out = DeviceLanes(
        chr=state["chr"], s=state["s"], fi=state["fi"], bi=state["bi"],
        fdist=state["fdist"], bdist=state["bdist"], cmp=state["cmp"],
        ffin=state["ffin"], bfin=state["bfin"],
        good_seq=state["good_seq"], insert_seq=state["insert_seq"],
        n=state["n"], next_good=state["next_good"],
        next_insert=state["next_insert"], right_flank=right_flank,
        left_flank=left_flank, overflow=state["overflow"],
        pvid=pvid, pdist=pdist, pn=pn, rv=rv, lv=lv,
    )
    return out, success


# jitted entry point (the resident engine re-uses _push_impl inside its own
# fused program, see lcb/resident.py).  max_occ is traced (fori_loop bound),
# so occurrence-count variation does not trigger recompilation.
_push_device = functools.partial(jax.jit, static_argnums=(1,))(_push_impl)


jax.tree_util.register_pytree_node(
    DeviceLanes,
    lambda ln: (
        tuple(getattr(ln, f.name) for f in dataclasses.fields(ln)),
        None,
    ),
    lambda aux, ch: DeviceLanes(*ch),
)
jax.tree_util.register_pytree_node(
    DeviceTables,
    lambda tb: (
        tuple(
            getattr(tb, f.name)
            for f in dataclasses.fields(tb)
            if f.name != "k"
        ),
        tb.k,
    ),
    lambda aux, ch: DeviceTables(*ch, k=aux),
)


def _pad_lanes(lanes):
    """Pad the lane list to a power-of-two bucket (min 32) so jit shapes
    are reused across calls while small batches stay small."""
    L = len(lanes)
    Lp = max(32, 1 << (L - 1).bit_length() if L > 1 else 1)
    padded = list(lanes)
    while len(padded) < Lp:
        padded.append(LaneState(
            origin=0, n=0,
            chr=np.full(I_CAP, -1, np.int32), s=np.zeros(I_CAP, np.int8),
            fi=np.zeros(I_CAP, np.int64), bi=np.zeros(I_CAP, np.int64),
            fdist=np.zeros(I_CAP, np.int64), bdist=np.zeros(I_CAP, np.int64),
            cmp=np.zeros(I_CAP, np.int64), ffin=np.zeros(I_CAP, bool),
            bfin=np.zeros(I_CAP, bool), good_seq=np.full(I_CAP, -1, np.int64),
            insert_seq=np.zeros(I_CAP, np.int64), dist={0: 0},
        ))
    return padded


def _run_push(table, lanes, edges, eng, forward):
    tb = DeviceTables.build(table)
    lanes_p = _pad_lanes(lanes)
    ln = DeviceLanes.from_host(lanes_p)
    L = len(lanes_p)
    eu = np.zeros(L, np.int64)
    ev = np.zeros(L, np.int64)
    ech = np.zeros(L, np.int64)
    elen = np.zeros(L, np.int64)
    evalid = np.zeros(L, bool)
    max_occ = 1
    for l, edge in enumerate(edges):
        if edge is None:
            continue
        eu[l], ev[l], ech[l], _, elen[l] = edge
        evalid[l] = True
        v = abs(edge[1] if forward else edge[0])
        max_occ = max(
            max_occ, int(table.occ_off[v + 1] - table.occ_off[v])
        )
    out, success = _push_device(
        jnp.int64(max_occ), forward, tb, ln,
        jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(ech),
        jnp.asarray(elen), jnp.asarray(evalid),
        jnp.int64(eng.m), jnp.int64(eng.b),
    )
    out.to_host(lanes_p)
    return [bool(x) for x in np.asarray(success)][: len(lanes)]


def push_back_batch_device(
    table: JunctionTable,
    lanes: Sequence[LaneState],
    edges: Sequence[Optional[Tuple[int, int, int, int, int]]],
    eng: LcbEngine,
) -> List[bool]:
    """Device push_back; mutates the host LaneStates with device results.
    Requires a phase-frozen `used` state."""
    return _run_push(table, lanes, edges, eng, True)


def push_front_batch_device(
    table: JunctionTable,
    lanes: Sequence[LaneState],
    edges: Sequence[Optional[Tuple[int, int, int, int, int]]],
    eng: LcbEngine,
) -> List[bool]:
    """Device push_front (mirror); same contract as push_back_batch_device."""
    return _run_push(table, lanes, edges, eng, False)
