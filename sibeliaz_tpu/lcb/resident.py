"""Resident device LCB engine (batched-LCB slice 10).

The slice-9 prototype (lcb/batched_device_process.py) proved the batched
primitives exact but round-trips full lane state host<->device on every
call.  Here the whole phase's lane state LIVES ON DEVICE:

  * `ResidentState` = current lanes + two snapshot slabs + best-score
    registers, all [256, I_CAP]-shaped device arrays;
  * one fused jit program per push round applies PointPushBack + Score +
    best-snapshot/rewind-slab maintenance (copy-on-improve) and returns
    only O(lanes) scalars (success, score, improved, n, overflow);
  * votes run on device over row-gathered read-only copies with tiered
    (instances, window) shape buckets and escalation on window overflow;
  * the reference's best-prefix rewind (blocksfinder.h:271-284) becomes a
    masked slab restore: replaying the successful-push prefix from the seed
    against the phase-frozen `used` snapshot reproduces the state at the
    improving push exactly (pushes are deterministic and failed pushes do
    not mutate), so snapshotting at each improvement IS the replay result;
  * the per-lane protocol (forward minRun sweeps, rewind, backward sweeps
    with the stray-';' semantics, blocksfinder.h:228-310) stays as a host
    generator, but it only touches mirror scalars (flanks, edge lists) —
    never instance state.

Lanes exceeding any capacity (instances I_CAP, path P_CAP, vote window)
fall back to the host oracle for that bundle — exactness is never traded.
The serial validate/commit loop stays in LcbEngine.run (it defines the
deterministic output order).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sibeliaz_tpu.junctions.table import JunctionTable
from sibeliaz_tpu.lcb.batched import seed_batch
from sibeliaz_tpu.lcb.batched_push import I_CAP
from sibeliaz_tpu.lcb.batched_push_device import (
    P_CAP,
    DeviceLanes,
    DeviceTables,
    _push_impl_traced,
)
from sibeliaz_tpu.lcb.oracle import Bundle, Instance, LcbEngine

BIG = int(1) << 60
PHASE_LANES = 256
VOTE_TIERS = ((64, 16), (I_CAP, 16), (I_CAP, 256))  # (instance cap, window)


@dataclasses.dataclass
class ResidentState:
    ln: DeviceLanes  # live lane state
    rw: DeviceLanes  # rewind slab: state at the best forward prefix
    sn: DeviceLanes  # result slab: good list at the best positive score
    best_score: jnp.ndarray  # [L] int64
    has_snap: jnp.ndarray  # [L] bool: ever improved with positive score


jax.tree_util.register_pytree_node(
    ResidentState,
    lambda st: ((st.ln, st.rw, st.sn, st.best_score, st.has_snap), None),
    lambda aux, ch: ResidentState(*ch),
)


def _lanes_where(mask, a: DeviceLanes, b: DeviceLanes) -> DeviceLanes:
    def sel(x, y):
        m = mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(m, x, y)

    return jax.tree_util.tree_map(sel, a, b)


# --------------------------------------------------------------------------
# fused push round: PointPushBack + Score + snapshot maintenance
# --------------------------------------------------------------------------


def _score_of(tb: DeviceTables, ln: DeviceLanes, flank):
    from sibeliaz_tpu.lcb.oracle import NEG_INF_SCORE

    col = jnp.arange(ln.chr.shape[1], dtype=jnp.int64)[None, :]
    live = (col < ln.n[:, None]) & (ln.good_seq >= 0)
    base = tb.chr_off[jnp.clip(ln.chr, 0, tb.chr_off.shape[0] - 2)]
    jf = tb.jpos[jnp.clip(base + ln.fi, 0, tb.jpos.shape[0] - 1)]
    jb = tb.jpos[jnp.clip(base + ln.bi, 0, tb.jpos.shape[0] - 1)]
    real = jnp.abs(jf - jb)
    right_pen = ln.right_flank[:, None] - ln.bdist
    left_pen = -ln.left_flank[:, None] + ln.fdist
    bad = live & ((left_pen >= flank) | (right_pen >= flank))
    contrib = jnp.where(live, real - (right_pen + left_pen) ** 2, 0)
    total = jnp.sum(contrib, axis=1)
    return jnp.where(jnp.any(bad, axis=1), jnp.int64(NEG_INF_SCORE), total)


def _push_score_snap(max_occ, fwd, tb: DeviceTables,
                     st: ResidentState, eu, ev, ech, elen, evalid, m, b,
                     flank):
    """One traced-direction push + score + snapshot maintenance; fwd is a
    per-lane bool vector (broadcast constant for single-direction use)."""
    out, success = _push_impl_traced(
        max_occ, fwd, tb, st.ln, eu, ev, ech, elen, evalid, m, b
    )
    score = _score_of(tb, out, flank)
    improved = success & (score > st.best_score)
    best_score = jnp.where(improved, score, st.best_score)
    # forward pushes only happen during the forward sweep (the rewind is a
    # slab restore, not a replay), so copy-on-improve maintains the rewind
    # slab exactly at `best_right` (blocksfinder.h:271-284 semantics)
    rw = _lanes_where(improved & fwd, out, st.rw)
    sn = _lanes_where(improved & (score > 0), out, st.sn)
    has_snap = st.has_snap | (improved & (score > 0))
    new_st = ResidentState(
        ln=out, rw=rw, sn=sn, best_score=best_score, has_snap=has_snap
    )
    return new_st, success, score, improved, out.n, out.overflow


@functools.partial(jax.jit, static_argnums=(1,))
def _push_round(max_occ, forward: bool, tb: DeviceTables, st: ResidentState,
                eu, ev, ech, elen, evalid, m, b, flank):
    fwd = jnp.full(st.ln.chr.shape[:1], bool(forward))
    return _push_score_snap(
        max_occ, fwd, tb, st, eu, ev, ech, elen, evalid, m, b, flank
    )


_MAX_WALK = 2048  # safety bound; walks are <= the vote window by design


@jax.jit
def _walk_device(tb: DeviceTables, st: ResidentState, rows, c, i0, s, fwd,
                 tvid, m, b, flank):
    """Walk each gathered lane from its vote origin to the winner entirely
    on device: one lax.while_loop steps all lanes in lockstep, computing
    each push's edge with edge_of (no host edge precomputation) and
    applying the traced-direction push+score+snapshot.  Mixed directions
    share the call.  Returns, per gathered row: last-push success, current
    score, n, right/left flanks, and overflow — the only scalars the host
    protocol needs (path-end vertices live in the rv/lv lane registers).

    `rows` is [A] with sentinel L for padding; (c, i0, s) is the vote's
    origin iterator; tvid the winning vertex (blocksfinder.h:770-895)."""
    from sibeliaz_tpu.lcb.batched_push_device import edge_of

    L = st.ln.chr.shape[0]
    take = jnp.clip(rows, 0, L - 1)
    work = jax.tree_util.tree_map(lambda x: x[take], st)
    valid_row = rows < L
    base = tb.chr_off[jnp.clip(c, 0, tb.chr_off.shape[0] - 2)]

    def vid_at(i):
        return s * tb.jid[jnp.clip(base + i, 0, tb.jid.shape[0] - 1)]

    active0 = valid_row & (vid_at(i0) != tvid)
    last0 = jnp.zeros_like(active0)

    def cond(carry):
        _, _, active, _, steps = carry
        return jnp.any(active) & (steps < _MAX_WALK)

    def body(carry):
        w, i, active, last, steps = carry
        eu, ev, ech, _, elen = edge_of(tb, c, i, s, fwd)
        av = jnp.abs(jnp.where(fwd, ev, eu))
        occ_cnt = tb.occ_off[jnp.clip(av + 1, 0, tb.occ_off.shape[0] - 1)] \
            - tb.occ_off[jnp.clip(av, 0, tb.occ_off.shape[0] - 2)]
        mo = jnp.max(jnp.where(active, occ_cnt, 0))
        w2, success, _, _, _, ovf = _push_score_snap(
            mo, fwd, tb, w, eu, ev, ech, elen, active, m, b, flank
        )
        i2 = jnp.where(active, i + jnp.where(fwd, s, -s), i)
        last2 = jnp.where(active, success, last)
        active2 = active & (vid_at(i2) != tvid) & ~ovf
        return (w2, i2, active2, last2, steps + 1)

    work, _, _, last, _ = jax.lax.while_loop(
        cond, body, (work, i0, active0, last0, jnp.int64(0))
    )
    st = jax.tree_util.tree_map(
        lambda full, w: full.at[rows].set(w, mode="drop"), st, work
    )
    score = _score_of(tb, work.ln, flank)
    return (st, last, score, work.ln.n, work.ln.right_flank,
            work.ln.left_flank, work.ln.overflow)


@jax.jit
def _rewind_rows(st: ResidentState, rows):
    """Masked slab restore for the gathered lanes (sentinel rows dropped)."""
    L = st.ln.chr.shape[0]
    take = jnp.clip(rows, 0, L - 1)
    ln = jax.tree_util.tree_map(
        lambda full, slab: full.at[rows].set(slab[take], mode="drop"),
        st.ln, st.rw,
    )
    return ResidentState(
        ln=ln, rw=st.rw, sn=st.sn, best_score=st.best_score,
        has_snap=st.has_snap,
    )


# --------------------------------------------------------------------------
# vote round: gathered read-only MostPopularVertex with per-lane direction
# --------------------------------------------------------------------------


def _vote_gathered(CAP: int, W: int, tb: DeviceTables, ln: DeviceLanes,
                   idx, valid, forward, try_used, depth, b):
    """Vote for the gathered lanes idx (read-only; invalid rows inert).

    Per-lane traced `forward`/`try_used` so one program serves mixed
    directions.  The start vertex is the lane's own path-end register
    (rv forward, lv backward) — the host no longer supplies it.  Returns
    (best_vid, best_cnt, origin chr/idx/strand, window-overflow) per
    gathered row."""
    take = lambda a: jnp.take(a, idx, axis=0)
    start_vid = jnp.where(
        valid,
        jnp.where(forward, take(ln.rv), take(ln.lv)),
        jnp.int64(1) << 60,
    )
    chr_ = take(ln.chr)[:, :CAP]
    s = take(ln.s)[:, :CAP]
    fi = take(ln.fi)[:, :CAP]
    bi = take(ln.bi)[:, :CAP]
    good_seq = take(ln.good_seq)[:, :CAP]
    insert_seq = take(ln.insert_seq)[:, :CAP]
    n = jnp.where(valid, take(ln.n), 0)
    pvid = take(ln.pvid)
    pn = take(ln.pn)

    L = chr_.shape[0]
    col = jnp.arange(CAP, dtype=jnp.int64)[None, :]
    live = col < n[:, None]

    good = good_seq >= 0
    n_good = jnp.sum((good & live).astype(jnp.int64), axis=1)
    use_good = n_good >= 2
    in_list = jnp.where(use_good[:, None], good & live, live)
    order_seq = jnp.where(use_good[:, None], good_seq, insert_seq)

    end_i = jnp.where(forward[:, None], bi, fi)
    base = tb.chr_off[jnp.clip(chr_, 0, tb.chr_off.shape[0] - 2)]
    end_vid = s * tb.jid[jnp.clip(base + end_i, 0, tb.jid.shape[0] - 1)]
    at_end = in_list & (end_vid == start_vid[:, None])

    jf = tb.jpos[jnp.clip(base + fi, 0, tb.jpos.shape[0] - 1)]
    jb = tb.jpos[jnp.clip(base + bi, 0, tb.jpos.shape[0] - 1)]
    weight = jnp.abs(jf - jb) + 1
    opos = tb.jpos[jnp.clip(base + end_i, 0, tb.jpos.shape[0] - 1)] + (
        jnp.where(s < 0, tb.k, 0)
    )
    okey = ((s > 0).astype(jnp.int64) << 62) | (chr_ << 40) | end_i

    d = jnp.arange(1, W + 1, dtype=jnp.int64)  # [W]
    dirn = jnp.where(forward[:, None, None], d[None, None, :],
                     -d[None, None, :])
    step = s[:, :, None] * dirn
    it_i = end_i[:, :, None] + step
    in_range = (it_i >= 0) & (
        it_i < tb.chr_len[jnp.clip(chr_, 0, tb.chr_len.shape[0] - 1)][:, :, None]
    )
    flat = jnp.clip(base[:, :, None] + it_i, 0, tb.jpos.shape[0] - 1)
    pos = tb.jpos[flat] + jnp.where(s[:, :, None] < 0, tb.k, 0)
    within = (d[None, None, :] < depth) | (
        jnp.abs(pos - opos[:, :, None]) <= b
    )
    vid = s[:, :, None] * tb.jid[flat]
    q = vid.reshape(L, -1)
    pp = jax.vmap(jnp.searchsorted)(pvid, q)
    hit = jnp.take_along_axis(
        jnp.concatenate([pvid, jnp.full((L, 1), jnp.int64(BIG))], axis=1),
        pp, axis=1,
    ) == q
    in_path = (hit & (pp < pn[:, None])).reshape(vid.shape)
    uslot = jnp.where(s[:, :, None] > 0, flat, flat - 1)
    used = jnp.where(
        (s[:, :, None] > 0) | (it_i > 0),
        tb.used[jnp.clip(uslot, 0, tb.used.shape[0] - 1)] > 0,
        False,
    )
    ok_used = (~used) | try_used[:, None, None]
    cont = at_end[:, :, None] & in_range & within & ~in_path & ok_used
    # prefix scans via associative_scan (a log-depth slice+op tree) rather
    # than the reduce-window lowering of cumsum/cummax/cumprod; both are
    # exact, the tree keeps this fused program's scan scratch small
    alive = jax.lax.associative_scan(jnp.logical_and, cont, axis=2)
    overflow = jnp.any(alive[:, :, W - 1], axis=1).astype(jnp.int32)

    # order-free winner reduction (docs/design.md §3), per-lane batched:
    # both sorts run along one [CAP*W] axis with L as a batch dimension, so
    # the device sorts L independent small sequences instead of one giant
    # lane-key-prefixed sequence (same comparisons, lane keys now implicit)
    CW = CAP * W
    keyv = jnp.where(alive, vid, BIG).reshape(L, CW)
    arrival = order_seq[:, :, None] * W + (d - 1)[None, None, :]
    arr_f = jnp.broadcast_to(arrival, vid.shape).reshape(L, CW)
    okey_f = jnp.broadcast_to(okey[:, :, None], vid.shape).reshape(L, CW)
    vid_f = vid.reshape(L, CW)
    w_f = jnp.broadcast_to(weight[:, :, None], vid.shape).reshape(L, CW)
    slot_f = jnp.broadcast_to(col[:, :, None], vid.shape).reshape(L, CW)

    k2, a2, o2, v2, w2, sl2 = jax.lax.sort(
        (keyv, arr_f, okey_f, vid_f, w_f, slot_f), dimension=1, num_keys=2
    )
    ridx = jnp.arange(CW, dtype=jnp.int64)[None, :]
    ones_col = jnp.ones((L, 1), dtype=bool)
    seg_start = jnp.concatenate([ones_col, k2[:, 1:] != k2[:, :-1]], axis=1)
    seg_end = jnp.concatenate([seg_start[:, 1:], ones_col], axis=1)
    wcum = jax.lax.associative_scan(jnp.add, w2, axis=1)
    start_rank = jax.lax.associative_scan(
        jnp.maximum,
        jnp.where(seg_start, jnp.broadcast_to(ridx, (L, CW)), -1),
        axis=1,
    )
    base_at = jnp.take_along_axis(
        wcum - w2, jnp.clip(start_rank, 0, None), axis=1
    )
    final_cnt = wcum - base_at
    is_final = seg_end & (k2 < BIG)

    # rank the final-count events: most votes first, then origin-iterator
    # order, then arrival; non-final rows sink via a positive sentinel on
    # the (negated) count key, so column 0 is each lane's winner
    neg = jnp.where(is_final, -final_cnt, BIG)
    n3, o3, a3, v3, s3 = jax.lax.sort(
        (neg, o2, a2, v2, sl2), dimension=1, num_keys=3
    )
    has = n3[:, 0] < 0
    best_vid = jnp.where(has, v3[:, 0], 0)
    best_cnt = jnp.where(has, -n3[:, 0], 0)
    best_slot = s3[:, 0]

    slot_c = jnp.clip(best_slot, 0, CAP - 1)[:, None]
    ochr = jnp.take_along_axis(chr_, slot_c, axis=1)[:, 0]
    oidx = jnp.take_along_axis(end_i, slot_c, axis=1)[:, 0]
    ostr = jnp.take_along_axis(s, slot_c, axis=1)[:, 0]
    return best_vid, best_cnt, ochr, oidx, ostr, overflow


_vote_round = functools.partial(jax.jit, static_argnums=(0, 1))(_vote_gathered)


# --------------------------------------------------------------------------
# seeding: SeedBatch -> DeviceLanes (host numpy, one transfer per phase)
# --------------------------------------------------------------------------


def _seed_lanes(
    table: JunctionTable, bundles: Sequence[Bundle], L: int
) -> Tuple[DeviceLanes, np.ndarray, np.ndarray]:
    """Build the phase's initial DeviceLanes; returns (lanes, n, overflow)."""
    sb = seed_batch(table, bundles)
    nb = len(bundles)
    cap = sb.chr.shape[1] if nb else 0
    ccap = min(cap, I_CAP)

    chr_ = np.full((L, I_CAP), -1, np.int64)
    s = np.zeros((L, I_CAP), np.int64)
    idx = np.zeros((L, I_CAP), np.int64)
    if nb:
        chr_[:nb, :ccap] = sb.chr[:, :ccap]
        s[:nb, :ccap] = sb.strand[:, :ccap]
        idx[:nb, :ccap] = sb.idx[:, :ccap]
    n = np.zeros(L, np.int64)
    n[:nb] = np.minimum(sb.n, I_CAP)
    overflow = np.zeros(L, bool)
    overflow[:nb] = sb.n > I_CAP
    col = np.arange(I_CAP, dtype=np.int64)[None, :]
    live = col < n[:, None]
    chr_ = np.where(live, chr_, -1)
    pvid = np.full((L, P_CAP), BIG, np.int64)
    pdist = np.zeros((L, P_CAP), np.int64)
    origin_vid = np.zeros(L, np.int64)
    for l in range(nb):
        pvid[l, 0] = bundles[l].vid
        origin_vid[l] = bundles[l].vid
    pn = np.zeros(L, np.int64)
    pn[:nb] = 1
    ln = DeviceLanes(
        chr=jnp.asarray(chr_),
        s=jnp.asarray(np.where(live, s, 0)),
        fi=jnp.asarray(np.where(live, idx, 0)),
        bi=jnp.asarray(np.where(live, idx, 0)),
        fdist=jnp.asarray(np.zeros((L, I_CAP), np.int64)),
        bdist=jnp.asarray(np.zeros((L, I_CAP), np.int64)),
        cmp=jnp.asarray(np.where(live, idx, 0)),
        ffin=jnp.asarray(np.zeros((L, I_CAP), bool)),
        bfin=jnp.asarray(np.zeros((L, I_CAP), bool)),
        good_seq=jnp.asarray(np.full((L, I_CAP), -1, np.int64)),
        insert_seq=jnp.asarray(np.where(live, col, 0)),
        n=jnp.asarray(n),
        next_good=jnp.asarray(np.zeros(L, np.int64)),
        next_insert=jnp.asarray(n.copy()),
        right_flank=jnp.asarray(np.zeros(L, np.int64)),
        left_flank=jnp.asarray(np.zeros(L, np.int64)),
        overflow=jnp.asarray(overflow),
        pvid=jnp.asarray(pvid),
        pdist=jnp.asarray(pdist),
        pn=jnp.asarray(pn),
        rv=jnp.asarray(origin_vid),
        lv=jnp.asarray(origin_vid.copy()),
    )
    return ln, n, overflow


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _seed_lanes_device_impl(L: int, IC: int, PC: int, tb: DeviceTables,
                            vids, chs):
    """Vectorized Path.Init entirely on device (the h2d twin of
    _seed_lanes): per lane, gather the origin vertex's occurrence window,
    apply the strand-aware used-slot and annotation-char filters, and
    left-compact the survivors.  vids[L] signed origin ids (0 = inert
    lane); chs[L] the bundle out-chars.  Returns (DeviceLanes, n[L],
    overflow[L]); a lane whose occurrence COUNT exceeds the IC slab
    width is flagged overflow (retier to a wider slab or the host oracle
    re-runs it — exact either way).  IC/PC are the instance/path slab
    widths: seed counts at Mbp scale average ~14, so narrow slabs cut
    every per-push sort ~8x; lanes that outgrow them replay from seed at
    the full I_CAP/P_CAP tier."""
    v = jnp.abs(vids)
    lo = tb.occ_off[jnp.clip(v, 0, tb.occ_off.shape[0] - 2)]
    cnt = tb.occ_off[jnp.clip(v + 1, 0, tb.occ_off.shape[0] - 1)] - lo
    col = jnp.arange(IC, dtype=jnp.int64)[None, :]
    in_occ = (col < cnt[:, None]) & (vids != 0)[:, None]
    rows = jnp.clip(lo[:, None] + col, 0, jnp.maximum(tb.occ_chr.shape[0] - 1, 0))
    cs = tb.occ_chr[rows]
    is_ = tb.occ_idx[rows]
    flat = jnp.clip(
        tb.chr_off[jnp.clip(cs, 0, tb.chr_off.shape[0] - 2)] + is_,
        0, jnp.maximum(tb.jid.shape[0] - 1, 0),
    )
    stored = tb.jid[flat]
    s = jnp.where(stored == vids[:, None], jnp.int64(1), jnp.int64(-1))
    # strand-aware used slot: + uses its own slot, - uses idx-1 (idx 0 on
    # the minus strand is never used)
    slot = jnp.where(s > 0, flat, flat - 1)
    usable = jnp.where(
        (s > 0) | (is_ > 0),
        tb.used[jnp.clip(slot, 0, jnp.maximum(tb.used.shape[0] - 1, 0))] == 0,
        True,
    )
    charv = jnp.where(s > 0, tb.occ_ch[rows], tb.occ_revch[rows]).astype(
        jnp.int64
    )
    keep = in_occ & usable & (charv == chs[:, None])
    # left-compact survivors, preserving occurrence order (keys unique)
    key = jnp.where(keep, col, IC + col)
    _, cs2, is2, s2 = jax.lax.sort((key, cs, is_, s), dimension=1, num_keys=1)
    n = jnp.sum(keep.astype(jnp.int64), axis=1)
    live = col < n[:, None]
    zero = jnp.zeros((L, IC), jnp.int64)
    idx2 = jnp.where(live, is2, 0)
    pvid = jnp.full((L, PC), BIG, jnp.int64)
    pvid = pvid.at[:, 0].set(jnp.where(vids != 0, vids, BIG))
    origin = jnp.where(vids != 0, vids, 0)
    ln = DeviceLanes(
        chr=jnp.where(live, cs2, -1),
        s=jnp.where(live, s2, 0),
        fi=idx2,
        bi=idx2,
        fdist=zero,
        bdist=zero,
        cmp=idx2,
        ffin=jnp.zeros((L, IC), bool),
        bfin=jnp.zeros((L, IC), bool),
        good_seq=jnp.full((L, IC), -1, jnp.int64),
        insert_seq=jnp.where(live, col, 0),
        n=n,
        next_good=jnp.zeros(L, jnp.int64),
        next_insert=n,
        right_flank=jnp.zeros(L, jnp.int64),
        left_flank=jnp.zeros(L, jnp.int64),
        overflow=jnp.zeros(L, bool),
        pvid=pvid,
        pdist=jnp.zeros((L, PC), jnp.int64),
        pn=jnp.where(vids != 0, jnp.int64(1), jnp.int64(0)),
        rv=origin,
        lv=origin,
    )
    return ln, n, cnt > IC


def _seed_lanes_device(
    eng_or_tb, bundles: Sequence[Bundle], L: int,
    IC: int = I_CAP, PC: int = P_CAP,
) -> Tuple[DeviceLanes, np.ndarray, np.ndarray]:
    """Device seeding entry: ships only 2 scalars per lane h2d (vs the
    ~20 MB/phase of host-built lane slabs)."""
    tb = eng_or_tb
    vids = np.zeros(L, np.int64)
    chs = np.zeros(L, np.int64)
    for i, b in enumerate(bundles):
        vids[i] = b.vid
        chs[i] = b.ch
    ln, n, ovf = _seed_lanes_device_impl(
        L, IC, PC, tb, jnp.asarray(vids), jnp.asarray(chs)
    )
    return ln, np.asarray(n), np.asarray(ovf)


# --------------------------------------------------------------------------
# per-lane protocol generator (pure control flow; all path state on device)
# --------------------------------------------------------------------------


class _Lane:
    """Host-visible scalars of one lane, refreshed from device returns."""

    __slots__ = ("score", "right_flank", "left_flank", "n")

    def __init__(self, n: int) -> None:
        self.score = 0
        self.right_flank = 0
        self.left_flank = 0
        self.n = n


def _protocol(eng: LcbEngine, lane: _Lane):
    """Process() control flow; yields primitive requests.

    Requests: ("vote", forward, try_used) -> (vid, origin_it | None, cnt)
              ("walk", forward, origin_it, target_vid)
                  -> (success, score, right_flank, left_flank)
              ("rewind",) -> (right_flank, left_flank, score)

    The path itself (instances, end vertices, flanks, best snapshots) lives
    entirely on device; the generator only sequences vote/walk/rewind and
    applies the minRun/positivity rules (blocksfinder.h:228-310).  The
    oracle's mir.score-after-last-successful-push equals the lane's current
    score (failed pushes do not mutate), so the walk's returned score is
    exact."""
    min_run = eng.b * 2

    def middle_length():
        return lane.right_flank - lane.left_flank

    def extend(forward):
        vid, origin, _ = yield ("vote", forward, False)
        if forward and vid == 0:
            vid, origin, _ = yield ("vote", True, True)
        success = False
        if vid != 0:
            res = yield ("walk", forward, origin, vid)
            success, lane.score, lane.right_flank, lane.left_flank = res
        return success

    # forward sweep (blocksfinder.h:252-284)
    while True:
        positive = False
        prev_len = middle_length()
        while True:
            ret = yield from extend(True)
            if not (ret and middle_length() - prev_len <= min_run):
                break
            positive = positive or (lane.score > 0)
        if not ret or not positive:
            break
    # rewind to best prefix: device slab restore
    lane.right_flank, lane.left_flank, lane.score = yield ("rewind",)
    # backward sweep with the stray-';' semantics (blocksfinder.h:292-306)
    while True:
        prev_len = middle_length()
        while True:
            ret = yield from extend(False)
            if not (ret and middle_length() - prev_len <= min_run):
                break
        positive = lane.score > 0
        if not ret or not positive:
            break
    return None


# --------------------------------------------------------------------------
# phase driver
# --------------------------------------------------------------------------


def _device_tables(eng: LcbEngine) -> DeviceTables:
    """DeviceTables cached on the engine; only `used`/`used_pfx` change
    between phases (at commit time), so those are refreshed per call."""
    tb = getattr(eng, "_resident_tb", None)
    if tb is None:
        tb = DeviceTables.build(eng.t)
        eng._resident_tb = tb
        return tb
    used_all = eng.t.used_flat
    # pad to the cached table's pow2 bucket (cumsum over trailing zeros
    # keeps the prefix's final value, so the pad rows stay semantics-free)
    n_pad = tb.used.shape[0]
    if len(used_all) < n_pad:
        used_all = np.concatenate(
            [used_all, np.zeros(n_pad - len(used_all), np.uint8)]
        )
    # ship only the uint8 flags; the int64 exclusive prefix (8x the bytes)
    # is computed on device
    used_j, pfx_j = _used_prefix(jnp.asarray(used_all))
    tb = dataclasses.replace(tb, used=used_j, used_pfx=pfx_j)
    eng._resident_tb = tb
    return tb


@jax.jit
def _used_prefix(used_u8):
    pfx = jnp.concatenate(
        [
            jnp.zeros(1, jnp.int64),
            jnp.cumsum(used_u8.astype(jnp.int64)),
        ]
    )
    return used_u8, pfx


def _pad_pow2(m: int, lo: int = 8) -> int:
    return max(lo, 1 << (m - 1).bit_length()) if m > 1 else lo


_SNAP_FIELDS = (
    "chr", "s", "fi", "bi", "fdist", "bdist", "cmp", "ffin", "bfin",
    "good_seq", "n",
)


def snapshot_to_host(sn: DeviceLanes) -> Dict[str, np.ndarray]:
    """Fetch the result-slab fields needed to decode Instances."""
    return {f: np.asarray(getattr(sn, f)) for f in _SNAP_FIELDS}


@functools.partial(jax.jit, static_argnums=(0,))
def _snap_compact_impl(M_CAP: int, sn: DeviceLanes, want):
    """Compact the result slab's good-instance rows on device.

    Returns (count, key[:M_CAP], 9 field columns[:M_CAP]) where rows are
    sorted by (lane, good_seq) and key = lane*(I_CAP+1)+good_seq — so the
    host receives ~count*80 bytes instead of the full [L, I_CAP] x 11
    slab (the d2h side of the transfer-lean fused path)."""
    L, IC = sn.chr.shape
    col = jnp.arange(IC, dtype=jnp.int64)[None, :]
    lane = jnp.arange(L, dtype=jnp.int64)[:, None]
    good = want[:, None] & (col < sn.n[:, None]) & (sn.good_seq >= 0)
    count = jnp.sum(good.astype(jnp.int64))
    key = jnp.where(good, lane * (IC + 1) + sn.good_seq, BIG).reshape(-1)
    fields = (
        sn.chr, sn.s, sn.fi, sn.bi, sn.fdist, sn.bdist, sn.cmp,
        sn.ffin.astype(jnp.int64), sn.bfin.astype(jnp.int64),
    )
    out = jax.lax.sort(
        (key, *(f.reshape(-1) for f in fields)), num_keys=1
    )
    return (count, *(v[:M_CAP] for v in out))


def instances_from_compact(
    sn: DeviceLanes, decode_rows, L: int
) -> Optional[Dict[int, List[Instance]]]:
    """Decode the wanted lanes' Instance lists via the compact d2h path;
    None if the compact buffer overflowed (caller falls back to the full
    snapshot fetch).  Returns {lane row -> [Instance]}."""
    IC = sn.chr.shape[1]
    M_CAP = min(16 * L, L * IC)
    want = np.zeros(L, bool)
    want[decode_rows] = True
    res = _snap_compact_impl(M_CAP, sn, jnp.asarray(want))
    count = int(res[0])
    if count > M_CAP:
        return None
    cols = np.stack([np.asarray(x[:count]) for x in res[1:]])
    key = cols[0]
    lanes = key // (IC + 1)
    out: Dict[int, List[Instance]] = {int(j): [] for j in decode_rows}
    for r in range(count):
        inst = Instance(int(cols[1][r]), int(cols[2][r]), 0, 0)
        inst.fi = int(cols[3][r])
        inst.bi = int(cols[4][r])
        inst.fdist = int(cols[5][r])
        inst.bdist = int(cols[6][r])
        inst.cmp = int(cols[7][r])
        inst.ffin = bool(cols[8][r])
        inst.bfin = bool(cols[9][r])
        out[int(lanes[r])].append(inst)
    return out


def instances_from_snapshot(h: Dict[str, np.ndarray], i: int) -> List[Instance]:
    """Decode lane i's result slab into the oracle's Instance list (good
    instances in good_seq order — the snapshot order of Path.good)."""
    ni = int(h["n"][i])
    gs = h["good_seq"][i][:ni]
    rows = np.flatnonzero(gs >= 0)
    rows = rows[np.argsort(gs[rows])]
    out: List[Instance] = []
    for q in rows:
        inst = Instance(int(h["chr"][i][q]), int(h["s"][i][q]), 0, 0)
        inst.fi = int(h["fi"][i][q])
        inst.bi = int(h["bi"][i][q])
        inst.fdist = int(h["fdist"][i][q])
        inst.bdist = int(h["bdist"][i][q])
        inst.cmp = int(h["cmp"][i][q])
        inst.ffin = bool(h["ffin"][i][q])
        inst.bfin = bool(h["bfin"][i][q])
        out.append(inst)
    return out


def process_phase_resident(
    eng: LcbEngine, bundles: Sequence[Bundle]
) -> List[List[Instance]]:
    """Explore every bundle of a phase with device-resident lane state."""
    import os
    import time as _time

    stats = (
        {"rounds": 0, "vote_calls": 0, "vote_s": 0.0, "walk_calls": 0,
         "walk_s": 0.0, "walk_steps": 0, "rewind_s": 0.0, "host_s": 0.0}
        if os.environ.get("SZ_RESIDENT_STATS")
        else None
    )
    t_phase = _time.time()
    table = eng.t
    nb = len(bundles)
    if nb == 0:
        return []
    L = PHASE_LANES if nb > 32 else _pad_pow2(nb, 32)
    tb = _device_tables(eng)

    ln, n_host, seed_ovf = _seed_lanes_device(tb, bundles, L)
    st = ResidentState(
        ln=ln, rw=ln, sn=ln, best_score=jnp.zeros(L, jnp.int64),
        has_snap=jnp.zeros(L, bool),
    )
    lanes = [_Lane(int(n_host[i])) for i in range(nb)]
    fallback = [bool(seed_ovf[i]) for i in range(nb)]
    gens: List[Optional[object]] = []
    pending: List[Optional[tuple]] = [None] * nb

    def start(i):
        if fallback[i]:
            gens.append(None)
            return
        g = _protocol(eng, lanes[i])
        gens.append(g)
        try:
            pending[i] = g.send(None)
        except StopIteration:
            gens[i] = None

    def resume(i, value):
        try:
            pending[i] = gens[i].send(value)
        except StopIteration:
            pending[i] = None
            gens[i] = None

    def kill(i):
        """Capacity overflow: abandon the lane, host oracle takes over."""
        fallback[i] = True
        pending[i] = None
        gens[i] = None

    for i in range(nb):
        start(i)

    while any(g is not None for g in gens):
        if stats is not None:
            stats["rounds"] += 1
            _t0 = _time.time()
        votes: List[int] = []
        walks: List[int] = []
        rewinds: List[int] = []
        for i, p in enumerate(pending):
            if p is None or gens[i] is None:
                continue
            if p[0] == "vote":
                votes.append(i)
            elif p[0] == "walk":
                walks.append(i)
            else:
                rewinds.append(i)

        # ---- votes: gathered read-only kernel with tier escalation ----
        group = votes
        tier = 0
        if stats is not None and votes:
            _tv = _time.time()
        while group:
            max_n = max(lanes[i].n for i in group)
            while VOTE_TIERS[tier][0] < max_n:
                tier += 1
            CAP, W = VOTE_TIERS[tier]
            L2 = _pad_pow2(len(group))
            idx = np.zeros(L2, np.int64)
            valid = np.zeros(L2, bool)
            fwd = np.zeros(L2, bool)
            tu = np.zeros(L2, bool)
            for j, i in enumerate(group):
                idx[j] = i
                valid[j] = True
                fwd[j] = pending[i][1]
                tu[j] = pending[i][2]
            out = _vote_round(
                CAP, W, tb, st.ln,
                jnp.asarray(idx), jnp.asarray(valid),
                jnp.asarray(fwd), jnp.asarray(tu),
                jnp.int64(eng.depth), jnp.int64(eng.b),
            )
            bvid, bcnt, ochr, oidx, ostr, ovf = [np.asarray(x) for x in out]
            retry: List[int] = []
            last = tier == len(VOTE_TIERS) - 1
            for j, i in enumerate(group):
                if ovf[j]:
                    if last:
                        kill(i)
                    else:
                        retry.append(i)
                elif bvid[j] == 0:
                    resume(i, (0, None, 0))
                else:
                    origin = (int(ochr[j]), int(oidx[j]), int(ostr[j]))
                    resume(i, (int(bvid[j]), origin, int(bcnt[j])))
            group = retry
            tier = len(VOTE_TIERS) - 1  # overflow: jump to the big window
        if stats is not None and votes:
            stats["vote_calls"] += 1
            stats["vote_s"] += _time.time() - _tv

        # ---- walks: one device while_loop, mixed directions ----
        if walks:
            if stats is not None:
                _tw = _time.time()
            A = min(_pad_pow2(len(walks)), L)
            rows = np.full(A, L, np.int64)
            wc = np.zeros(A, np.int64)
            wi = np.zeros(A, np.int64)
            ws = np.ones(A, np.int64)
            wf = np.zeros(A, bool)
            wt = np.full(A, BIG, np.int64)
            for j, i in enumerate(walks):
                _, forward, origin, tvid = pending[i]
                rows[j] = i
                wc[j], wi[j], ws[j] = origin
                wf[j] = forward
                wt[j] = tvid
            st, last, score, n_w, rfl, lfl, ovf = _walk_device(
                tb, st, jnp.asarray(rows), jnp.asarray(wc), jnp.asarray(wi),
                jnp.asarray(ws), jnp.asarray(wf), jnp.asarray(wt),
                jnp.int64(eng.m), jnp.int64(eng.b), jnp.int64(eng.flank),
            )
            last = np.asarray(last)
            score = np.asarray(score)
            n_w = np.asarray(n_w)
            rfl = np.asarray(rfl)
            lfl = np.asarray(lfl)
            ovf = np.asarray(ovf)
            for j, i in enumerate(walks):
                if ovf[j]:
                    kill(i)
                else:
                    lanes[i].n = int(n_w[j])
                    resume(
                        i,
                        (bool(last[j]), int(score[j]), int(rfl[j]),
                         int(lfl[j])),
                    )
            if stats is not None:
                stats["walk_calls"] += 1
                stats["walk_s"] += _time.time() - _tw

        # ---- rewinds: masked slab restore ----
        if rewinds:
            if stats is not None:
                _tr = _time.time()
            A = min(_pad_pow2(len(rewinds)), L)
            rows = np.full(A, L, np.int64)
            rows[: len(rewinds)] = rewinds
            st = _rewind_rows(st, jnp.asarray(rows))
            nn = np.asarray(st.ln.n)
            rfl = np.asarray(st.ln.right_flank)
            lfl = np.asarray(st.ln.left_flank)
            for i in rewinds:
                lanes[i].n = int(nn[i])
                resume(i, (int(rfl[i]), int(lfl[i]), 0))
            if stats is not None:
                stats["rewind_s"] += _time.time() - _tr

    if stats is not None:
        import sys

        total = _time.time() - t_phase
        stats["host_s"] = total - stats["vote_s"] - stats["walk_s"] - stats[
            "rewind_s"
        ]
        print(
            f"[resident] phase nb={nb} total={total:.1f}s "
            + " ".join(
                f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in stats.items()
            ),
            file=sys.stderr, flush=True,
        )

    # ---- collect results: one bulk snapshot fetch ----
    h = snapshot_to_host(st.sn)
    snap_host = np.asarray(st.has_snap)
    results: List[List[Instance]] = []
    for i in range(nb):
        if fallback[i]:
            results.append(eng.process(bundles[i]))
        elif snap_host[i]:
            results.append(instances_from_snapshot(h, i))
        else:
            results.append([])
    return results


def run_resident(eng: LcbEngine):
    """Full LCB run with resident-device phase exploration."""
    from sibeliaz_tpu.lcb.device_bundles import make_bundles_device

    return eng.run(
        process_batch_fn=process_phase_resident,
        bundles=make_bundles_device(eng.t),
    )
