"""Fused per-phase LCB device state machine (batched-LCB slice 15).

lcb/resident.py keeps the whole phase's lane state on device but still
issues one vote + one walk dispatch per extension round, with the
minRun/positivity/rewind protocol (blocksfinder.h:228-310) as host control
flow over scalars.  Here that protocol itself is traced: per-lane stage
registers (forward sweep / backward sweep), the positivity and prev-length
registers, and the rewind transition become jnp selects inside a
lax.while_loop — a phase runs as a handful of SEGMENTED dispatches, each
of bounded length (the carry pytree stays device-resident across
segments, so segmentation costs only one dispatch + two scalar fetches
per SEG_STEPS outer steps).

Per traced step every lane not mid-walk performs one vote (+ the
forward-only used-retry) and every mid-walk lane advances by up to
WALK_CHUNK pushes; when a lane's extend attempt completes (empty vote, or
walk reached its target), the protocol registers advance:

  forward sweep (blocksfinder.h:252-269): a lane whose extend succeeded
  within minRun = 2b of the outer iteration's start length stays in the
  inner loop and accumulates positivity; otherwise the inner loop breaks —
  ret & positive opens a new outer iteration, anything else transitions to
  the backward sweep through the best-prefix rewind (a masked slab
  restore, blocksfinder.h:271-284);

  backward sweep (blocksfinder.h:292-306): same stepping with the stray-';'
  semantics — positivity is evaluated once per outer iteration from the
  score after the inner loop exits.

Capacity policy (exactness is never traded):
  * tier 1 runs every lane with small vote caps (CAP=64 instances kept in
    the vote, window W=16); a lane whose vote would overflow either cap is
    flagged and re-run from its seed in tier 2 (CAP=I_CAP, W=256) — the
    protocol is deterministic against the phase-frozen `used` snapshot, so
    a from-seed replay is exact.  Tier 2 runs in chunks of <=32 lanes (the
    W=256 window is memory-hungry).
  * lanes overflowing hard capacities (I_CAP instances, P_CAP path
    vertices, walk/step safety bounds) fall back to the host oracle, like
    the resident engine.

The serial validate/commit loop stays in LcbEngine.run — it defines the
deterministic output order (blocksfinder.h:369-427).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sibeliaz_tpu.lcb.batched_push import I_CAP
from sibeliaz_tpu.lcb.batched_push_device import P_CAP
from sibeliaz_tpu.lcb.batched_push_device import DeviceTables, edge_of
from sibeliaz_tpu.lcb.oracle import Bundle, Instance, LcbEngine
from sibeliaz_tpu.lcb.resident import (
    BIG,
    PHASE_LANES,
    ResidentState,
    _device_tables,
    _lanes_where,
    _pad_pow2,
    _push_score_snap,
    _score_of,
    _seed_lanes,
    _seed_lanes_device,
    _vote_gathered,
    instances_from_compact,
    instances_from_snapshot,
    snapshot_to_host,
)

import os as _os
import time as _time

SMALL_CAP = 64  # vote instance cap for phases whose seeds all fit it
SMALL_PATH = 128  # narrow path-slab width (P_CAP is the escalation)
WIDE_W = 256  # escalated vote window (W=16 covers depth-8 + dense regions)
VOTE_BUDGET = 1 << 22  # max L*CAP*W elements per dispatch (memory bound)
# Outer protocol steps per DISPATCH.  An entire phase can be minutes of
# strictly serial while_loop work; segmenting the state machine bounds
# each dispatch to SEG_STEPS outer steps (the carry pytree stays
# device-resident between dispatches; only two scalars come back per
# segment), so no single dispatch runs unbounded.  The per-dispatch step
# count adapts at runtime toward SEG_TARGET_S seconds per segment.
# SLOW-START, RESET PER PHASE CALL: per-step cost is activity-dependent (a
# fresh phase's full lane activity costs several times a draining phase's
# step), so a segment size tuned on a draining phase is too big for the
# next phase's first dispatch.  Each phase call therefore restarts at
# SEG_STEPS and doubles only on fast dispatches, capped at _SEG_MAX.
SEG_STEPS = int(_os.environ.get("SZ_FUSED_SEG", "32"))
SEG_TARGET_S = float(_os.environ.get("SZ_FUSED_SEG_TARGET_S", "15"))
_SEG_MAX = int(_os.environ.get("SZ_FUSED_SEG_MAX", "256"))
_seg_state = {"warmed": False}  # first dispatch absorbs compilation
# segment-dispatch counter (observability: the segment-boundary stress
# tests assert boundaries were actually crossed)
_seg_counter = {"segments": 0}
# Walk pushes per outer step: bounds the per-step serial chain (the round-3
# design nested a whole up-to-2048-push walk loop inside one outer step).
# Walks longer than WALK_CHUNK simply span multiple outer steps.
WALK_CHUNK = int(_os.environ.get("SZ_FUSED_WALK_CHUNK", "16"))


def vote_budget_from_bytes(budget_bytes: int) -> int:
    """Derive the vote-element budget from a total device-memory budget
    (the driver's -f): the fused vote holds ~6 int64 sort operands plus
    the 3D predicate temporaries per [L, CAP, W] element, ~192 B of live
    footprint.  Clamped to [2^18, 2^24]."""
    return max(1 << 18, min(1 << 24, budget_bytes // 192))


MAX_STEPS = 4096  # outer protocol steps per lane (safety)


def _walk_chunk(tb: DeviceTables, st: ResidentState, valid, c, i0, s, fwd,
                tvid, last0, m, b, flank):
    """Advance every valid mid-walk lane by up to WALK_CHUNK pushes toward
    its target vid tvid — lcb/resident.py's _walk_device without the
    gather/scatter, and BOUNDED so one outer protocol step never contains
    an unbounded nested loop (which would make segment length unbounded).
    last0 carries the walk's last-push-success register across chunks.
    Returns (state, i2, last, score, at_target)."""
    base = tb.chr_off[jnp.clip(c, 0, tb.chr_off.shape[0] - 2)]

    def vid_at(i):
        return s * tb.jid[jnp.clip(base + i, 0, tb.jid.shape[0] - 1)]

    active0 = valid & (vid_at(i0) != tvid)

    def cond(carry):
        _, _, active, _, steps = carry
        return jnp.any(active) & (steps < WALK_CHUNK)

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

    st, i2, _, last, _ = jax.lax.while_loop(
        cond, body, (st, i0, active0, last0, jnp.int64(0))
    )
    score = _score_of(tb, st.ln, flank)
    at_target = vid_at(i2) == tvid
    return st, i2, last, score, at_target


def _init_carry(st: ResidentState, active0, L: int):
    """The segmented state machine's full device-resident carry: protocol
    registers plus the mid-walk registers that let a walk span outer
    steps (and therefore dispatch boundaries)."""
    return dict(
        st=st,
        stage=jnp.zeros(L, jnp.int32),
        positive=jnp.zeros(L, bool),
        prev_len=jnp.zeros(L, jnp.int64),
        score=jnp.zeros(L, jnp.int64),
        active=active0,
        retier=jnp.zeros(L, bool),
        hostfb=jnp.zeros(L, bool),
        in_walk=jnp.zeros(L, bool),
        wc=jnp.zeros(L, jnp.int64),
        wi=jnp.zeros(L, jnp.int64),
        ws=jnp.ones(L, jnp.int64),
        wt=jnp.full(L, BIG, jnp.int64),
        wlast=jnp.zeros(L, bool),
        steps=jnp.int64(0),
    )


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _phase_fused_seg(CAP: int, W: int, slab_max: bool, tb: DeviceTables,
                     carry, depth, m, b, flank, min_run, steps_limit):
    """Advance the per-bundle protocol state machine by up to
    (steps_limit - carry['steps']) outer steps.

    One outer step = one vote for every lane not mid-walk (+ the
    forward-only used-retry) and up to WALK_CHUNK walk pushes for every
    mid-walk lane; protocol registers (blocksfinder.h:252-306) advance for
    lanes whose extend attempt COMPLETED this step (vote came back empty,
    or the walk reached its target / overflowed).  The whole carry stays
    device-resident between segment dispatches — the host reads two
    scalars per segment — so per-dispatch runtime is bounded regardless
    of phase size.

    Returns (carry, n_active)."""
    L = carry["active"].shape[0]
    rows = jnp.arange(L, dtype=jnp.int64)
    zero_vote = (
        jnp.zeros(L, jnp.int64), jnp.zeros(L, jnp.int64),
        jnp.zeros(L, jnp.int64), jnp.zeros(L, jnp.int64),
        jnp.ones(L, jnp.int64), jnp.zeros(L, jnp.int32),
    )

    def cond(carry):
        return jnp.any(carry["active"]) & (carry["steps"] < steps_limit)

    def body(carry):
        st = carry["st"]
        stage = carry["stage"]
        positive = carry["positive"]
        prev_len = carry["prev_len"]
        score_reg = carry["score"]
        active = carry["active"]
        retier = carry["retier"]
        hostfb = carry["hostfb"]
        in_walk = carry["in_walk"]
        wc, wi, ws, wt = carry["wc"], carry["wi"], carry["ws"], carry["wt"]
        wlast = carry["wlast"]
        fwd = stage == 0

        # ---- vote (+ forward-only used-retry, blocksfinder.h:780-785),
        # for lanes not mid-walk ----
        voting = active & ~in_walk
        cap_ovf = voting & (st.ln.n > CAP)
        votable = voting & ~cap_ovf
        bvid, _, ochr, oidx, ostr, wovf = _vote_gathered(
            CAP, W, tb, st.ln, rows, votable,
            fwd, jnp.zeros(L, bool), depth, b,
        )
        need_retry = votable & fwd & (bvid == 0) & (wovf == 0)
        bvid2, _, ochr2, oidx2, ostr2, wovf2 = jax.lax.cond(
            jnp.any(need_retry),
            lambda: _vote_gathered(
                CAP, W, tb, st.ln, rows, need_retry,
                fwd, need_retry, depth, b,
            ),
            lambda: zero_vote,
        )
        bvid = jnp.where(need_retry, bvid2, bvid)
        ochr = jnp.where(need_retry, ochr2, ochr)
        oidx = jnp.where(need_retry, oidx2, oidx)
        ostr = jnp.where(need_retry, ostr2, ostr)
        vote_ovf = cap_ovf | (votable & (wovf > 0)) | (
            need_retry & (wovf2 > 0)
        )
        retier = retier | vote_ovf
        active = active & ~vote_ovf
        voted = votable & ~vote_ovf
        start_walk = voted & (bvid != 0)
        no_winner = voted & (bvid == 0)

        # fresh walks load their registers and join the walking set
        wc = jnp.where(start_walk, ochr, wc)
        wi = jnp.where(start_walk, oidx, wi)
        ws = jnp.where(start_walk, ostr, ws)
        wt = jnp.where(start_walk, bvid, wt)
        wlast = wlast & ~start_walk
        in_walk = (in_walk & active) | start_walk

        # ---- one chunk of walk pushes for every walking lane ----
        st, wi, wlast, wscore, at_target = _walk_chunk(
            tb, st, in_walk, wc, wi,
            jnp.where(in_walk, ws, 1), fwd,
            jnp.where(in_walk, wt, BIG), wlast, m, b, flank,
        )
        push_ovf = in_walk & st.ln.overflow
        if slab_max:
            hostfb = hostfb | push_ovf
        else:  # narrow instance/path slab: replay from seed, wider tier
            retier = retier | push_ovf
        active = active & ~push_ovf
        walk_done = in_walk & at_target & ~push_ovf
        in_walk = in_walk & ~at_target & ~push_ovf
        did = walk_done
        score_reg = jnp.where(did, wscore, score_reg)
        ret = did & wlast

        # ---- protocol registers (blocksfinder.h:252-306), applied only
        # to lanes whose extend attempt completed this step ----
        fin = no_winner | walk_done
        middle = st.ln.right_flank - st.ln.left_flank
        cont = ret & (middle - prev_len <= min_run)
        positive = positive | (fwd & cont & (score_reg > 0))
        brk = active & fin & ~cont
        outer_cont = jnp.where(fwd, ret & positive, ret & (score_reg > 0))
        new_outer = brk & outer_cont
        prev_len = jnp.where(new_outer, middle, prev_len)
        positive = positive & ~(new_outer & fwd)
        to_bwd = brk & ~outer_cont & fwd
        done = brk & ~outer_cont & ~fwd
        active = active & ~done

        # fwd -> bwd: best-prefix rewind as a masked slab restore
        st = ResidentState(
            ln=_lanes_where(to_bwd, st.rw, st.ln), rw=st.rw, sn=st.sn,
            best_score=st.best_score, has_snap=st.has_snap,
        )
        stage = jnp.where(to_bwd, 1, stage)
        score_reg = jnp.where(to_bwd, 0, score_reg)
        positive = positive & ~to_bwd
        prev_len = jnp.where(
            to_bwd, st.ln.right_flank - st.ln.left_flank, prev_len
        )
        return dict(
            st=st, stage=stage, positive=positive, prev_len=prev_len,
            score=score_reg, active=active, retier=retier, hostfb=hostfb,
            in_walk=in_walk, wc=wc, wi=wi, ws=ws, wt=wt, wlast=wlast,
            steps=carry["steps"] + 1,
        )

    out = jax.lax.while_loop(cond, body, carry)
    return out, jnp.sum(out["active"].astype(jnp.int32))


def _phase_fused(CAP: int, W: int, slab_max: bool, tb: DeviceTables,
                 st: ResidentState, active0, depth, m, b, flank, min_run,
                 mesh: Optional[Mesh] = None, seg0: Optional[int] = None):
    """Run the complete per-bundle protocol for every lane to completion,
    as a host loop over bounded segment dispatches (SEG_STEPS outer steps
    each).

    Returns (state, retier, hostfb, steps): `retier` lanes hit a vote
    capacity (re-run from seed at a bigger tier), `hostfb` lanes hit a hard
    capacity (host oracle re-runs them); both sets' device state is
    abandoned."""
    L = st.ln.chr.shape[0]
    carry = _init_carry(st, active0, L)

    def _mesh_put(c, lanes):
        def lane_put(x):
            if getattr(x, "ndim", 0) >= 1 and x.shape[:1] == (lanes,):
                spec = P("lanes", *([None] * (x.ndim - 1)))
                return jax.device_put(x, NamedSharding(mesh, spec))
            return x

        return jax.tree_util.tree_map(lane_put, c)

    if mesh is not None:
        carry = _mesh_put(carry, L)

    def _lane_map(fn, c, lanes):
        """Apply fn to every lane-leading leaf ([lanes, ...]) of a carry."""
        return jax.tree_util.tree_map(
            lambda x: fn(x)
            if getattr(x, "ndim", 0) >= 1 and x.shape[:1] == (lanes,)
            else x,
            c,
        )

    # ---- active-lane compaction (round 5) -------------------------------
    # Measured at 4x20k: phase 1 spent ~130 of 547 steps on its last 9 of
    # 256 lanes — every segment still paid the full [L, ...] slab compute.
    # When the active count falls to <= lanes/2, gather the active rows
    # into a power-of-two lane bucket (>= COMPACT_MIN so compile shapes
    # stay few) and keep stepping there; finished lanes' terminal state is
    # stashed full-size and the compacted rows scatter back at phase end.
    # Lanes are independent, so compaction is a pure permutation (tested
    # against the oracle differential).
    compact_on = _os.environ.get("SZ_FUSED_COMPACT", "1") != "0"
    COMPACT_MIN = int(_os.environ.get("SZ_FUSED_COMPACT_MIN", "32"))
    if mesh is not None:
        COMPACT_MIN = max(COMPACT_MIN, mesh.size)
    stash = None  # full-L carry holding finished lanes' terminal state
    gmap: Optional[np.ndarray] = None  # current row -> original lane
    cur_L = L

    steps = 0
    seg = seg0 if seg0 else SEG_STEPS
    while True:
        limit = min(steps + seg, MAX_STEPS)
        t0 = _time.time()
        carry, n_active = _phase_fused_seg(
            CAP, W, slab_max, tb, carry,
            depth, m, b, flank, min_run, jnp.int64(limit),
        )
        _seg_counter["segments"] += 1
        new_steps = int(carry["steps"])  # d2h fetch = dispatch sync
        dt = _time.time() - t0
        if _os.environ.get("SZ_FUSED_STATS"):
            import sys as _sys

            print(
                f"[fused-seg] steps {steps}->{new_steps} "
                f"(asked {seg}) in {dt:.1f}s n_active={int(n_active)} "
                f"lanes={cur_L}",
                file=_sys.stderr, flush=True,
            )
        # adapt toward SEG_TARGET_S s/dispatch within this phase call;
        # skip the first segment of the process (it absorbs the one-time
        # executable load) and segments that ran fewer steps than asked
        # (phase finished early)
        ran = new_steps - steps
        if _seg_state["warmed"] and ran >= seg:
            if dt > 1.6 * SEG_TARGET_S:
                seg = max(4, seg // 2)
            elif dt < 0.4 * SEG_TARGET_S and seg < _SEG_MAX:
                seg = seg * 2
        _seg_state["warmed"] = True
        steps = new_steps
        if int(n_active) == 0 or steps >= MAX_STEPS:
            break
        na = int(n_active)
        if compact_on and cur_L > COMPACT_MIN and na <= cur_L // 2:
            act = np.flatnonzero(np.asarray(carry["active"]))
            L2 = max(COMPACT_MIN, 1 << max(0, int(len(act)) - 1).bit_length())
            if L2 < cur_L and len(act):
                if stash is None:
                    stash = carry
                    gmap = act
                else:
                    # fold the current rows into the full-size stash, then
                    # narrow the map to the still-active rows
                    idx = jnp.asarray(gmap)
                    stash = jax.tree_util.tree_map(
                        lambda f, p: f.at[idx].set(p[: idx.shape[0]])
                        if getattr(f, "ndim", 0) >= 1
                        and f.shape[:1] == (L,) else f,
                        stash, carry,
                    )
                    gmap = gmap[act]
                pad = np.zeros(L2 - len(act), dtype=act.dtype)
                idx_pad = jnp.asarray(np.concatenate([act, pad]))
                carry = _lane_map(lambda x: x[idx_pad], carry, cur_L)
                carry["active"] = carry["active"] & jnp.asarray(
                    np.arange(L2) < len(act)
                )
                cur_L = L2
                _seg_counter["compactions"] = (
                    _seg_counter.get("compactions", 0) + 1
                )
                if mesh is not None:
                    carry = _mesh_put(carry, cur_L)
    if stash is not None:
        idx = jnp.asarray(gmap)
        steps_final = carry["steps"]
        carry = jax.tree_util.tree_map(
            lambda f, p: f.at[idx].set(p[: idx.shape[0]])
            if getattr(f, "ndim", 0) >= 1 and f.shape[:1] == (L,) else f,
            stash, carry,
        )
        carry["steps"] = steps_final  # scalar leaves fold to the stash's

    hostfb = carry["hostfb"] | carry["active"]  # step-bound exhaustion
    return carry["st"], carry["retier"], hostfb, carry["steps"]


def _run_tier(eng: LcbEngine, tb: DeviceTables, bundles: Sequence[Bundle],
              L: int, tier, mesh: Optional[Mesh] = None) -> tuple:
    """Seed + run one tier ((vote cap, window, instance-slab width,
    path-slab width)); returns (snapshot dict, has_snap, retier, hostfb,
    steps) as host arrays.

    With a mesh, the lane axis is sharded over its "lanes" dimension —
    lanes never communicate (each explores one bundle against the
    phase-frozen snapshot), so GSPMD partitions the whole state machine
    with collectives only for the loop-condition/any-retry scalars and the
    walk's traced occurrence bound."""
    CAP, W, IC, PC = tier
    slab_max = IC >= I_CAP
    if mesh is None:
        # device seeding: 2 scalars/lane h2d instead of host-built slabs
        ln, _, seed_ovf = _seed_lanes_device(tb, bundles, L, IC, PC)
    else:
        ln, _, seed_ovf = _seed_lanes(eng.t, bundles, L)
    st = ResidentState(
        ln=ln, rw=ln, sn=ln, best_score=jnp.zeros(L, jnp.int64),
        has_snap=jnp.zeros(L, bool),
    )
    active0 = jnp.asarray(
        (np.arange(L) < len(bundles)) & ~seed_ovf
    )
    if mesh is not None:
        def lane_put(x):
            spec = P("lanes", *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))

        st = jax.tree_util.tree_map(lane_put, st)
        active0 = lane_put(active0)
        tb = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P())), tb
        )
    # higher vote tiers multiply per-step cost by ~CAP*W relative to the
    # small tier, so their slow-start must shrink proportionally or the
    # first segment alone runs far past SEG_TARGET_S
    seg0 = max(4, (SEG_STEPS * SMALL_CAP * 16) // (CAP * W))
    st, retier, hostfb, steps = _phase_fused(
        CAP, W, slab_max, tb, st, active0,
        jnp.int64(eng.depth), jnp.int64(eng.m), jnp.int64(eng.b),
        jnp.int64(eng.flank), jnp.int64(eng.b * 2), mesh=mesh, seg0=seg0,
    )
    if slab_max:
        hostfb = np.asarray(hostfb) | np.asarray(seed_ovf)
        retier = np.asarray(retier)
    else:  # narrow-slab seed overflow escalates instead of host fallback
        retier = np.asarray(retier) | np.asarray(seed_ovf)
        hostfb = np.asarray(hostfb)
    # the result slab itself is fetched lazily by the caller — a chunk
    # whose lanes all escalate shouldn't pay the [L, I_CAP] transfer
    return st.sn, np.asarray(st.has_snap), np.asarray(retier), hostfb, int(
        steps
    )


def process_phase_fused(
    eng: LcbEngine, bundles: Sequence[Bundle],
    mesh: Optional[Mesh] = None,
    vote_budget: Optional[int] = None,
) -> List[List[Instance]]:
    """Explore a phase with the fused device state machine.

    Tier ladder: (CAP, 16) with CAP sized from the phase's seed counts,
    then (I_CAP, 16), then (I_CAP, WIDE_W); a lane whose vote overflows a
    cap re-runs from its seed at the next tier (exact — the protocol is
    deterministic against the phase-frozen `used` snapshot).  Dispatches
    are chunked so L*CAP*W stays under VOTE_BUDGET.  Hard-capacity lanes
    (I_CAP instances / P_CAP path / step bounds) go to the host oracle."""
    import os
    import sys
    import time as _time

    nb = len(bundles)
    if nb == 0:
        return []
    stats = os.environ.get("SZ_FUSED_STATS")
    t0 = _time.time()
    tb = _device_tables(eng)

    small = max(b.count for b in bundles) <= SMALL_CAP
    # Size the STARTING vote window from the table's junction density:
    # the vote scans forward junctions while (d < depth) OR within b bp,
    # so it needs ~b/spacing + depth window slots.  At realistic
    # densities (1 junction per 3-6 bp on 1-3% divergent inputs) W=16
    # overflows for most lanes, and a whole-phase exploration at a
    # too-small W is thrown away by the retier — measured round 4: half
    # a phase's lanes retiered after 200+ wasted steps.  The ladder
    # above W0 still covers underestimates exactly.
    total_bp = sum(len(s) for s in eng.t.seqs)
    total_j = sum(len(p) for p in eng.t.jpos)
    spacing = max(1.0, total_bp / max(1, total_j))
    w_need = eng.b / spacing + eng.depth + 4
    W0 = 16
    while W0 < WIDE_W and W0 < w_need:
        W0 *= 2
    tiers = []
    if small and mesh is None:
        # narrow slabs: seed counts at Mbp scale average ~14, so the
        # [L, 64]-instance / [L, 128]-path tier cuts every per-push sort
        # ~8x; lanes that outgrow it replay from seed at the full width
        tiers.append((SMALL_CAP, W0, SMALL_CAP, SMALL_PATH))
    elif small:
        tiers.append((SMALL_CAP, W0, I_CAP, P_CAP))
    if W0 < WIDE_W:
        tiers.append((I_CAP, W0, I_CAP, P_CAP))
        tiers.extend(
            (I_CAP, w, I_CAP, P_CAP)
            for w in (64, WIDE_W)
            if w > W0
        )
    else:
        tiers.append((I_CAP, WIDE_W, I_CAP, P_CAP))

    results: List[List[Instance]] = [[] for _ in range(nb)]
    work = list(range(nb))
    oracle: List[int] = []
    n_disp = 0
    steps0 = 0
    # SZ_FUSED_LANE_CHUNK caps lanes per dispatch (debug knob).
    lane_cap = int(os.environ.get("SZ_FUSED_LANE_CHUNK", "0") or 0)
    vb = vote_budget or VOTE_BUDGET
    for t, (CAP, W, IC, PC) in enumerate(tiers):
        last = t == len(tiers) - 1
        chunk = max(8, min(PHASE_LANES, vb // (CAP * W)))
        if lane_cap:
            chunk = min(chunk, lane_cap)
        escalate: List[int] = []
        for lo in range(0, len(work), chunk):
            group = work[lo:lo + chunk]
            sub = [bundles[i] for i in group]
            L = _pad_pow2(len(group), 8 if t else 32)
            if mesh is not None:  # lane axis must split evenly over devices
                L = -(-L // mesh.size) * mesh.size
            sn, snap, retier, hostfb, steps = _run_tier(
                eng, tb, sub, L, (CAP, W, IC, PC), mesh=mesh
            )
            n_disp += 1
            if t == 0:
                steps0 = max(steps0, steps)
            decode = [
                j for j in range(len(group))
                if snap[j] and not hostfb[j] and not retier[j]
            ]
            comp = h = None
            if decode:
                # compact d2h: ~80 B per good instance instead of the full
                # [L, I_CAP] x 11 slab; falls back on overflow
                comp = (
                    instances_from_compact(sn, decode, L)
                    if mesh is None else None
                )
                if comp is None:
                    h = snapshot_to_host(sn)
            for j, i in enumerate(group):
                if hostfb[j] or (retier[j] and last):
                    oracle.append(i)
                elif retier[j]:
                    escalate.append(i)
                elif snap[j]:
                    results[i] = (
                        comp[j] if comp is not None
                        else instances_from_snapshot(h, j)
                    )
        work = escalate

    for i in oracle:
        results[i] = eng.process(bundles[i])

    if stats:
        print(
            f"[fused] phase nb={nb} tier0={tiers[0]} steps={steps0} "
            f"dispatches={n_disp} oracle={len(oracle)} "
            f"total={_time.time() - t0:.1f}s",
            file=sys.stderr, flush=True,
        )
    return results


def run_fused(eng: LcbEngine, mesh: Optional[Mesh] = None,
              vote_budget: Optional[int] = None):
    """Full LCB run with fused-phase device exploration; pass a Mesh with a
    "lanes" axis to shard each phase's lanes over multiple chips, and a
    vote_budget (elements per dispatch, see vote_budget_from_bytes) to
    bound device memory from the driver's -f flag."""
    from sibeliaz_tpu.lcb.device_bundles import make_bundles_device

    return eng.run(
        process_batch_fn=functools.partial(
            process_phase_fused, mesh=mesh, vote_budget=vote_budget
        ),
        bundles=make_bundles_device(eng.t),
    )
