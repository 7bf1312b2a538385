"""Device-batched partial-order alignment (the device POA path, SURVEY §2.3 P3).

The POA DP recurrence for sequence-vs-DAG global alignment with linear gaps

    H[i][r] = max( max_p H[i-1][pred_p] + s(seq_i, char_r),   # match
                   max_p H[i][pred_p]   - 8,                  # deletion
                   H[i-1][r]            - 8 )                 # insertion

has two dependence directions (along the DAG and along the sequence).  The
device formulation resolves them as:

  * a `lax.scan` over graph nodes in topological order (the DAG direction is
    inherently sequential, but each step is a full vector over the
    sequence axis),
  * the within-column insertion chain — col[i] = max(base[i], col[i-1]-8) —
    collapsed into one damped running maximum:
        col = cummax(base + 8*i) - 8*i
    which XLA lowers to a parallel prefix scan, no sequential loop,
  * `vmap` over a bucket of blocks, so one device program aligns the next
    copy of every block in the bucket simultaneously.

Certificate-exact banding (round 5; same scheme as the native engine,
align/native/poa.cpp): per topo rank r the host computes static depth
ranges [mind, maxd] (source side) and [mins, maxs] (sink side), giving a
concave piecewise-linear upper bound on the score of any complete
alignment through cell (i, r).  Restricting the DP to the interval of i
with bound >= S — for an achieved score S <= S_opt — reproduces the FULL
DP's traceback byte-for-byte: every cell on any co-optimal path (and of
such a cell's optimal prefix) has bound >= S_opt >= S so it is computed
exactly; excluded cells read as NEG and can never win or tie a comparison
(true scores are bounded far above NEG).  On device each rank gets a
WINDOW [off[r], off[r]+W) of the sequence axis; the H carry shrinks from
[n_max+1, L+1] to [n_max+1, W] and the direction matrix likewise, which
cuts both the per-rank vector work and the per-block HBM scratch by
(L+1)/W.  Pass 1 bands at a guess S0 = sink_ub - slack; if its achieved
score certifies (>= S0) the result is final, otherwise the block re-runs
banded at the achieved score (certified unconditionally) or, with no
finite score, at full width.  The unbanded case is the same kernel with
off = 0 and W = L+1.

Scores/tie-breaks mirror align/poa_ref.py exactly (match > deletion >
insertion, first arg-max over predecessors, smallest-rank sink), so the
device engine is differential-tested against the executable spec (which
stands in for the unmounted spoa submodule invoked as
`spoa <block.fa> -l 1 -r 1 -e -8`, SibeliaZ-LCB/sibeliaz:67).  Graph
maintenance (threading the alignment, topological order, MSA emission)
reuses the spec's PoaGraph on the host — only the O(N*W) DP runs on
device.

Blocks whose graphs outgrow the padded node budget or predecessor fan-in
fall back to the native host engine.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sibeliaz_tpu.align.poa_ref import GAP, MATCH, MISMATCH, PoaGraph

MAX_PREDS = 8
_TILE = 8  # topo ranks per scan step (amortizes per-step scan overhead)
NEG = -(2**29)

# direction encoding: bits 0-3 pred slot, bit 4 match, bit 5 insertion
_DIR_MATCH = 1 << 4
_DIR_INS = 1 << 5


def _dp_single(seq0p, seq_len, node_char, pred_idx, pred_ok, sink_mask,
               off, n_max, W):
    """Windowed DP for one block; returns (dirs [N, W] uint8, best_r,
    best_sc).

    `seq0p` is the 1-shifted sequence padded to L+1+W so window slices
    never read out of range.  Rank r computes sequence rows
    [off[r], off[r]+W); out-of-window predecessor reads are NEG (the
    band certificate's guarded reads).  `dirs` is consumed by the
    on-device traceback (_tb_single) and never leaves HBM — shipping it
    d2h was the device engine's bottleneck.  A rolling-window H variant
    (O(D*W) scratch) was tried and measured 4-5x SLOWER here: the
    modular gather/update indices defeat XLA's in-place scan aliasing,
    so the full [n_max+1, W] carry stays."""
    wvec = jnp.arange(W, dtype=jnp.int32)
    evec = jnp.arange(W + 1, dtype=jnp.int32) - 1  # ext axis: w = -1..W-1

    def one_rank(H, r, char_r, pidx, pok, off_r):
        # absolute sequence rows covered by the gather (diag needs w-1)
        jext = off_r + evec  # [W+1]
        off_p = off[pidx]  # [P] window starts of the predecessor rows
        idx = jext[None, :] - off_p[:, None]  # pred-window coords
        in_win = (idx >= 0) & (idx < W) & (jext[None, :] >= 0)
        is_src = pidx == n_max
        gathered = jnp.take_along_axis(
            H[pidx], jnp.clip(idx, 0, W - 1), axis=1
        )
        srcvals = (GAP * jext).astype(jnp.int32)  # virtual source column
        ext = jnp.where(
            pok[:, None] & in_win,
            jnp.where(is_src[:, None], srcvals[None, :], gathered),
            NEG,
        )
        diag_best = jnp.max(ext[:, :-1], axis=0)
        diag_slot = jnp.argmax(ext[:, :-1], axis=0).astype(jnp.uint8)
        seq_win = jax.lax.dynamic_slice(seq0p, (off_r,), (W,))
        subs = jnp.where(seq_win == char_r, MATCH, MISMATCH).astype(
            jnp.int32
        )
        diag = diag_best + subs
        horiz_best = jnp.max(ext[:, 1:], axis=0)
        horiz_slot = jnp.argmax(ext[:, 1:], axis=0).astype(jnp.uint8)
        horiz = horiz_best + GAP
        is_match = diag >= horiz
        base = jnp.maximum(diag, horiz)
        # window-relative damping is exact: i = off_r + w and the offset
        # cancels; w = 0 has no in-window insertion predecessor, matching
        # the native band's NEG entry sentinel
        col = jax.lax.cummax(base + 8 * wvec) - 8 * wvec
        is_ins = col > base
        d = jnp.where(is_match, diag_slot | _DIR_MATCH, horiz_slot).astype(
            jnp.uint8
        )
        d = jnp.where(is_ins, jnp.uint8(_DIR_INS), d)
        H = jax.lax.dynamic_update_slice(H, col[None, :], (r, jnp.int32(0)))
        return H, d

    def step2(carry, xs):
        H, r = carry
        chars, pidxs, poks, offs = xs
        ds = []
        for t in range(_TILE):
            H, d = one_rank(H, r + t, chars[t], pidxs[t], poks[t], offs[t])
            ds.append(d)
        return (H, r + _TILE), jnp.stack(ds)

    n_tiles = n_max // _TILE
    H0 = jnp.full((n_max + 1, W), NEG, jnp.int32)
    (H, _), dirs = jax.lax.scan(
        step2,
        (H0, jnp.int32(0)),
        (
            node_char.reshape(n_tiles, _TILE),
            pred_idx.reshape(n_tiles, _TILE, MAX_PREDS),
            pred_ok.reshape(n_tiles, _TILE, MAX_PREDS),
            off[:n_max].reshape(n_tiles, _TILE),
        ),
    )
    dirs = dirs.reshape(n_max, W)
    # sink selection at row seq_len: max score, then smallest rank
    sidx = seq_len - off[:n_max]
    valid = sink_mask & (sidx >= 0) & (sidx < W)
    scores = jnp.take_along_axis(
        H[:n_max], jnp.clip(sidx, 0, W - 1)[:, None], axis=1
    )[:, 0]
    scores = jnp.where(valid, scores, NEG)
    best_r = jnp.argmax(scores).astype(jnp.int32)
    return dirs, best_r, scores[best_r]


def _tb_single(dirs, best_r, seq_len, pred_idx, off, n_max, W, P):
    """Traceback on device: walk dirs from (best_r, seq_len) to the virtual
    source, emitting (rank, seqpos) per step (-1 encodes None) into fixed
    [P] registers.  `i` is the ABSOLUTE sequence row; the dirs lookup maps
    it into rank r's window.  Mirrors the host/spec traceback's order and
    tie-breaks exactly; the caller reverses the emitted prefix."""
    out_r = jnp.full(P, -1, jnp.int32)
    out_i = jnp.full(P, -1, jnp.int32)

    def cond(c):
        i, r, at_src, t, _, _ = c
        return ((i > 0) | ~at_src) & (t < P)

    def body(c):
        i, r, at_src, t, our, oui = c
        d = dirs[r, jnp.clip(i - off[r], 0, W - 1)]
        is_ins = ~at_src & ((d & _DIR_INS) != 0)
        is_match = ~at_src & ((d & _DIR_INS) == 0) & ((d & _DIR_MATCH) != 0)
        is_del = ~at_src & ((d & _DIR_INS) == 0) & ((d & _DIR_MATCH) == 0)
        gap_seq = at_src | is_ins  # emit (None, i-1)
        emit_r = jnp.where(gap_seq, -1, r)
        emit_i = jnp.where(gap_seq | is_match, i - 1, -1)
        our = our.at[t].set(emit_r.astype(jnp.int32))
        oui = oui.at[t].set(emit_i.astype(jnp.int32))
        step_i = gap_seq | is_match
        i2 = jnp.where(step_i, i - 1, i)
        slot = (d & 0xF).astype(jnp.int32)
        p = pred_idx[r, slot]
        follow = is_match | is_del
        at_src2 = at_src | (follow & (p == n_max))
        r2 = jnp.where(follow & (p != n_max), p, r)
        return (i2, r2, at_src2, t + 1, our, oui)

    _, _, _, t, out_r, out_i = jax.lax.while_loop(
        cond, body,
        (seq_len.astype(jnp.int32), best_r, jnp.bool_(False),
         jnp.int32(0), out_r, out_i),
    )
    return out_r, out_i, t


@functools.partial(jax.jit, static_argnums=(6, 7, 8))
def _dp_tb_batch(seq0p, seq_len, node_char, pred_idx, pred_ok, sink_mask,
                 n_max, W, P, off):
    """Fused DP + traceback per block; only the O(L+N) paths and the
    certification score leave HBM."""

    def one(a, b, c, d, e, f, o):
        dirs, best_r, best_sc = _dp_single(a, b, c, d, e, f, o, n_max, W)
        out_r, out_i, t = _tb_single(dirs, best_r, b, d, o, n_max, W, P)
        return out_r, out_i, t, best_sc

    return jax.vmap(one)(seq0p, seq_len, node_char, pred_idx, pred_ok,
                         sink_mask, off)


class _BlockState:
    def __init__(self, seqs: List[np.ndarray]):
        self.seqs = seqs
        self.graph = PoaGraph()
        self.graph.add_first(seqs[0])
        self.next = 1
        self.fallback = False
        # banding pass-2 state for the CURRENT sequence: None = fresh
        # (pass 1 at the slack guess); an int = re-band at that achieved
        # score (certified unconditionally); "full" = full-width re-run
        self.band_S: Optional[object] = None

    @property
    def done(self) -> bool:
        return self.fallback or self.next >= len(self.seqs)


def _extract_arrays(g: PoaGraph, n_max: int):
    """Topo-rank-space arrays for the device DP, or None if over budget."""
    topo = g.topo_nodes()
    N = len(topo)
    if N > n_max:
        return None
    # vectorized build (the per-node Python loop was ~40% of the device
    # engine's host time once banding made large blocks device-eligible);
    # predecessor SLOT ORDER is semantic (first-argmax tie-breaks) and is
    # preserved: the flat concat walks g.preds[nid] lists in order
    topo_a = np.asarray(topo, dtype=np.int64)
    preds = g.preds
    degs = np.fromiter((len(preds[nid]) for nid in topo), np.int64, N)
    if N and int(degs.max()) > MAX_PREDS:
        return None
    rank_of = np.full(len(g.char), n_max, dtype=np.int32)
    rank_of[topo_a] = np.arange(N, dtype=np.int32)
    node_char = np.zeros(n_max, dtype=np.uint8)
    node_char[:N] = np.asarray(g.char, dtype=np.uint8)[topo_a]
    pred_idx = np.full((n_max, MAX_PREDS), n_max, dtype=np.int32)
    pred_ok = np.zeros((n_max, MAX_PREDS), dtype=bool)
    total = int(degs.sum())
    flat = np.fromiter(
        (p for nid in topo for p in preds[nid]), np.int64, total
    )
    rows = np.repeat(np.arange(N, dtype=np.int64), degs)
    cols = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([np.zeros(1, np.int64), np.cumsum(degs)[:-1]]), degs
    )
    pred_idx[rows, cols] = rank_of[flat]
    pred_ok[rows, cols] = True
    no_pred = np.flatnonzero(degs == 0)
    pred_idx[no_pred, 0] = n_max  # virtual source
    pred_ok[no_pred, 0] = True
    sink = np.zeros(n_max, dtype=bool)
    succs = g.succs
    sink[:N] = np.fromiter(
        (not succs[nid] for nid in topo), bool, N
    )
    return topo, node_char, pred_idx, pred_ok, sink


# ---------------------------------------------------------------------------
# Host-side band computation (the native engine's certificate, vectorized;
# align/native/poa.cpp "exact banding" block)
# ---------------------------------------------------------------------------

_BIG = np.int64(1) << 50


def _depth_ranges(pred_idx, pred_ok, sink, N, n_max):
    """Per real rank r < N: [mind, maxd] = min/max source->r path depth
    (in nodes, source-adjacent = 1) and [mins, maxs] = min/max r->sink
    remaining depth.  Chain runs (single pred = r-1, the linear backbone)
    are filled vectorized; only branch/source ranks loop in Python."""
    ranks = np.arange(N)
    npred = pred_ok[:N].sum(axis=1)
    first = pred_idx[:N, 0]
    is_src = pred_ok[:N, 0] & (first == n_max)
    chain = (npred == 1) & ~is_src & (first == ranks - 1)
    branch = np.flatnonzero(~chain)

    mind = np.empty(N, np.int64)
    maxd = np.empty(N, np.int64)
    prev = 0
    for r in branch:
        if r > prev:  # chain run [prev, r): pred of i is i-1
            ar = np.arange(1, r - prev + 1)
            mind[prev:r] = mind[prev - 1] + ar
            maxd[prev:r] = maxd[prev - 1] + ar
        if is_src[r]:
            mind[r] = maxd[r] = 1
        else:
            ps = pred_idx[r][pred_ok[r]]
            mind[r] = mind[ps].min() + 1
            maxd[r] = maxd[ps].max() + 1
        prev = r + 1
    if prev < N:
        ar = np.arange(1, N - prev + 1)
        mind[prev:N] = mind[prev - 1] + ar
        maxd[prev:N] = maxd[prev - 1] + ar

    mins = np.where(sink[:N], 0, _BIG).astype(np.int64)
    maxs = np.where(sink[:N], 0, -_BIG).astype(np.int64)
    prev = N
    for r in branch[::-1]:
        if prev > r + 1:
            # chain run [r+1, prev): all external relaxations into its
            # members came from higher (already processed) ranks, so
            # in-run propagation is a reversed damped cummin/cummax
            a, b = r + 1, prev
            ar = np.arange(a, b)
            v = np.minimum.accumulate((mins[a:b] + ar)[::-1])[::-1]
            mins[a:b] = v - ar
            v = np.maximum.accumulate((maxs[a:b] + ar)[::-1])[::-1]
            maxs[a:b] = v - ar
            mins[r] = min(mins[r], mins[a] + 1)
            maxs[r] = max(maxs[r], maxs[a] + 1)
        if not is_src[r]:
            ps = pred_idx[r][pred_ok[r]]
            np.minimum.at(mins, ps, mins[r] + 1)
            np.maximum.at(maxs, ps, maxs[r] + 1)
        prev = r
    return mind, maxd, mins, maxs


def _side_bound(c, dmin, dmax):
    """Upper bound on aligning `c` chars against a path segment of depth
    in [dmin, dmax]: 5*min(c, depth) - 8*|c - depth| at the best depth."""
    return np.where(
        c < dmin, 13 * c - 8 * dmin,
        np.where(c > dmax, 13 * dmax - 8 * c, 5 * c),
    )


def _rank_windows(ranges, n, S):
    """Allowed-i interval per rank at threshold S.  bound(i, r) is concave
    piecewise-linear in i, so the allowed set is one interval: locate the
    max over its <=6 breakpoint candidates, then bisect both sides.
    Returns (ia, ib, reachable) with degenerate [0, 0] for never-allowed
    ranks (their window contents are guarded underestimates either way)."""
    mind, maxd, mins, maxs = ranges

    def bound(i):
        return _side_bound(i, mind, maxd) + _side_bound(n - i, mins, maxs)

    cands = np.stack([
        np.zeros_like(mind), np.full_like(mind, n),
        np.clip(mind, 0, n), np.clip(maxd, 0, n),
        np.clip(n - maxs, 0, n), np.clip(n - mins, 0, n),
    ])
    vals = _side_bound(cands, mind, maxd) + _side_bound(
        n - cands, mins, maxs
    )
    kbest = np.argmax(vals, axis=0)
    ibest = np.take_along_axis(cands, kbest[None], axis=0)[0]
    vbest = np.take_along_axis(vals, kbest[None], axis=0)[0]
    allowed = vbest >= S

    lo = np.zeros_like(ibest)
    hi = ibest.copy()
    for _ in range(int(n).bit_length() + 1):
        mid = (lo + hi) >> 1
        ok = bound(mid) >= S
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid + 1)
    ia = lo
    lo = ibest.copy()
    hi = np.full_like(ibest, n)
    for _ in range(int(n).bit_length() + 1):
        mid = (lo + hi + 1) >> 1
        ok = bound(mid) >= S
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid - 1)
    ib = lo
    ia = np.where(allowed, ia, 0)
    ib = np.where(allowed, ib, 0)
    return ia, ib, allowed


def _band_min() -> int:
    return int(_os.environ.get("SZ_POA_BAND_MIN", "256"))


def _band_enabled() -> bool:
    return _os.environ.get("SZ_POA_BAND", "1") != "0"


def _plan_windows(ex, n, L, n_max, band_S):
    """Per-round banding plan for one block: (off [n_max+1] int32, wneed,
    S0 or None).  S0 None means unbanded (always certified).  An
    UNBANDED block still only needs W = n + 1 window columns (its DP
    cells live in rows 0..n; off = 0 covers them all exactly), so short
    blocks absorbed into a large-L bucket never pay the bucket's full
    width."""
    topo, node_char, pred_idx, pred_ok, sink = ex
    N = len(topo)
    bm = _band_min()
    full = np.zeros(n_max + 1, np.int32)
    if (
        not _band_enabled()
        or band_S == "full"
        or n < bm
        or N < bm
        # NEG-floor guard: true scores must stay far above NEG so a
        # guarded read can never win/tie (native poa.cpp uses the same
        # 2^28 margin against its 2^29 floor)
        or 8 * (n + N) >= (1 << 28)
    ):
        return full, n + 1, None
    ranges = _depth_ranges(pred_idx, pred_ok, sink, N, n_max)
    sink_ub = int(
        np.max(np.where(sink[:N], _side_bound(n, ranges[0], ranges[1]),
                        -_BIG))
    )
    if band_S is None:
        S0 = sink_ub - 13 * (64 + n // 32)
    else:
        S0 = int(band_S)  # pass 2: certified unconditionally (S <= S_opt)
    ia, ib, _ = _rank_windows(ranges, n, S0)
    wneed = int((ib - ia + 1).max())
    if 4 * wneed >= 3 * (n + 1):  # band nearly full-width: skip overhead
        return full, n + 1, None
    off = np.zeros(n_max + 1, np.int32)
    off[:N] = ia.astype(np.int32)
    return off, wneed, S0


# Compiled allocation plan of one dispatch per byte of MODELED scratch
# (_per_block_bytes x batch): memory_analysis on an NVIDIA H100 80GB HBM3
# (700 W) measured 1.011 at B=16, n_max=57344, W=2048; 1.1 leaves margin
# for shapes not measured.
POA_PLAN_FACTOR = 1.1
# Milliseconds per DP scan step (a dispatch's wall time, transfers
# included, over its n_max/_TILE steps), the latency-routing unit cost:
# 0.269 ms (700 W card) and 0.276 ms (400 W card) warm on NVIDIA H100 80GB
# HBM3 over the committed example's blocks.
POA_STEP_MS = 0.27


def scratch_budget_bytes(budget_bytes: Optional[int] = None) -> int:
    """Modeled H + dirs scratch allowed per dispatch: two thirds of the
    device memory (or of -f) over the plan factor; the remaining third
    holds the resident inputs and traceback outputs."""
    from sibeliaz_tpu.utils.device import device_memory_bytes

    usable = budget_bytes if budget_bytes else device_memory_bytes()
    return max(64 << 20, int(usable * 2 / 3 / POA_PLAN_FACTOR))


def _per_block_bytes(W: int, n_max: int) -> int:
    return (n_max + 1) * (W + 1) * 4 + n_max * (W + 1)


def _n_max_for(L: int, node_budget_factor: float) -> int:
    return -(-int(L * node_budget_factor) // _TILE) * _TILE


def _west_estimate(L: int, dlen: int) -> int:
    """Routing-time band width estimate (slack 13*(64+L/32) spans
    ~2*(64+L/32) sequence rows at the 13/row falloff, plus the length
    mismatch shifts the diagonal by dlen).  Only used to decide device
    vs native routing; the dispatch-time plan uses the real band."""
    return min(L + 1, 2 * (64 + L // 32) + 2 * dlen + 128)


def device_budget_eligible(
    blocks_seqs: Sequence[Sequence[np.ndarray]],
    node_budget_factor: float = 1.75,
    budget_bytes: Optional[int] = None,
) -> List[bool]:
    """Per block: should the scheduler run it on the device engine?

    Two tests, both bucket-aware; callers schedule ineligible blocks on
    the native engine CONCURRENTLY with the device dispatches instead of
    serially after them (the native redo was ~40% of the device-engine
    wall time on the examples-full-maf config):

    * memory: the (L, n_max) bucket's H + dirs scratch at the ESTIMATED
      band width must fit the device budget (poa_msa_batch_tpu re-checks
      with the real band), and
    * latency: the DP's lax.scan walks n_max/_TILE topo steps strictly
      serially, each step costing ~POA_STEP_MS on the device.  A
      dispatch's cost is shared by every bucket member, so the unit
      economics are ms-per-threaded-copy = steps x POA_STEP_MS / members;
      buckets above SZ_POA_DEVICE_MS_PER_COPY (default 60 ms — the native
      engine's per-copy ballpark) route native.  Long-DAG blocks are
      therefore latency-excluded no matter how small the band — the same
      serial-step floor that bounds the fused LCB engine."""
    hbm_budget = scratch_budget_bytes(budget_bytes)
    ms_per_copy_cap = float(
        _os.environ.get("SZ_POA_DEVICE_MS_PER_COPY", "60")
    )
    fits = []
    Ls = []
    members: dict = {}
    for seqs in blocks_seqs:
        lens = [len(s) for s in seqs]
        max_len = max(lens)
        L = max(64, 1 << (max_len - 1).bit_length())
        n_max = _n_max_for(L, node_budget_factor)
        if max_len >= _band_min() and _band_enabled():
            west = _west_estimate(L, max_len - min(lens))
        else:
            west = max_len + 1  # unbanded runs at its own width
        ok = _per_block_bytes(min(west, L + 1), n_max) <= hbm_budget
        fits.append(ok)
        Ls.append(L)
        if ok:
            members[L] = members.get(L, 0) + 1
    out = []
    for ok, L in zip(fits, Ls):
        if ok and ms_per_copy_cap > 0:
            n_max = _n_max_for(L, node_budget_factor)
            disp_ms = (n_max / _TILE) * POA_STEP_MS
            ok = disp_ms / max(members.get(L, 1), 1) <= ms_per_copy_cap
        out.append(ok)
    return out


def poa_msa_batch_tpu(
    blocks_seqs: Sequence[Sequence[np.ndarray]],
    node_budget_factor: float = 1.75,
    mesh=None,
    budget_bytes: Optional[int] = None,
) -> List[Optional[List[bytes]]]:
    """MSA per block computed with the device DP; None for blocks that fell
    back (caller should route those to the native engine).

    Blocks are bucketed by padded sequence length so a 100 bp block never
    pays a 16 kbp block's (L, n_max) pad, and each bucket's dispatches are
    capped so the per-block H + dirs scratch fits the modeled budget
    (scratch_budget_bytes: derived from the device memory, or from
    budget_bytes — the driver's -f — when given)."""
    if not blocks_seqs:
        return []
    hbm_budget = scratch_budget_bytes(budget_bytes)
    all_states = [_BlockState([np.asarray(s, dtype=np.uint8) for s in seqs])
                  for seqs in blocks_seqs]
    buckets: dict = {}
    for b, st in enumerate(all_states):
        max_len = max(len(s) for s in st.seqs)
        L = max(64, 1 << (max_len - 1).bit_length())
        buckets.setdefault(L, []).append(b)
    # Merge small buckets upward: every dispatch pays a fixed launch and
    # sync cost, so fewer, FULLER dispatches beat tighter padding — the DP
    # runs far below its memory-bandwidth bound, so padded compute is
    # nearly free.  Greedy smallest-first:
    # absorb a bucket into the next one whenever the combined block count
    # still fits one batch dispatch at the larger shape (banded width
    # estimate — the dispatch-time cap uses the real band).
    def _cap_at(L: int) -> int:
        n_max = _n_max_for(L, node_budget_factor)
        west = _west_estimate(L, 0) if L >= _band_min() else L + 1
        return int(hbm_budget // max(_per_block_bytes(west, n_max), 1))

    merged: dict = {}
    pend_members: list = []
    items = sorted(buckets.items())
    for idx, (L, members) in enumerate(items):
        pend_members += members
        if idx + 1 < len(items):
            nxt_L, nxt_members = items[idx + 1]
            if len(pend_members) + len(nxt_members) <= _cap_at(nxt_L):
                continue  # absorb into the next (larger) bucket
        merged.setdefault(L, []).extend(pend_members)
        pend_members = []
    buckets = merged
    for L, members in sorted(buckets.items()):
        n_max = _n_max_for(L, node_budget_factor)
        keep = []
        for b in members:
            lens = [len(s) for s in all_states[b].seqs]
            mx, mn = max(lens), min(lens)
            if mx >= _band_min() and _band_enabled():
                west = _west_estimate(L, mx - mn)
            else:
                west = mx + 1
            if _per_block_bytes(min(west, L + 1), n_max) > hbm_budget:
                # even ONE such block's true allocation plan (about
                # POA_PLAN_FACTOR x the model) can exceed the device —
                # route it to the native fallback instead of forcing a
                # doomed dispatch.  The dispatch-time plan re-checks with
                # the REAL band width.
                all_states[b].fallback = True
            else:
                keep.append(b)
        if keep:
            _run_bucket(all_states, keep, L, n_max, hbm_budget, mesh=mesh)
    out: List[Optional[List[bytes]]] = []
    for st in all_states:
        out.append(None if st.fallback else st.graph.msa())
    return out


import os as _os
import sys as _sys
import time as _time

_STATS = {"extract_s": 0.0, "device_s": 0.0, "thread_s": 0.0,
          "h2d_build_s": 0.0, "band_s": 0.0, "dispatches": 0,
          "scan_steps": 0,
          "blocks_dispatched": 0, "band_pass2": 0, "band_full": 0,
          "banded_rounds": 0, "w_pad_max": 0}


def _poa_stats_enabled() -> bool:
    return bool(_os.environ.get("SZ_POA_STATS"))


def poa_stats_dump() -> dict:
    if _poa_stats_enabled():
        print(f"[tpu_poa] {_STATS}", file=_sys.stderr, flush=True)
    return dict(_STATS)


def _round_pow2(x: int, lo: int) -> int:
    return max(lo, 1 << (int(x) - 1).bit_length())


def _run_bucket(states: List[_BlockState], members: List[int], L: int,
                n_max: int, hbm_budget: int, mesh=None) -> None:
    """Drive one (L, n_max) bucket's blocks to completion.

    With a mesh, the batch (block) axis is sharded over the mesh's first
    axis — blocks are independent, so GSPMD partitions the whole fused
    DP+traceback with no cross-device communication."""
    while any(not states[b].done for b in members):
        active = [b for b in members if not states[b].done]
        t0 = _time.time()
        arrs = []
        for b in active:
            st = states[b]
            ex = _extract_arrays(st.graph, n_max)
            if ex is None:
                st.fallback = True
                continue
            arrs.append((b, ex))
        _STATS["extract_s"] += _time.time() - t0
        if not arrs:
            continue
        # ---- banding plan (host, numpy) ----
        t0 = _time.time()
        plans = []
        for b, ex in arrs:
            st = states[b]
            n = len(st.seqs[st.next])
            off, wneed, S0 = _plan_windows(ex, n, L, n_max, st.band_S)
            plans.append((b, ex, off, wneed, S0))
        W = min(_round_pow2(max(p[3] for p in plans), 128), L + 1)
        if _per_block_bytes(W, n_max) > hbm_budget:
            # the widest block's plan exceeds the budget: keep the widest
            # W that fits, run the blocks whose windows fit it, and fall
            # the rest back to native (an over-budget modeled plan
            # compiles to ~POA_PLAN_FACTOR x and would not fit)
            fit, dropped = [], []
            for p in plans:
                ok = _per_block_bytes(
                    min(_round_pow2(p[3], 128), L + 1), n_max
                ) <= hbm_budget
                (fit if ok else dropped).append(p)
            for b, *_ in dropped:
                states[b].fallback = True
            plans = fit
            if not plans:
                continue
            W = min(_round_pow2(max(p[3] for p in plans), 128), L + 1)
        _STATS["band_s"] += _time.time() - t0
        _STATS["w_pad_max"] = max(_STATS["w_pad_max"], W)
        b_cap = max(1, int(hbm_budget // _per_block_bytes(W, n_max)))
        # round the cap DOWN to a power of two: batches pad up to a power
        # of two, which must never exceed the memory budget
        b_cap = 1 << (b_cap.bit_length() - 1)
        plans = plans[:b_cap]
        # pad the batch to a power of two so jit compilations are reused
        t0 = _time.time()
        B = len(plans)
        B_pad = 1 << (B - 1).bit_length()
        if mesh is not None:  # batch axis must split evenly over devices
            B_pad = -(-max(B_pad, mesh.size) // mesh.size) * mesh.size
        seq_b = np.zeros((B_pad, L + 1 + W), dtype=np.uint8)
        len_b = np.zeros(B_pad, dtype=np.int32)
        char_b = np.zeros((B_pad, n_max), dtype=np.uint8)
        pi_b = np.full((B_pad, n_max, MAX_PREDS), n_max, dtype=np.int32)
        po_b = np.zeros((B_pad, n_max, MAX_PREDS), dtype=bool)
        sink_b = np.zeros((B_pad, n_max), dtype=bool)
        off_b = np.zeros((B_pad, n_max + 1), dtype=np.int32)
        for j, (b, (topo, nc, pi, po, sk), off, _w, _S0) in enumerate(plans):
            st = states[b]
            s = st.seqs[st.next]
            seq_b[j, 1 : 1 + len(s)] = s
            len_b[j] = len(s)
            char_b[j] = nc
            pi_b[j] = pi
            po_b[j] = po
            sink_b[j] = sk
            off_b[j] = off
        P = L + n_max + 2
        if mesh is None:
            dev = jnp.asarray
        else:
            from jax.sharding import NamedSharding, PartitionSpec as PSpec

            ax = mesh.axis_names[0]

            def dev(x):
                spec = PSpec(ax, *([None] * (x.ndim - 1)))
                return jax.device_put(x, NamedSharding(mesh, spec))

        _STATS["h2d_build_s"] += _time.time() - t0
        t0 = _time.time()
        out_r, out_i, tcount, best_sc = _dp_tb_batch(
            dev(seq_b), dev(len_b), dev(char_b),
            dev(pi_b), dev(po_b), dev(sink_b),
            n_max, W, P, dev(off_b),
        )
        # fetch the traceback registers only up to the longest USED path:
        # P = L + n_max + 2 rows are allocated but paths use ~L(1+overlap)
        # of them.  The device slice is pow2-bucketed so its compiled
        # shapes stay few.
        tcount = np.asarray(tcount)
        t_used = int(tcount.max()) if tcount.size else 0
        if 0 < t_used < P:
            T_pad = min(P, _round_pow2(t_used, 128))
            out_r = np.asarray(out_r[:, :T_pad])
            out_i = np.asarray(out_i[:, :T_pad])
        else:
            out_r = np.asarray(out_r)
            out_i = np.asarray(out_i)
        best_sc = np.asarray(best_sc)
        _STATS["device_s"] += _time.time() - t0
        _STATS["scan_steps"] += n_max // _TILE
        _STATS["dispatches"] += 1
        _STATS["blocks_dispatched"] += len(plans)
        t0 = _time.time()
        for j, (b, (topo, *_rest), off, _w, S0) in enumerate(plans):
            st = states[b]
            if S0 is not None:
                _STATS["banded_rounds"] += 1
                if int(best_sc[j]) < S0 and st.band_S is None:
                    # pass 1 uncertified: re-run banded at the achieved
                    # score (<= S_opt, so certified), or full-width if no
                    # finite in-band path survived
                    _STATS["band_pass2"] += 1
                    sc = int(best_sc[j])
                    st.band_S = sc if sc > -(1 << 28) else "full"
                    if st.band_S == "full":
                        _STATS["band_full"] += 1
                    continue
            s = st.seqs[st.next]
            t = int(tcount[j])
            if t >= P:  # traceback register overflow (cannot happen for a
                st.fallback = True  # well-formed DP; never trust garbage)
                continue
            # numpy path build: the per-element int() loop measured 127 ms
            # per 137k-row traceback vs 4 ms vectorized — at ~1 traceback
            # per copy that loop alone was seconds of host time per config
            rr = out_r[j, :t][::-1].astype(np.int64)
            ii = out_i[j, :t][::-1].astype(np.int64)
            topo_a = np.asarray(topo, dtype=np.int64)
            nids = np.where(
                rr >= 0, topo_a[np.clip(rr, 0, topo_a.size - 1)], -1
            )
            st.graph.add_alignment_arrays(nids, ii, s)
            st.next += 1
            st.band_S = None
        _STATS["thread_s"] += _time.time() - t0
