"""Multi-device junction enumeration: sequence-axis sharding with k-halo
exchange and hash-bucket all-to-all (SURVEY.md §2.3 P1).

Design: the genome byte stream is sharded along the sequence axis over a 1-D
device mesh ("seq") — the direct analog of context/sequence parallelism.

  1. each shard computes forward/rc k-mer codes for its local positions;
     the k bytes that windows at the shard edge need come from the right
     neighbor via a single `ppermute` halo exchange (neighbor traffic,
     which XLA hands to NCCL over NVLink on GPUs),
  2. vertex classes must be analyzed globally, so occurrences are routed to
     their owner device by canonical-code hash with one `all_to_all`; each
     device sorts its buckets, computes the junction predicates with
     segmented reductions, and routes verdicts back with the inverse
     `all_to_all`,
  3. outputs are full-length sharded masks identical to the single-chip
     kernel's, so the host-side record assembly is shared.

Bucket padding: the send matrix uses a capacity factor (~1.3x the
balanced share per owner row, hash-balanced owners, invalid positions
dropped) with per-shard overflow flags; the caller doubles the factor and
retries on overflow, up to the skew-proof full-length layout.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sibeliaz_tpu.core import alphabet
from sibeliaz_tpu.graph.construct import (
    _doubling_codes,
    _doubling_codes2,
    _NO_EXT,
    _INVALID_CANON,
)
from sibeliaz_tpu.graph.assemble import assign_ids, split_chromosomes
from sibeliaz_tpu.io.dbg import JunctionChr

_AXIS = "seq"


def _local_analysis(codes_u8, k: int, n_dev: int):
    """Per-shard stage 1: k-mer codes + extension chars + boundary flags.

    codes_u8: [L_local] uint8 — this shard's slice of the 'N'-padded global
    code stream.  Windows near the right edge read the halo fetched from the
    right neighbor; the global stream is 'N'-padded at both ends so no
    device needs special casing.
    """
    L = codes_u8.shape[0]
    idx = jax.lax.axis_index(_AXIS)
    # halo: first k+1 bytes of the right neighbor (k for the window of the
    # last position, +1 for its next-extension char); left halo: 1 byte.
    right_halo = jax.lax.ppermute(
        codes_u8[: k + 1], _AXIS, [(i, (i - 1) % n_dev) for i in range(n_dev)]
    )
    left_halo = jax.lax.ppermute(
        codes_u8[-1:], _AXIS, [(i, (i + 1) % n_dev) for i in range(n_dev)]
    )
    # devices at the global edges must not see wrapped halos: replace with N
    bad = jnp.uint8(alphabet.BAD_CODE)
    right_halo = jnp.where(idx == n_dev - 1, bad, right_halo)
    left_halo = jnp.where(idx == 0, bad, left_halo)

    ext = jnp.concatenate([codes_u8, right_halo])  # [L + k + 1]
    definite = ext != alphabet.BAD_CODE
    codes = jnp.where(definite, ext, 0).astype(jnp.int64)

    defc = jnp.cumsum(definite.astype(jnp.int64))
    defc = jnp.concatenate([jnp.zeros(1, jnp.int64), defc])
    valid_full = (defc[k:] - defc[:-k]) == k  # length L+2
    valid = valid_full[:L]

    if k <= 31:
        fwd_full, rc_full = _doubling_codes(codes, k)
        fwd, rc = fwd_full[:L], rc_full[:L]
        positive = fwd < rc
        canon = (jnp.where(valid, jnp.minimum(fwd, rc), _INVALID_CANON),)
    else:
        # 31 < k <= 61: two-limb canonical codes, compared lexicographically
        fh_f, fl_f, rh_f, rl_f = _doubling_codes2(codes, k)
        fh, fl = fh_f[:L], fl_f[:L]
        rh, rl = rh_f[:L], rl_f[:L]
        positive = (fh < rh) | ((fh == rh) & (fl < rl))
        canon = (
            jnp.where(valid, jnp.where(positive, fh, rh), _INVALID_CANON),
            jnp.where(valid, jnp.where(positive, fl, rl), jnp.int64(0)),
        )

    pos_in_shard = jnp.arange(L)
    nxt_ok = definite[k : L + k]
    prev_bytes = jnp.concatenate([left_halo, codes_u8[: L - 1]])
    prv_def = prev_bytes != bad
    nxt_c = codes[k : L + k]
    prv_c = jnp.where(prv_def, prev_bytes, 0).astype(jnp.int64)
    nxt = jnp.where(nxt_ok, nxt_c, _NO_EXT)
    prv = jnp.where(prv_def, prv_c, _NO_EXT)
    right_ext = jnp.where(positive, nxt, jnp.where(prv_def, 3 - prv_c, _NO_EXT))
    left_ext = jnp.where(positive, prv, jnp.where(nxt_ok, 3 - nxt_c, _NO_EXT))

    prev_valid = jnp.concatenate(
        [
            jax.lax.ppermute(
                valid_full[L - 1 : L],
                _AXIS,
                [(i, (i + 1) % n_dev) for i in range(n_dev)],
            ),
            valid[:-1],
        ]
    )
    prev_valid = prev_valid.at[0].set(
        jnp.where(idx == 0, False, prev_valid[0])
    )
    next_valid = valid_full[1 : L + 1]
    at_boundary = valid & (~prev_valid | ~next_valid)

    global_pos = idx * L + pos_in_shard
    return canon, positive, right_ext, left_ext, at_boundary, global_pos


_MIX_SH = np.int64(-7046029254386353131)  # multiplicative owner hash (numpy, NOT jnp)
# low-limb mix for two-limb (k > 31) owner hashing
_MIX_SH2 = np.int64(-4417276706812531889)


def _bucket_exchange(canon, right_ext, left_ext, boundary, global_pos,
                     n_dev: int, cap: int):
    """Stage 2: route occurrences to owner = hash(canon) mod n_dev via
    all_to_all, analyze, route verdicts back.  Returns per-position
    (is_junction, first_idx, overflow) aligned with the shard's local
    order.  `canon` is a tuple of int64 limbs (one for k <= 31, two
    lexicographic base-2^62 limbs for 31 < k <= 61).

    The send matrix is [n_dev, cap] with cap ~= L/n_dev * slack (the
    capacity-factor layout) instead of the safe-for-any-skew [n_dev, L]:
    the owner hash balances buckets, invalid positions are dropped rather
    than routed, and an overflowing row raises the per-shard overflow flag
    so the caller can retry with a bigger factor."""
    L = canon[0].shape[0]
    valid = canon[0] != _INVALID_CANON
    mixed = canon[0] * _MIX_SH
    if len(canon) > 1:
        mixed = mixed ^ (canon[1] * _MIX_SH2)
    mixed = mixed & jnp.int64(0x7FFFFFFFFFFFFFFF)
    owner = jnp.where(
        valid, (mixed % n_dev).astype(jnp.int32), jnp.int32(n_dev)
    )

    # Build the send matrix: row d holds (compacted) the local occurrences
    # owned by d, padded with sentinel; invalid rows (owner = n_dev) drop.
    order = jnp.argsort(owner * jnp.int64(2 * L) + jnp.arange(L), stable=True)
    owner_s = owner[order]
    # position of each element within its owner run
    run_idx = jnp.arange(L) - jnp.searchsorted(owner_s, owner_s, side="left")
    sendable = owner_s < n_dev
    overflow = jnp.any(sendable & (run_idx >= cap))

    def scatter_rows(x, fill):
        m = jnp.full((n_dev, cap), fill, dtype=x.dtype)
        return m.at[owner_s, run_idx].set(x[order], mode="drop")

    send_canon = [
        scatter_rows(c, _INVALID_CANON if i == 0 else jnp.int64(0))
        for i, c in enumerate(canon)
    ]
    send_re = scatter_rows(right_ext.astype(jnp.int32), jnp.int32(_NO_EXT))
    send_le = scatter_rows(left_ext.astype(jnp.int32), jnp.int32(_NO_EXT))
    send_bd = scatter_rows(boundary.astype(jnp.int32), jnp.int32(0))
    send_gp = scatter_rows(global_pos.astype(jnp.int64), jnp.int64(-1))

    a2a = functools.partial(
        jax.lax.all_to_all, axis_name=_AXIS, split_axis=0, concat_axis=0, tiled=True
    )
    rc_canon = [a2a(c).reshape(-1) for c in send_canon]
    rc_re = a2a(send_re).reshape(-1)
    rc_le = a2a(send_le).reshape(-1)
    rc_bd = a2a(send_bd).reshape(-1)
    rc_gp = a2a(send_gp).reshape(-1)

    n = rc_canon[0].shape[0]  # n_dev * cap
    if len(rc_canon) == 1:
        perm = jnp.argsort(rc_canon[0], stable=True)
        canon_s = rc_canon[0][perm]
        seg_start = jnp.concatenate(
            [jnp.ones(1, dtype=bool), canon_s[1:] != canon_s[:-1]]
        )
    else:
        ch_s, cl_s, perm = jax.lax.sort(
            (rc_canon[0], rc_canon[1], jnp.arange(n, dtype=jnp.int64)),
            num_keys=2,
        )
        seg_start = jnp.concatenate(
            [
                jnp.ones(1, dtype=bool),
                (ch_s[1:] != ch_s[:-1]) | (cl_s[1:] != cl_s[:-1]),
            ]
        )
    seg_id = jnp.cumsum(seg_start.astype(jnp.int64)) - 1

    def seg_max(x_sorted):
        return jax.ops.segment_max(
            x_sorted, seg_id, num_segments=n, indices_are_sorted=True
        )

    def seg_min(x_sorted):
        return jax.ops.segment_min(
            x_sorted, seg_id, num_segments=n, indices_are_sorted=True
        )

    re_s = rc_re[perm]
    le_s = rc_le[perm]
    distinct_r = jnp.zeros(n, jnp.int32)
    distinct_l = jnp.zeros(n, jnp.int32)
    for c in range(4):
        distinct_r += seg_max((re_s == c).astype(jnp.int32))
        distinct_l += seg_max((le_s == c).astype(jnp.int32))
    boundary_any = seg_max(rc_bd[perm]) > 0
    gp_s = jnp.where(rc_gp[perm] < 0, jnp.int64(2**62), rc_gp[perm])
    first_of_class = seg_min(gp_s)
    junction_class = (distinct_r > 1) | (distinct_l > 1) | boundary_any

    class_of = jnp.zeros(n, jnp.int64).at[perm].set(seg_id)
    occ_junction = junction_class[class_of] & (rc_canon[0] != _INVALID_CANON)
    occ_first = first_of_class[class_of]

    # route verdicts back (inverse all_to_all restores [n_dev, cap] layout)
    back_j = a2a(occ_junction.reshape(n_dev, cap).astype(jnp.int32)).reshape(
        n_dev, cap
    )
    back_f = a2a(occ_first.reshape(n_dev, cap)).reshape(n_dev, cap)
    # un-scatter: element at (owner_s[t], run_idx[t]) came from order[t];
    # dropped rows (invalid or overflowed) read nothing
    ok = sendable & (run_idx < cap)
    so = jnp.clip(owner_s, 0, n_dev - 1)
    sr = jnp.clip(run_idx, 0, cap - 1)
    got_j = jnp.where(ok, back_j[so, sr], 0)
    got_f = jnp.where(ok, back_f[so, sr], 0)
    res_j = jnp.zeros(L, jnp.int32).at[order].set(got_j)
    res_f = jnp.zeros(L, jnp.int64).at[order].set(got_f)
    return res_j > 0, res_f, overflow


def _make_step(k: int, n_dev: int, cap: int):
    def step(codes_local):
        canon, positive, re_, le_, bd, gp = _local_analysis(
            codes_local, k, n_dev
        )
        isj, first, ovf = _bucket_exchange(
            canon, re_, le_, bd, gp, n_dev, cap
        )
        return isj, positive, first, ovf.reshape(1)

    return step


@functools.lru_cache(maxsize=8)
def _compiled(k: int, n_dev: int, length: int, mesh_devices: tuple,
              cap: int):
    mesh = Mesh(np.array(mesh_devices), (_AXIS,))
    step = jax.jit(
        jax.shard_map(
            _make_step(k, n_dev, cap),
            mesh=mesh,
            in_specs=P(_AXIS),
            out_specs=(P(_AXIS), P(_AXIS), P(_AXIS), P(_AXIS)),
        )
    )
    return mesh, step


def build_junctions_sharded(
    seqs: Sequence[np.ndarray], k: int, devices=None
) -> List[JunctionChr]:
    """Multi-device equivalent of graph.construct.build_junctions.
    31 < k <= 61 routes two-limb canonical codes through the exchange."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if not seqs:
        return []
    empty = [
        JunctionChr(pos=np.zeros(0, np.uint32), ids=np.zeros(0, np.int64))
        for _ in seqs
    ]
    lengths = [len(s) for s in seqs]
    sep = np.array([ord("N")], dtype=np.uint8)
    pieces = [sep]  # leading N so device 0 needs no special casing
    for i, s in enumerate(seqs):
        pieces.append(s)
        pieces.append(sep)
    joined = np.concatenate(pieces)
    if len(joined) < k + 2:
        return empty
    # pad so length is a multiple of n_dev (trailing N's are inert); bucket
    # to a power-of-two-ish size so jit caches compilations across inputs
    total = -(-len(joined) // n_dev) * n_dev
    pow2 = 1 << (total - 1).bit_length()
    bucket = -(-pow2 // n_dev) * n_dev
    joined = np.concatenate(
        [joined, np.full(bucket - len(joined), ord("N"), dtype=np.uint8)]
    )
    codes = alphabet.encode(joined)

    # capacity-factor exchange: start at ~1.3x the balanced share and retry
    # with a doubled factor on the (hash-unlikely) overflow, up to the
    # skew-proof full-length layout
    L_local = len(joined) // n_dev
    cap = min(L_local, -(-int(L_local / n_dev * 1.3) // 8) * 8 + 8)
    while True:
        mesh, step = _compiled(k, n_dev, len(joined), tuple(devices), cap)
        # straight from the host to each device's slice (no staging copy
        # of the whole stream on one device)
        arr = jax.device_put(codes, NamedSharding(mesh, P(_AXIS)))
        isj, positive, first, ovf = step(arr)
        if not np.asarray(ovf).any():
            break
        if cap >= L_local:
            raise AssertionError("full-length exchange cannot overflow")
        cap = min(L_local, cap * 2)
    mask = np.asarray(isj)
    positive = np.asarray(positive)
    first_idx = np.asarray(first)

    jpos = np.flatnonzero(mask)
    signed = assign_ids(first_idx[jpos], positive[jpos])
    return split_chromosomes(jpos, signed, lengths)
