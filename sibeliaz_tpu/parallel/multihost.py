"""Multi-host orchestration.

The reference is strictly single-node (SURVEY.md §2.3); here genomes scale
across hosts by sharding the sequence axis globally: every process holds a
contiguous slice of the 'N'-joined code stream, `jax.make_array` assembles
the global array over an all-hosts Mesh, and the same sharded junction step
(parallel/sharded.py) runs under jit — XLA routes the halo ppermute and the
bucket all_to_all through NCCL, over NVLink within a host and the network
between hosts.

Host-side assembly (record compaction, id ranks) happens on process 0 from
the globally-gathered verdict masks; LCB analysis then proceeds on that
host's native engine.  This mirrors the reference's pipeline topology where
graph construction is the distributed stage and analysis is one process.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sibeliaz_tpu.core import alphabet
from sibeliaz_tpu.io.dbg import JunctionChr
from sibeliaz_tpu.parallel import sharded


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op when already initialized or when
    running single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def build_junctions_multihost(
    seqs: Sequence[np.ndarray], k: int
) -> List[JunctionChr]:
    """Junction enumeration over every device of every process.

    All processes must call this with the same inputs (the usual SPMD
    contract); results are replicated to every process so any of them can
    continue with the LCB stage.
    """
    devices = jax.devices()  # global device list, all processes
    n_dev = len(devices)
    if jax.process_count() == 1:
        return sharded.build_junctions_sharded(seqs, k, devices=devices)

    if not seqs:
        return []
    lengths = [len(s) for s in seqs]
    sep = np.array([ord("N")], dtype=np.uint8)
    pieces = [sep]
    for s in seqs:
        pieces.append(s)
        pieces.append(sep)
    joined = np.concatenate(pieces)
    total = -(-len(joined) // n_dev) * n_dev
    pow2 = 1 << (total - 1).bit_length()
    bucket = -(-pow2 // n_dev) * n_dev
    joined = np.concatenate(
        [joined, np.full(bucket - len(joined), ord("N"), dtype=np.uint8)]
    )
    codes = alphabet.encode(joined)

    mesh = Mesh(np.array(devices), (sharded._AXIS,))
    sharding = NamedSharding(mesh, P(sharded._AXIS))
    # every process holds the full host array (SPMD ingest); each device
    # picks out its slice
    global_arr = jax.make_array_from_callback(
        (len(codes),), sharding, lambda idx: codes[idx]
    )
    L_local = len(codes) // n_dev
    cap = min(L_local, -(-int(L_local / n_dev * 1.3) // 8) * 8 + 8)
    while True:
        step = jax.jit(
            jax.shard_map(
                sharded._make_step(k, n_dev, cap),
                mesh=mesh,
                in_specs=P(sharded._AXIS),
                out_specs=(
                    P(sharded._AXIS), P(sharded._AXIS), P(sharded._AXIS),
                    P(sharded._AXIS),
                ),
            ),
            out_shardings=NamedSharding(mesh, P()),  # replicate results
        )
        isj, positive, first, ovf = step(global_arr)
        if not np.asarray(ovf).any():
            break
        if cap >= L_local:
            raise AssertionError("full-length exchange cannot overflow")
        cap = min(L_local, cap * 2)
    mask = np.asarray(isj)
    positive = np.asarray(positive)
    first_idx = np.asarray(first)

    jpos = np.flatnonzero(mask)
    from sibeliaz_tpu.graph.assemble import assign_ids, split_chromosomes

    signed = assign_ids(first_idx[jpos], positive[jpos])
    return split_chromosomes(jpos, signed, lengths)
