"""Timing comparison of the LCB engines on one input.

Usage: python benchmarks/lcb_engines.py [length] [n_genomes] [engines]
  engines: comma-separated subset of native,oracle,tpu,tpu-fused
           (default: all four)
Prints a JSON line per engine: wall seconds for the LCB stage alone
(junction table construction excluded), plus block count as a cross-check.
The resident/tpu engine additionally reports its device-call count.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth(seed, n_genomes, length):
    from sibeliaz_tpu.core import alphabet

    rng = np.random.default_rng(seed)
    base = alphabet.decode(rng.integers(0, 4, size=length).astype(np.uint8))
    seqs, names = [], []
    for g in range(n_genomes):
        s = base.copy()
        for p in np.flatnonzero(rng.random(length) < 0.01):
            s[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
        if g % 3 == 1:
            lo = int(rng.integers(0, length // 2))
            hi = lo + int(rng.integers(length // 8, length // 4))
            s[lo:hi] = alphabet.reverse_complement(s[lo:hi])
        seqs.append(s)
        names.append(f"G{g}.chr1")
    return seqs, names


def main():
    length = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    n_genomes = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    from sibeliaz_tpu import pipeline
    from sibeliaz_tpu.config import Config

    seqs, names = synth(7, n_genomes, length)
    cfg = Config(k=15, threads=min(os.cpu_count() or 1, 8))

    # The engines are the thing under measurement; the junction records are
    # setup.  SZ_LCB_BENCH_DBG caches them as a .dbg artifact so repeated
    # engine runs skip the graph stage.
    records = None
    dbg_path = os.environ.get("SZ_LCB_BENCH_DBG")
    if dbg_path and os.path.exists(dbg_path):
        from sibeliaz_tpu.io import dbg as dbg_io

        records = dbg_io.read_dbg(dbg_path)
        print(f"records loaded from {dbg_path}", file=sys.stderr, flush=True)
    if records is None:
        from sibeliaz_tpu.graph import construct

        records = construct.build_junctions(seqs, cfg.k)
        if dbg_path:
            from sibeliaz_tpu.io import dbg as dbg_io

            dbg_io.write_dbg(dbg_path, records)

    engines = (
        sys.argv[3].split(",")
        if len(sys.argv) > 3
        else ["native", "oracle", "tpu", "tpu-fused"]
    )
    results = {}
    for engine in engines:
        t0 = time.time()
        res = pipeline.find_blocks(
            seqs, names, cfg, records=records, engine=engine
        )
        dt = time.time() - t0
        results[engine] = res.gff
        print(json.dumps({
            "engine": engine,
            "lcb_seconds": round(dt, 3),
            "blocks": res.blocks_found,
        }), flush=True)
    gffs = set(results.values())
    assert len(gffs) == 1, "engines disagree!"
    print("all engines byte-identical", file=sys.stderr)


if __name__ == "__main__":
    main()
