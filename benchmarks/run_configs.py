"""Benchmark harness for the BASELINE.md target configurations.

Runs each configuration end-to-end on synthetic inputs shaped like the
targets and prints a JSON line per config.  `bench.py` at the repo root
remains the driver's single-metric benchmark; this harness is for broader
tracking across rounds.

  examples-pair-k15-noalign : 2 genomes x 4 chrs x 1.5 Mbp, k=15, -n
  examples-full-maf         : same but with the POA/MAF stage
  ecoli16-k15               : 16 strains x 1 Mbp, k=15 (with -a exercised)
  yeast-k21-synteny         : 8 genomes x 1.5 Mbp, k=21 + synteny merge
  chromosome-k25-streamed   : 2 x 64 Mbp, k=25 through the memory-bounded
                              streamed graph mode (auto-routed)
  chromosome-k25-256m       : 2 x 128 Mbp, k=25 (>=256 Mbp total)
  chromosome-k33-crosscheck : 2 x 64 Mbp, k=33 two-limb; resident rounds
                              vs host-bucketed bit-equality at scale

Usage: python benchmarks/run_configs.py [config ...]   (default: fast set)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth(seed, n_genomes, n_chr, length, mut=0.01, invert=True):
    from sibeliaz_tpu.core import alphabet

    rng = np.random.default_rng(seed)
    ancestors = [
        alphabet.decode(rng.integers(0, 4, size=length).astype(np.uint8))
        for _ in range(n_chr)
    ]
    seqs, names = [], []
    for g in range(n_genomes):
        for c, anc in enumerate(ancestors):
            s = anc.copy()
            pos = np.flatnonzero(rng.random(length) < mut)
            s[pos] = alphabet.decode(
                rng.integers(0, 4, size=len(pos)).astype(np.uint8)
            )
            if invert and g % 3 == 1:
                lo = int(rng.integers(0, length // 2))
                hi = lo + int(rng.integers(length // 8, length // 4))
                s[lo:hi] = alphabet.reverse_complement(s[lo:hi])
            seqs.append(s)
            names.append(f"G{g + 1}.C{c + 1}")
    return seqs, names


def run_config(name):
    from sibeliaz_tpu.config import Config
    from sibeliaz_tpu.graph import construct, streamed
    from sibeliaz_tpu import pipeline

    threads = min(os.cpu_count() or 1, 32)
    t0 = time.time()
    extra = {}
    if name == "examples-pair-k15-noalign":
        seqs, names = synth(1, 2, 4, 1_500_000, mut=0.02)
        cfg = Config(k=15, threads=threads)
        records = construct.build_junctions(seqs, cfg.k)
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
    elif name == "examples-full-maf":
        from sibeliaz_tpu.align import msa as msa_mod

        seqs, names = synth(1, 2, 2, 400_000, mut=0.03)
        cfg = Config(k=15, threads=threads)
        records = construct.build_junctions(seqs, cfg.k)
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
        msa_mod.align_blocks_to_maf(
            res.blocks, seqs, names, "/tmp/bench_cfg.maf",
            cmd=name, threads=threads,
        )
        extra["maf_bytes"] = os.path.getsize("/tmp/bench_cfg.maf")
    elif name in ("ecoli16-k15", "ecoli16-full-maf"):
        seqs, names = synth(2, 16, 1, 1_000_000, mut=0.01)
        cfg = Config(k=15, threads=threads, abundance_threshold=64)
        records = construct.build_junctions(seqs, cfg.k)
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
        if name == "ecoli16-full-maf":
            from sibeliaz_tpu.align import msa as msa_mod

            t_aln = time.time()
            msa_mod.align_blocks_to_maf(
                res.blocks, seqs, names, "/tmp/bench_cfg16.maf",
                cmd=name, threads=threads,
            )
            extra["align_seconds"] = round(time.time() - t_aln, 2)
            extra["maf_bytes"] = os.path.getsize("/tmp/bench_cfg16.maf")
    elif name == "yeast-k21-synteny":
        from sibeliaz_tpu.postprocess import synteny

        seqs, names = synth(3, 8, 1, 1_500_000, mut=0.015)
        cfg = Config(k=21, threads=threads)
        records = construct.build_junctions(seqs, cfg.k)
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
        with open("/tmp/bench_cfg.gff", "w") as f:
            f.write(res.gff)
        synteny.run("/tmp/bench_cfg.gff", "/tmp/bench_cfg_syn", [5000])
        extra["synteny"] = True
    elif name == "chromosome-k25-streamed":
        # 128 Mbp pair; build_junctions auto-routes to the device-resident
        # streamed rounds when the 2^27 bucket's monolithic plan exceeds
        # the device budget.  Pass 1 absorbs the per-process compile;
        # pass 2 is the steady-state graph number.
        seqs, names = synth(4, 2, 1, 64_000_000, mut=0.01, invert=False)
        cfg = Config(k=25, threads=threads)
        t_g = time.time()
        records = construct.build_junctions(seqs, cfg.k)
        extra["graph_seconds"] = round(time.time() - t_g, 2)
        t_g = time.time()
        records = construct.build_junctions(seqs, cfg.k)
        extra["graph_warm_seconds"] = round(time.time() - t_g, 2)
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
    elif name == "chromosome-k25-256m":
        # >=256 Mbp total (VERDICT round-2 item 6)
        seqs, names = synth(5, 2, 1, 128_000_000, mut=0.01, invert=False)
        cfg = Config(k=25, threads=threads)
        t_g = time.time()
        records = construct.build_junctions(seqs, cfg.k)
        extra["graph_seconds"] = round(time.time() - t_g, 2)
        t_g = time.time()
        records = construct.build_junctions(seqs, cfg.k)
        extra["graph_warm_seconds"] = round(time.time() - t_g, 2)
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
    elif name == "chromosome-k25-512m":
        # >=512 Mbp total (round-3 verdict item 5: demonstrate the path
        # toward the reference's 2^32-bp contract)
        seqs, names = synth(6, 2, 1, 256_000_000, mut=0.01, invert=False)
        cfg = Config(k=25, threads=threads)
        t_g = time.time()
        records = construct.build_junctions(seqs, cfg.k)
        extra["graph_seconds"] = round(time.time() - t_g, 2)
        t_g = time.time()
        records = construct.build_junctions(seqs, cfg.k)
        extra["graph_warm_seconds"] = round(time.time() - t_g, 2)
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
    elif name == "chromosome-k25-1g":
        # >=1 Gbp total: two ~0.5 Gbp chromosomes — the scaling waypoint
        # toward the reference's 2^32-bp chromosome contract
        # (junctionapi.h:32-33, README.md:25-26)
        seqs, names = synth(8, 2, 1, 512_000_000, mut=0.01, invert=False)
        cfg = Config(k=25, threads=threads)
        t_g = time.time()
        records = construct.build_junctions(seqs, cfg.k)
        extra["graph_seconds"] = round(time.time() - t_g, 2)
        t_g = time.time()
        records = construct.build_junctions(seqs, cfg.k)
        extra["graph_warm_seconds"] = round(time.time() - t_g, 2)
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
    elif name == "chromosome-k25-2g-contract":
        # The reference's per-chromosome contract is 2^32 bp (uint32 pos,
        # junctionapi.h:32-33, README.md:25-26).  This config streams TWO
        # 2,145,000,000 bp chromosomes (each just under 2^31; total 4.29
        # Gbp ~ the reference's whole uint32 position space) end-to-end:
        # the largest prior record was 2 x 512 Mbp.  L is chosen so the
        # joined stream (2L + 3 separators) stays under the resident
        # builder's 2^32 - chunk cutoff — above it the build silently
        # routes to the host-bucketed fallback, which round-trips
        # ~21 B/position through host RAM (84 GB of host RSS at this
        # scale).  Sequences are built
        # chunk-wise at uint8 width so host RAM stays ~3x sequence bytes.
        L = 2_145_000_000
        rng = np.random.default_rng(11)
        from sibeliaz_tpu.core import alphabet

        cache = os.environ.get("SZ_CONTRACT_CACHE")
        seqs, names = [], [f"G{g + 1}.C1" for g in range(2)]
        if cache and os.path.exists(cache + ".0.npy"):
            seqs = [np.load(f"{cache}.{g}.npy", mmap_mode=None)
                    for g in range(2)]
        else:
            CH = 1 << 26
            anc = np.empty(L, np.uint8)
            for lo in range(0, L, CH):
                hi = min(lo + CH, L)
                anc[lo:hi] = alphabet.decode(
                    rng.integers(0, 4, size=hi - lo, dtype=np.int64).astype(
                        np.uint8
                    )
                )
            for g in range(2):
                s = anc.copy()
                for lo in range(0, L, CH):
                    hi = min(lo + CH, L)
                    pos = lo + np.flatnonzero(
                        rng.random(hi - lo) < 0.01
                    ).astype(np.int64)
                    s[pos] = alphabet.decode(
                        rng.integers(
                            0, 4, size=len(pos), dtype=np.int64
                        ).astype(np.uint8)
                    )
                seqs.append(s)
            del anc
            if cache:
                for g in range(2):
                    np.save(f"{cache}.{g}.npy", seqs[g])
        cfg = Config(k=25, threads=threads)
        t_g = time.time()
        records = construct.build_junctions(seqs, cfg.k)
        extra["graph_seconds"] = round(time.time() - t_g, 2)
        extra["junctions"] = int(sum(len(r.pos) for r in records))
        extra["max_chromosome_bp"] = L
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
    elif name == "chromosome-k33-crosscheck":
        # two-limb k at chromosome scale: the device-resident rounds and the
        # host-bucketed streamed path are independent implementations; their
        # bit-equality at 128 Mbp is the at-scale evidence for k>31 (the
        # monolithic kernel cannot run at this bucket to serve as oracle)
        seqs, names = synth(4, 2, 1, 64_000_000, mut=0.01, invert=False)
        cfg = Config(k=33, threads=threads)
        t_g = time.time()
        records = streamed.build_junctions_streamed_resident(
            seqs, cfg.k, n_rounds=8
        )
        extra["graph_seconds"] = round(time.time() - t_g, 2)
        t_g = time.time()
        records_host = streamed.build_junctions_streamed(
            seqs, cfg.k, n_rounds=8
        )
        extra["hostpath_graph_seconds"] = round(time.time() - t_g, 2)
        same = len(records) == len(records_host) and all(
            np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)
            for a, b in zip(records, records_host)
        )
        extra["resident_eq_hostbucketed"] = bool(same)
        assert same, "k=33 streamed paths disagree at chromosome scale"
        res = pipeline.find_blocks(seqs, names, cfg, records=records)
    else:
        raise SystemExit(f"unknown config {name}")
    elapsed = time.time() - t0
    total_mbp = sum(len(s) for s in seqs) / 1e6
    print(
        json.dumps(
            {
                "config": name,
                "input_mbp": round(total_mbp, 1),
                "seconds": round(elapsed, 2),
                "mbp_per_s": round(total_mbp / elapsed, 3),
                "blocks": res.blocks_found,
                "coverage": round(res.coverage, 4),
                **extra,
            }
        ),
        flush=True,
    )


FAST = ["examples-pair-k15-noalign", "ecoli16-k15", "yeast-k21-synteny"]

if __name__ == "__main__":
    configs = sys.argv[1:] or FAST
    for c in configs:
        run_config(c)
