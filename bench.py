"""End-to-end benchmark: FASTA -> LCB GFF throughput in input-Mbp/s.

Workload: 16 simulated bacterial-like strains (1 Mbp each, ~1% divergence,
occasional inversions), k=15, no alignment stage — the BASELINE.md
"16 bacterial strains at one host" configuration.

Baseline anchor: the reference documents its 2-genome, ~12 Mbp example at
"< 5 minutes on a typical machine" (SibeliaZ README), i.e. 0.04 Mbp/s
end-to-end for twopaco + sibeliaz-lcb.  vs_baseline is measured
throughput divided by that anchor.

Runs one cold pass (compile included) and three warm passes on a GPU and
prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"cold_s", "warm_s"}, value from the best warm pass.  Exits non-zero when
JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_MBPS = 12.0 / 300.0  # reference example anchor

N_STRAINS = 16
STRAIN_LEN = 1_000_000
K = 15
WARM_PASSES = 3


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def make_input():
    from sibeliaz_tpu.core import alphabet

    rng = np.random.default_rng(2024)
    base = alphabet.decode(rng.integers(0, 4, size=STRAIN_LEN).astype(np.uint8))
    seqs, names = [], []
    for g in range(N_STRAINS):
        s = base.copy()
        for p in np.flatnonzero(rng.random(STRAIN_LEN) < 0.01):
            s[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
        if g % 3 == 1:
            lo = int(rng.integers(0, STRAIN_LEN // 2))
            hi = lo + int(rng.integers(STRAIN_LEN // 8, STRAIN_LEN // 4))
            s[lo:hi] = alphabet.reverse_complement(s[lo:hi])
        seqs.append(s)
        names.append(f"Strain{g + 1}.Chr1")
    return seqs, names


def run_pass(seqs, names, cfg):
    from sibeliaz_tpu import pipeline
    from sibeliaz_tpu.graph import construct

    t0 = time.time()
    records = construct.build_junctions(seqs, K)
    t_graph = time.time()
    res = pipeline.find_blocks(seqs, names, cfg, records=records)
    t_end = time.time()
    log(f"pass: graph {t_graph - t0:.2f}s | lcb+out {t_end - t_graph:.2f}s | "
        f"total {t_end - t0:.2f}s | blocks {res.blocks_found} | "
        f"coverage {res.coverage:.3f}")
    return t_end - t0


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"needs a GPU, JAX found {dev.platform}")
        return 2
    import sibeliaz_tpu  # noqa: F401  (x64 and the compile cache)
    from sibeliaz_tpu.config import Config
    from sibeliaz_tpu.lcb.engine import ensure_built

    seqs, names = make_input()
    total_mbp = sum(len(s) for s in seqs) / 1e6
    cfg = Config(k=K, threads=min(os.cpu_count() or 1, 32))
    ensure_built()  # the native engine's one-time g++ build is set-up
    cold = run_pass(seqs, names, cfg)
    warm = [run_pass(seqs, names, cfg) for _ in range(WARM_PASSES)]
    mbps = total_mbp / min(warm)
    print(json.dumps({
        "metric": "lcb_end_to_end_throughput",
        "value": mbps,
        "unit": "input_mbp_per_s",
        "vs_baseline": mbps / BASELINE_MBPS,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "cold_s": cold,
        "warm_s": warm,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
