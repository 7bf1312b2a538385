"""POA-kernel roofline: measured DP throughput vs an HBM-stream model.

BASELINE.md asks for speed-of-light on POA's inner loop too (the reference
farms spoa processes, sibeliaz:128; our device path is align/tpu_poa.py).
The DP kernel's per-cell traffic is dominated by the MAX_PREDS-way
predecessor row gather (read) plus the H-row write and the dirs byte:

    bytes/cell ~= 4*MAX_PREDS (predH gather, twice: diag+horiz reuse)
                + 4 (H write) + 1 (dirs write) + ~8 scan/elementwise

so speed-of-light cells/s = bandwidth / bytes_per_cell, with the device's
published bandwidth from benchmarks/peaks.py.  This harness builds
a batch of identical-shape POA graphs (C-1 copies threaded on host), times
the fused DP+traceback dispatch `_dp_tb_batch` on device, and prints one
JSON line: measured cells/s, the model bound, and the ratio.

Usage: python benchmarks/poa_roofline.py [B] [L] [copies]   (default 8 2048 6)
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
sys.path.insert(0, __file__.rsplit("/", 1)[0])

from peaks import hbm_bytes_per_s  # noqa: E402

BYTES_PER_CELL = 4 * 8 + 4 + 1 + 8  # predH gather + H write + dirs + scan


def best_time(fn, reps=5):
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        fn()
        best = min(best, time.time() - t0)
    return best


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    C = int(sys.argv[3]) if len(sys.argv) > 3 else 6

    import jax
    import jax.numpy as jnp

    import sibeliaz_tpu  # noqa: F401
    from sibeliaz_tpu.core import alphabet
    from sibeliaz_tpu.align.poa_ref import PoaGraph
    from sibeliaz_tpu.align import tpu_poa

    rng = np.random.default_rng(12)
    n_max = -(-int(L * 1.5) // tpu_poa._TILE) * tpu_poa._TILE

    exs, plans, n_nodes, last = [], [], [], []
    for b in range(B):
        src = alphabet.decode(rng.integers(0, 4, size=L).astype(np.uint8))
        copies = []
        for _ in range(C):
            r = src.copy()
            for p in np.flatnonzero(rng.random(L) < 0.03):
                r[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
            copies.append(r)
        g = PoaGraph()
        g.add_first(copies[0])
        for r in copies[1:-1]:
            g.add_sequence(r)  # thread C-2 copies: realistic graph width
        ex = tpu_poa._extract_arrays(g, n_max)
        assert ex is not None, "node budget too small for this divergence"
        n_nodes.append(len(g.topo_nodes()))
        exs.append(ex)
        last.append(copies[-1])
        # certificate band for the final copy (band_S=None -> pass-1 guess)
        plans.append(tpu_poa._plan_windows(ex, L, L, n_max, None))

    dev = jax.devices()[0]
    bound = hbm_bytes_per_s(dev) / BYTES_PER_CELL
    results = {}
    # both modes run through the same production kernel: "full" is the
    # banding-disabled case (off=0, W=L+1); "banded" uses the certificate
    # windows the production path plans (pass-1 width)
    for mode in ("full", "banded"):
        if mode == "full":
            W = L + 1
            offs = [np.zeros(n_max + 1, np.int32) for _ in range(B)]
        else:
            W = min(
                max(
                    128,
                    1 << (int(max(p[1] for p in plans)) - 1).bit_length(),
                ),
                L + 1,
            )
            offs = [p[0] for p in plans]
        seq_b = np.zeros((B, L + 1 + W), dtype=np.uint8)
        len_b = np.full(B, L, dtype=np.int32)
        char_b = np.zeros((B, n_max), dtype=np.uint8)
        pi_b = np.full((B, n_max, tpu_poa.MAX_PREDS), n_max, dtype=np.int32)
        po_b = np.zeros((B, n_max, tpu_poa.MAX_PREDS), dtype=bool)
        sink_b = np.zeros((B, n_max), dtype=bool)
        off_b = np.zeros((B, n_max + 1), dtype=np.int32)
        for b in range(B):
            _, nc, pi, po, sk = exs[b]
            seq_b[b, 1 : 1 + L] = last[b]
            char_b[b] = nc
            pi_b[b] = pi
            po_b[b] = po
            sink_b[b] = sk
            off_b[b] = offs[b]
        P = L + n_max + 2
        args = (
            jnp.asarray(seq_b), jnp.asarray(len_b), jnp.asarray(char_b),
            jnp.asarray(pi_b), jnp.asarray(po_b), jnp.asarray(sink_b),
        )
        off_d = jnp.asarray(off_b)

        def run():
            jax.block_until_ready(
                tpu_poa._dp_tb_batch(*args, n_max, W, P, off_d)
            )

        run()  # compile
        t = best_time(run)
        useful = int(sum(n_nodes)) * (L + 1 if mode == "full" else W)
        padded = B * n_max * (W if mode != "full" else L + 1)
        results[mode] = {"t": t, "W": W, "useful": useful, "padded": padded}
        print(
            f"[poa-roofline] mode={mode} B={B} L={L} C={C} n_max={n_max} "
            f"W={W} t={t * 1e3:.1f}ms useful={useful / 1e6:.1f}M "
            f"padded={padded / 1e6:.1f}M",
            file=sys.stderr,
        )
    t = results["banded"]["t"]
    cells_s = results["banded"]["useful"] / t
    print(
        json.dumps(
            {
                "metric": "poa_dp_cells_per_s",
                "device_kind": dev.device_kind,
                "value": cells_s / 1e6,
                "unit": "Mcells_per_s",
                "hbm_model_bound_Mcells_per_s": bound / 1e6,
                "fraction_of_bound": cells_s / bound,
                "dispatch_ms": t * 1e3,
                "band_W": results["banded"]["W"],
                "full_W": results["full"]["W"],
                "full_dispatch_ms": results["full"]["t"] * 1e3,
                "band_speedup_vs_full": results["full"]["t"] / t,
            }
        )
    )


if __name__ == "__main__":
    main()
