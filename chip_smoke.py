"""Smoke run of the FASTA -> GFF/MAF path on one NVIDIA GPU.

Drives the CLI and library entry points at reference-example scale and
checks every output byte- or bit-exactly against the committed goldens and
the in-repo oracles:

  phase 0  device, card name and power limit, device memory, native builds
  phase 1  committed small example, full pipeline under every engine
           (GFF and MAF byte-equal to examples/sibeliaz_out)
  phase 2  12 Mbp reference-scale example (examples/large), run twice
  phase 3  16 x 1 Mbp bacterial collection: monolithic vs forced-streamed
           graph construction, bit-equal records and equal GFF
  phase 4  small oracle checks: junction kernel vs brute force at k=15 and
           k=33, fused LCB phase vs the oracle, device POA vs poa_ref

Each phase prints its result with cold (first call, compile included) and
warm (second call) seconds.  Any failure raises: the script exits non-zero
and prints no result line.  On success the last line of stdout is

  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Usage:
  python chip_smoke.py          # one GPU, phases 0-4
  python chip_smoke.py --four   # only: sharded graph construction over 4
                                # GPUs vs single-card, bit-equal
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "examples")


def log(msg: str) -> None:
    print(msg, flush=True)


def strip_maf_cmd(maf: bytes) -> bytes:
    """The MAF without its `# cmd=` header line (the invocation differs by
    construction); every other byte is kept for the comparison."""
    return b"".join(
        line for line in maf.splitlines(keepends=True)
        if not line.startswith(b"# cmd=")
    )


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _same_records(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x.pos, y.pos) and np.array_equal(x.ids, y.ids)
        for x, y in zip(a, b)
    )


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def twice(fn, same=lambda a, b: a == b):
    """Run fn twice; return (first result, cold seconds, warm seconds).
    Both calls must agree — a warm result that differs is a failure."""
    t0 = time.time()
    first = fn()
    cold = time.time() - t0
    t0 = time.time()
    second = fn()
    warm = time.time() - t0
    _check(same(first, second), "cold and warm calls disagree")
    return first, cold, warm


def report(name: str, result, cold: float, warm: float) -> None:
    log(f"[{name}] ok {result} cold_s={cold} warm_s={warm}")


def run_cli(argv):
    """cli.run with its stdout captured; fails unless it returns 0.
    Returns the graph, LCB and total seconds the CLI reports."""
    from sibeliaz_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.run(argv)
    m = re.search(
        r"Timings: graph ([0-9.]+)s, lcb ([0-9.]+)s, total ([0-9.]+)s",
        buf.getvalue(),
    )
    _check(rc == 0 and m is not None, f"cli.run({argv}) failed: rc={rc}")
    return {"graph_s": float(m[1]), "lcb_s": float(m[2]),
            "total_s": float(m[3])}


def memory_plan(jitted, *args) -> dict:
    """Compiled allocation plan of one jitted call (bytes)."""
    return plan_of(jitted.lower(*args).compile())


def plan_of(compiled) -> dict:
    ma = compiled.memory_analysis()
    plan = {
        "argument": int(ma.argument_size_in_bytes),
        "output": int(ma.output_size_in_bytes),
        "temp": int(ma.temp_size_in_bytes),
        "alias": int(ma.alias_size_in_bytes),
    }
    plan["peak"] = (
        plan["argument"] + plan["output"] + plan["temp"] - plan["alias"]
    )
    return plan


class PlanRecorder:
    """Wraps a module-level jitted function: the first call with each
    argument signature is compiled ahead of time, its memory plan recorded,
    and that executable serves every call with the signature.  Results are
    untouched."""

    def __init__(self, module, name: str, static=()):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.static = set(static)
        self.plans = {}  # signature -> (static args, arg-0 shape, plan)
        self._exe = {}

    def __call__(self, *args):
        import jax

        key = tuple(
            a if i in self.static else tuple(
                (x.shape, str(x.dtype)) for x in jax.tree_util.tree_leaves(a)
            )
            for i, a in enumerate(args)
        )
        if key not in self._exe:
            exe = self.fn.lower(*args).compile()
            self._exe[key] = exe
            self.plans[key] = (
                {i: args[i] for i in self.static},
                jax.tree_util.tree_leaves(args[0])[0].shape,
                plan_of(exe),
            )
        return self._exe[key](
            *(a for i, a in enumerate(args) if i not in self.static)
        )

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


# --------------------------------------------------------------------- 0 --
def phase0_device():
    import jax

    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in smi.splitlines():
        log(line)
    from sibeliaz_tpu.utils.device import device_memory_bytes

    log(f"[phase0] device: {dev.platform} {dev.device_kind} "
        f"count={len(jax.devices())} bytes_limit="
        f"{dev.memory_stats()['bytes_limit']} "
        f"device_memory_bytes={device_memory_bytes()}")


def phase0_builds():
    t0 = time.time()
    from sibeliaz_tpu.align import msa
    from sibeliaz_tpu.lcb.engine import ensure_built

    ensure_built()
    msa._load()
    log(f"[phase0] native LCB and POA libraries built in "
        f"{time.time() - t0} s")


# --------------------------------------------------------------------- 1 --
ENGINES = {
    "native": [],
    "align-device": ["--align-engine", "tpu"],
    "lcb-resident": ["--lcb-engine", "tpu"],
    "lcb-fused": ["--lcb-engine", "tpu-fused"],
}


def small_example_fastas():
    return [os.path.join(EXAMPLES, f"genome{g}.fa") for g in (1, 2)]


def phase1_engine(tmp: str, name: str):
    """The committed small example through the CLI under one engine
    choice: GFF and MAF byte-equal to examples/sibeliaz_out."""
    from sibeliaz_tpu.align import tpu_poa

    gold = os.path.join(EXAMPLES, "sibeliaz_out")
    want_gff = _read(os.path.join(gold, "blocks_coords.gff"))
    want_maf = strip_maf_cmd(_read(os.path.join(gold, "alignment.maf")))
    out = os.path.join(tmp, f"small_{name}")
    before = tpu_poa._STATS["blocks_dispatched"]

    def one():
        run_cli(["-k", "15", "-o", out, *ENGINES[name],
                 *small_example_fastas()])
        gff = _read(os.path.join(out, "blocks_coords.gff"))
        maf = strip_maf_cmd(_read(os.path.join(out, "alignment.maf")))
        _check(gff == want_gff, f"{name}: GFF differs from the golden")
        _check(maf == want_maf, f"{name}: MAF differs from the golden")
        return len(gff), len(maf)

    res, cold, warm = twice(one)
    routed = tpu_poa._STATS["blocks_dispatched"] - before
    report(f"phase1 {name}", f"gff+maf byte-equal sizes={res} "
           f"device_poa_blocks_over_both_runs={routed}", cold, warm)


def phase1_device_poa():
    from sibeliaz_tpu import pipeline
    from sibeliaz_tpu.align import msa, tpu_poa
    from sibeliaz_tpu.config import Config
    from sibeliaz_tpu.io import fasta

    # Device POA on EVERY block of the example (routing bypassed): MSAs
    # equal to the native engine's, the per-scan-step cost, and the
    # compiled plan of each dispatch shape against the scratch model.
    recs = fasta.read_many(small_example_fastas())
    seqs = [r.seq for r in recs]
    res = pipeline.find_blocks(seqs, [r.name for r in recs], Config(k=15))
    blocks_seqs = [[msa.copy_sequence(b, seqs) for b in grp]
                   for _, grp in msa.block_copies(res.blocks)]
    want = msa.poa_msa_batch(blocks_seqs, threads=os.cpu_count() or 1)
    starts = []
    with PlanRecorder(tpu_poa, "_dp_tb_batch", static=(6, 7, 8)) as rec:
        def dev_all():
            starts.append(dict(tpu_poa._STATS))
            got = tpu_poa.poa_msa_batch_tpu(blocks_seqs)
            _check(all(g is not None for g in got),
                   "device POA fell back on an example block")
            _check(got == want, "device POA MSAs differ from native")
            return len(got)

        _, cold, warm = twice(dev_all)
    s0, s1 = starts[-1], tpu_poa._STATS
    steps = s1["scan_steps"] - s0["scan_steps"]
    dev_s = s1["device_s"] - s0["device_s"]
    step_ms = 1e3 * dev_s / max(steps, 1)
    factors = []
    for statics, shape0, plan in rec.plans.values():
        B, n_max, W = shape0[0], statics[6], statics[7]
        model = B * tpu_poa._per_block_bytes(W, n_max)
        factors.append(plan["peak"] / model)
        log(f"[phase1] poa plan B={B} n_max={n_max} W={W} model={model} "
            f"plan={plan} plan/model={plan['peak'] / model}")
    report("phase1 device-poa-all-blocks",
           f"{len(blocks_seqs)} blocks equal native; warm scan_steps={steps} "
           f"device_s={dev_s} step_ms={step_ms} "
           f"max_plan_over_model={max(factors)}", cold, warm)


# --------------------------------------------------------------------- 2 --
def phase2_large_example(tmp: str):
    import jax

    sys.path.insert(0, os.path.join(EXAMPLES, "large"))
    import make_large_example

    from sibeliaz_tpu.io import fasta

    fas = []
    for g, recs in enumerate(make_large_example.build(), start=1):
        fas.append(os.path.join(tmp, f"large_genome{g}.fa"))
        fasta.write_fasta(fas[-1], recs)
    want = _read(os.path.join(EXAMPLES, "large", "sibeliaz_out",
                              "blocks_coords.gff"))
    runs = []
    for i in range(2):
        out = os.path.join(tmp, f"large_out{i}")
        t0 = time.time()
        times = run_cli(["-k", "25", "-n", "-o", out, *fas])
        wall = time.time() - t0
        _check(_read(os.path.join(out, "blocks_coords.gff")) == want,
               f"large example run {i}: GFF differs from the golden")
        runs.append(wall)
        log(f"[phase2] run {i}: {times} wall_s={wall}")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    report("phase2 large-example",
           f"GFF byte-equal twice peak_bytes_in_use={peak}",
           runs[0], runs[1])


# --------------------------------------------------------------------- 3 --
def bacterial_input():
    sys.path.insert(0, HERE)
    import bench

    return bench.make_input()


def phase3_monolithic_vs_streamed():
    import jax
    import jax.numpy as jnp

    from sibeliaz_tpu import pipeline
    from sibeliaz_tpu.config import Config
    from sibeliaz_tpu.graph import construct, streamed

    seqs, names = bacterial_input()
    k = 15
    n_joined = sum(len(s) for s in seqs) + len(seqs) - 1
    bucket = 1 << (n_joined - 1).bit_length()
    log(f"[phase3] {len(seqs)} x {len(seqs[0])} bp, bucket={bucket}")
    _check(bucket * construct.MONOLITHIC_PEAK_BYTES_PER_POS
           <= construct.graph_budget_bytes(),
           "the default budget does not route this input monolithic")
    plan = memory_plan(
        construct._junction_kernel_compact_v9_packed,
        jax.ShapeDtypeStruct((bucket // 4,), jnp.uint8),
        jax.ShapeDtypeStruct((bucket // 8,), jnp.uint8),
        k, max(4096, bucket // 3), bucket,
    )
    log(f"[phase3] monolithic kernel memory_analysis: {plan} "
        f"peak_bytes_per_pos={plan['peak'] / bucket}")
    plan33 = memory_plan(
        construct._junction_kernel_compact_v9_packed,
        jax.ShapeDtypeStruct((bucket // 4,), jnp.uint8),
        jax.ShapeDtypeStruct((bucket // 8,), jnp.uint8),
        33, max(4096, bucket // 3), bucket,
    )
    log(f"[phase3] monolithic kernel memory_analysis at k=33: {plan33} "
        f"peak_bytes_per_pos={plan33['peak'] / bucket}")

    mono, cold, warm = twice(lambda: construct.build_junctions(seqs, k),
                             _same_records)
    n_j = sum(len(r.pos) for r in mono)
    report("phase3 monolithic", f"junctions={n_j}", cold, warm)

    # half the monolithic plan forces the streamed rounds, through the
    # same argument the CLI's -f sets
    small = bucket * construct.MONOLITHIC_PEAK_BYTES_PER_POS // 2
    calls = []
    resident = streamed.build_junctions_streamed_resident

    def counted(*a, **kw):
        calls.append(kw.get("n_rounds"))
        return resident(*a, **kw)

    streamed.build_junctions_streamed_resident = counted
    try:
        with PlanRecorder(streamed, "_round_scan_pass",
                          static=range(7, 13)) as scan, \
                PlanRecorder(streamed, "_round_epilogue",
                             static=(1, 2)) as epi:
            stream, cold, warm = twice(
                lambda: construct.build_junctions(
                    seqs, k, hbm_budget_bytes=small),
                _same_records,
            )
    finally:
        streamed.build_junctions_streamed_resident = resident
    _check(len(calls) == 2, "the small budget did not route to streamed")
    _check(_same_records(mono, stream),
           "streamed junction records differ from monolithic")
    n_rounds = calls[0]
    # one round's epilogue per round-buffer row, scaled as build_junctions
    # sizes rounds: rows = slack x positions, and the epilogue gets the
    # third of the budget the G round buffers leave
    per_row = max(p["peak"] / shape[0] for _, shape, p in epi.plans.values())
    log(f"[phase3] streamed n_rounds={n_rounds} scan plans="
        f"{[p for *_, p in scan.plans.values()]} epilogue plans="
        f"{[(shape, p) for _, shape, p in epi.plans.values()]} "
        f"epilogue_bytes_per_row={per_row} "
        f"derived_streamed_bytes_per_pos={3 * 1.25 * per_row}")
    report("phase3 streamed", f"bit-equal to monolithic n_rounds={n_rounds}",
           cold, warm)

    cfg = Config(k=k, threads=min(os.cpu_count() or 1, 32))
    gffs = [pipeline.find_blocks(seqs, names, cfg, records=r).gff
            for r in (mono, stream)]
    _check(gffs[0] == gffs[1], "GFF from streamed records differs")
    log(f"[phase3] find_blocks GFF equal ({gffs[0].count(chr(10))} lines)")


# --------------------------------------------------------------------- 4 --
def phase4_oracles():
    import numpy as np

    from sibeliaz_tpu.align import poa_ref, tpu_poa
    from sibeliaz_tpu.config import Config
    from sibeliaz_tpu.core import alphabet
    from sibeliaz_tpu.graph import construct
    from sibeliaz_tpu.graph.oracle import enumerate_junctions
    from sibeliaz_tpu.junctions.table import JunctionTable
    from sibeliaz_tpu.lcb.fused import process_phase_fused
    from sibeliaz_tpu.lcb.oracle import LcbEngine

    rng = np.random.default_rng(11)
    base = alphabet.decode(rng.integers(0, 4, size=6_000).astype(np.uint8))
    mut = base.copy()
    for p in np.flatnonzero(rng.random(len(mut)) < 0.01):
        mut[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    seqs = [base, mut]
    src = alphabet.decode(rng.integers(0, 4, size=400).astype(np.uint8))
    rows = []
    for _ in range(4):
        r = src.copy()
        for p in np.flatnonzero(rng.random(len(r)) < 0.03):
            r[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
        rows.append(r)

    def junctions(k, length):
        ss = [s[:length] for s in seqs]
        _check(_same_records(construct.build_junctions(ss, k),
                             enumerate_junctions(ss, k)),
               f"junction kernel differs from brute force at k={k}")
        return True

    def fused_lcb():
        k = 15
        cfg = Config(k=k)
        recs = construct.build_junctions(seqs, k)
        table = JunctionTable.build(recs, seqs, ["g0", "g1"], k,
                                    cfg.abundance_threshold)
        eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size,
                        cfg.flanking)
        bundles = eng.make_bundles()[:24]
        got = process_phase_fused(eng, bundles)
        for i, bundle in enumerate(bundles):
            want = [(x.c, x.s, x.fi, x.bi) for x in eng.process(bundle)]
            _check([(x.c, x.s, x.fi, x.bi) for x in got[i]] == want,
                   f"fused LCB phase differs from the oracle on bundle {i}")
        return len(bundles)

    def device_poa():
        got = tpu_poa.poa_msa_batch_tpu([rows])[0]
        _check(got is not None and got == poa_ref.poa_msa(rows),
               "device POA differs from poa_ref")
        return True

    checks = {
        "junction_kernel_k15_vs_bruteforce": lambda: junctions(15, 6_000),
        "junction_kernel_k33_two_limb": lambda: junctions(33, 3_000),
        "fused_lcb_phase_vs_oracle": fused_lcb,
        "device_poa_vs_poa_ref": device_poa,
    }
    for name, fn in checks.items():
        res, cold, warm = twice(fn)
        report(f"phase4 {name}", res, cold, warm)


# ------------------------------------------------------------------ four --
def four_cards():
    import jax

    from sibeliaz_tpu.graph import construct
    from sibeliaz_tpu.parallel import sharded

    devs = jax.devices()
    _check(len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}")
    seqs, _ = bacterial_input()
    single = construct.build_junctions(seqs, 15)
    multi, cold, warm = twice(
        lambda: sharded.build_junctions_sharded(seqs, 15, devices=devs[:4]),
        _same_records,
    )
    _check(_same_records(single, multi),
           "4-card sharded junction records differ from single-card")
    report("four sharded-vs-single",
           f"bit-equal junctions={sum(len(r.pos) for r in single)} "
           f"devices={[d.device_kind for d in devs[:4]]}", cold, warm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only sharded graph construction on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import sibeliaz_tpu  # noqa: F401  (x64 and the compile cache)

    t_start = time.time()
    phase0_device()
    if args.four:
        four_cards()
    else:
        phase0_builds()
        with tempfile.TemporaryDirectory() as tmp:
            # phase 2 first, so its peak memory is the graph stage's own
            phase2_large_example(tmp)
            phase1_engine(tmp, "native")
            phase1_engine(tmp, "align-device")
            phase1_device_poa()
            phase3_monolithic_vs_streamed()
            phase4_oracles()
            # the serial-loop device LCB engines last: the slowest checks
            phase1_engine(tmp, "lcb-resident")
            phase1_engine(tmp, "lcb-fused")
    log(f"[done] all phases passed in {time.time() - t_start} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
